// The warp kernel's solve (ip_warp.cuh) on the rocket's projection and
// the shuffle kernel's solve (qr_shfl.cuh) at (12, 1), run on the host
// through cuda_runtime.h's warp of threads; inputs and outputs are raw
// float64 files written and read by tools/warp_emulation.py.
#include <cstdio>
#include <thread>
#include <vector>
#include "ip_warp.cuh"
#include "rocket_projection.cuh"

template <typename T>
void k1(const char* in, const char* out) {
  FILE* f = std::fopen(in, "rb");
  int B;
  std::fread(&B, 4, 1, f);
  std::vector<double> z0(B * 10), th(B * 4), ip(11);
  std::fread(z0.data(), 8, z0.size(), f);
  std::fread(th.data(), 8, th.size(), f);
  std::fread(ip.data(), 8, 11, f);
  std::fclose(f);
  const odt::IPParams<T> p = odt::make_ip_params<T>(ip.data());
  const odt::RocketProjection<T> model(nullptr);
  std::vector<double> zo(B * 10), so(B * 4);
  for (int b = 0; b < B; ++b) {
    EmuWarp w;
    std::vector<std::thread> ts;
    for (int lane = 0; lane < 32; ++lane)
      ts.emplace_back([&, lane] {
        threadIdx.x = lane;
        emu_warp = &w;
        T z[10], t[4], st[4];
        for (int i = 0; i < 10; ++i) z[i] = T(z0[b * 10 + i]);
        for (int i = 0; i < 4; ++i) t[i] = T(th[b * 4 + i]);
        odt::ip_solve_warp<T, odt::RocketProjection<T>>(z, t, model, p, st);
        if (lane == 0) {
          for (int i = 0; i < 10; ++i) zo[b * 10 + i] = z[i];
          for (int i = 0; i < 4; ++i) so[b * 4 + i] = st[i];
        }
      });
    for (auto& t : ts) t.join();
  }
  f = std::fopen(out, "wb");
  std::fwrite(zo.data(), 8, zo.size(), f);
  std::fwrite(so.data(), 8, so.size(), f);
  std::fclose(f);
}

template <typename T>
void k2(const char* in, const char* out) {
  constexpr int N = 12, W = 16;
  FILE* f = std::fopen(in, "rb");
  int B;
  std::fread(&B, 4, 1, f);
  std::vector<double> A(B * N * N), bb(B * N);
  std::fread(A.data(), 8, A.size(), f);
  std::fread(bb.data(), 8, bb.size(), f);
  std::fclose(f);
  std::vector<double> x(B * N);
  for (int s0 = 0; s0 < B; s0 += 2) {
    EmuWarp w;
    std::vector<std::thread> ts;
    for (int lane = 0; lane < 32; ++lane)
      ts.emplace_back([&, lane] {
        threadIdx.x = lane;
        emu_warp = &w;
        const int s = s0 + lane / W, c = lane % W;
        const bool live = s < B && c <= N;
        T col[N], xs[N];
        for (int r = 0; r < N; ++r)
          col[r] = !live ? T(0) : c < N ? T(A[(s * N + r) * N + c]) : T(bb[s * N + r]);
        odt::qr_solve_shfl<N, W>(c, col, xs);
        if (s < B && c < N) x[s * N + c] = xs[c];
      });
    for (auto& t : ts) t.join();
  }
  f = std::fopen(out, "wb");
  std::fwrite(x.data(), 8, x.size(), f);
  std::fclose(f);
}

int main(int argc, char** argv) {
  const std::string what = argv[1];
  if (what == "k1f64") k1<double>(argv[2], argv[3]);
  if (what == "k1f32") k1<float>(argv[2], argv[3]);
  if (what == "k2f64") k2<double>(argv[2], argv[3]);
  if (what == "k2f32") k2<float>(argv[2], argv[3]);
}
