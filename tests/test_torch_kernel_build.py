"""The kernels' build tables against their CUDA sources, on the CPU.

The CUDA sources compile only on a machine with the card, so these tests
check what can be checked without ``nvcc``: that every C entry point the
wrappers call (``_build.SIGNATURES``) is instantiated by exactly one line
of ``csrc/*.cu``, that the functors given K1's tile kernel fit a tile,
that the library's name follows its sources, that ``ptxas_report`` reads
a ``-Xptxas -v`` log, and that the K1 wrapper runs its plain version on
CPU tensors.
"""

import re

import pytest
import torch

from optimization_dynamics_tpu_torch.ops.kernels import _build


def _instantiated_symbols():
    """C names of the entry points that csrc/*.cu instantiate."""
    names = {
        "ODT_FUSED_IP": lambda a: "odt_fused_ip_%s_%s" % (a[0], a[2]),
        "ODT_FUSED_IP_TILE": lambda a: "odt_fused_ip_tile_%s_%s" % (a[0],
                                                                     a[2]),
        "ODT_FUSED_ROLLOUT": lambda a: "odt_fused_rollout_%s_%s" % (a[0],
                                                                     a[2]),
        "ODT_BATCHED_SOLVE": lambda a: "odt_batched_solve_n%s_k%s_%s" % (
            a[0], a[1], a[2]),
        "ODT_RICCATI": lambda a: "odt_riccati_nx%s_nu%s_%s" % (a[0], a[1],
                                                               a[2]),
    }
    out = []
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for macro, args in re.findall(r"^(ODT_\w+)\(([^)]*)\)\s*$", text,
                                      re.M):
            out.append(names[macro]([a.strip() for a in args.split(",")]))
        out += re.findall(r'^extern "C" int (odt_\w+)\(', text, re.M)
    return out


def test_every_entry_point_is_instantiated_once():
    got = _instantiated_symbols()
    assert sorted(got) == sorted(_build.SIGNATURES)


def test_tile_functors_fit_a_tile():
    """K1's tile kernel holds the NZ Jacobian columns and the right-hand
    side on one 16-thread tile (csrc/fused_ip.cuh, IP_TILE)."""
    text = (_build.CSRC / "fused_ip.cuh").read_text()
    tile = int(re.search(r"constexpr int IP_TILE = (\d+);", text)[1])
    assert tile == 16
    for functor, max_b in _build.FUSED_IP_TILE_MAX_B.items():
        nz, _ = _build.FUSED_IP_FUNCTORS[functor]
        assert nz + 1 <= tile and max_b > 0
        for dt in (torch.float32, torch.float64):
            assert _build.fused_ip_tile_symbol(functor, dt) \
                in _build.SIGNATURES


def test_library_is_named_by_its_sources(tmp_path, monkeypatch):
    """A change to any source under csrc/ names a new library, so a stale
    build is never loaded."""
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    assert before == _build.library_path()
    with open(tmp_path / "fused_ip.cuh", "a") as f:
        f.write("\n")
    assert _build.library_path() != before
    assert _build.library_path().parent == before.parent


def test_ptxas_report_reads_registers_and_shared_memory(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    kernel = "_ZN3odt20fused_ip_tile_kernelIfEEv"
    log = ("$ nvcc -c -o x.o /src/fused_ip.cu\n"
           "ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '%s' for 'sm_90a'\n"
           "ptxas info    : Function properties for %s\n"
           "    32 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 110 registers, 2112 bytes smem, 400 bytes "
           "cmem[0]\n"
           "# 26.2 s\n"
           "$ nvcc -shared -o lib.so x.o\n"
           "# 0.5 s\n") % (kernel, kernel)
    _build.library_path().with_suffix(".log").write_text(log)
    report = _build.ptxas_report()
    assert report["compile_s"] == {"fused_ip.cu": 26.2, "link": 0.5}
    assert report["kernels"][kernel] == dict(
        registers=110, smem=2112, stack=32, spill_stores=8, spill_loads=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_ip_wrapper_runs_plain_on_cpu_at_any_width(dtype):
    """On CPU tensors the K1 wrapper runs its plain version whatever the
    width, and counts no launch of either kernel."""
    from optimization_dynamics_tpu_torch.examples.cartpole import (
        DEPLOY_IP_ACCEL)
    from optimization_dynamics_tpu_torch.models import cartpole
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        fused_ip, make_fused_ip_plain, make_fused_ip_solver)
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    model = cartpole.friction_model()
    opts = IPOptions(**DEPLOY_IP_ACCEL)
    cpu = torch.device("cpu")
    q1 = torch.tensor([[0.1, 3.0], [-0.2, 0.5], [0.0, -1.0]], dtype=dtype)
    aux = cartpole.CartpoleAux(h=0.05, friction=torch.tensor(
        [0.35, 0.35], dtype=dtype))
    z0s = model.init_z(q1)
    ths = model.theta_fn(q1 - 0.01, q1, torch.ones((3, 1), dtype=dtype), aux)
    launches, tiles = fused_ip.launches, fused_ip.tile_launches
    widths = dict(fused_ip.widths)
    got = make_fused_ip_solver(model, opts, cpu, dtype)(z0s, ths)
    ref = make_fused_ip_plain(model, opts, cpu, dtype)(z0s, ths)
    assert (fused_ip.launches, fused_ip.tile_launches) == (launches, tiles)
    assert dict(fused_ip.widths) == widths
    assert torch.equal(got.z, ref.z)
    assert torch.equal(got.iterations, ref.iterations)
