"""The kernels' build tables against their CUDA sources, on the CPU.

The CUDA sources compile only on a machine with the card, so these tests
check what can be checked without ``nvcc``: that every C entry point the
wrappers call (``_build.SIGNATURES``) is instantiated by exactly one line
of ``csrc/*.cu``, that the functors given the narrow kernels (K1's and
K4's tiles, K1n's 64-thread group) fit them, that the library's name
follows its sources, that ``ptxas_report`` reads a ``-Xptxas -v`` log,
and that the K1 and K4 wrappers run their plain versions on CPU tensors.
"""

import re

import numpy as np
import pytest
import torch

from optimization_dynamics_tpu_torch.ops.kernels import _build


def _instantiated_symbols():
    """C names of the entry points that csrc/*.cu instantiate."""
    names = {
        "ODT_FUSED_IP": lambda a: "odt_fused_ip_%s_%s" % (a[0], a[2]),
        "ODT_FUSED_IP_TILE": lambda a: "odt_fused_ip_tile_%s_%s" % (a[0],
                                                                     a[2]),
        "ODT_FUSED_IP_GROUP": lambda a: "odt_fused_ip_group_%s_%s" % (a[0],
                                                                       a[2]),
        "ODT_FUSED_ROLLOUT": lambda a: "odt_fused_rollout_%s_%s" % (a[0],
                                                                     a[2]),
        "ODT_FUSED_ROLLOUT_TILE": lambda a: "odt_fused_rollout_tile_%s_%s" % (
            a[0], a[2]),
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
    """A functor's narrow kernel runs a scenario on several threads. Its
    tile (csrc/ip_tile.cuh, ip_tile_width) is the smallest power of two
    that holds its NZ Jacobian columns and the right-hand side: at most a
    warp, whole tiles to a block of IP_TILE_BLOCK threads. A functor
    whose NZ + 1 columns do not fit a warp (planar push) runs on a group
    of IP_GROUP_THREADS = 64 threads instead (csrc/ip_group.cuh), whole
    groups to a block of IP_GROUP_BLOCK threads, one named barrier each.
    Every (wrapper, functor) entry of FUSED_IP_TILE_MAX_B has its narrow
    kernel's float32 and float64 entry points: K1's tile or group kernel,
    or K4's tile kernel for a functor with a fused rollout."""
    text = (_build.CSRC / "ip_tile.cuh").read_text()
    block = int(re.search(r"constexpr int IP_TILE_BLOCK = (\d+);", text)[1])
    assert re.search(r"while \(w < M::NZ \+ 1\) w \*= 2;", text)
    gtext = (_build.CSRC / "ip_group.cuh").read_text()
    group = int(re.search(r"constexpr int IP_GROUP_THREADS = (\d+);",
                          gtext)[1])
    gblock = int(re.search(r"constexpr int IP_GROUP_BLOCK = (\d+);",
                           gtext)[1])
    assert group == 64 and gblock % group == 0 and gblock // group <= 15
    symbol = {"fused_ip": _build.fused_ip_narrow_symbol,
              "fused_rollout": _build.fused_rollout_tile_symbol}
    instantiated = _instantiated_symbols()
    widths = {}
    for (wrapper, functor), max_b in _build.FUSED_IP_TILE_MAX_B.items():
        nz, _ = _build.FUSED_IP_FUNCTORS[functor]
        width = 1 << nz.bit_length()     # smallest power of two >= nz + 1
        assert max_b > 0
        if width <= 32:
            assert _build.fused_ip_narrow(functor) == "tile"
            assert nz + 1 <= width and block % width == 0
        else:
            assert _build.fused_ip_narrow(functor) == "group"
            assert wrapper == "fused_ip" and nz + 1 <= group
            width = group
        widths[functor] = width
        for dt in (torch.float32, torch.float64):
            name = symbol[wrapper](functor, dt)
            assert name in _build.SIGNATURES
            assert instantiated.count(name) == 1
    assert widths == {"cartpole_friction": 16, "acrobot_impact": 8,
                      "planar_push": 64}
    assert _build.fused_ip_narrow_symbol("planar_push", torch.float32) == \
        "odt_fused_ip_group_planar_push_f32"
    assert _build.fused_ip_narrow_symbol("cartpole_friction",
                                         torch.float64) == \
        "odt_fused_ip_tile_cartpole_friction_f64"
    assert {("fused_rollout", f) for f in _build.FUSED_ROLLOUT_FUNCTORS} \
        <= set(_build.FUSED_IP_TILE_MAX_B)


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


def _cpu_ip_batch(model_name, dtype):
    """(model, IP options, z0s, thetas) of three small CPU scenarios."""
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    if model_name == "planar_push":
        from optimization_dynamics_tpu_torch.examples.planar_push import (
            DEPLOY_IP_ACCEL)
        from optimization_dynamics_tpu_torch.utils.measure import push_batch

        model, z0s, ths = push_batch(3, 5, torch.device("cpu"), dtype)
        return model, IPOptions(**DEPLOY_IP_ACCEL), z0s, ths
    from optimization_dynamics_tpu_torch.examples.cartpole import (
        DEPLOY_IP_ACCEL)
    from optimization_dynamics_tpu_torch.models import cartpole

    model = cartpole.friction_model()
    q1 = torch.tensor([[0.1, 3.0], [-0.2, 0.5], [0.0, -1.0]], dtype=dtype)
    aux = cartpole.CartpoleAux(h=0.05, friction=torch.tensor(
        [0.35, 0.35], dtype=dtype))
    z0s = model.init_z(q1)
    ths = model.theta_fn(q1 - 0.01, q1, torch.ones((3, 1), dtype=dtype), aux)
    return model, IPOptions(**DEPLOY_IP_ACCEL), z0s, ths


@pytest.mark.parametrize("model_name", ["cartpole_friction", "planar_push"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_ip_wrapper_runs_plain_on_cpu_at_any_width(dtype, model_name,
                                                         monkeypatch):
    """On CPU tensors the K1 wrapper runs its plain version whatever the
    width, below, at and above the functor's cut (set to 2 here: cartpole's
    tile kernel, push's group kernel), and counts no launch of any
    kernel."""
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        fused_ip, make_fused_ip_plain, make_fused_ip_solver)

    monkeypatch.setitem(_build.FUSED_IP_TILE_MAX_B, ("fused_ip", model_name),
                        2)
    model, opts, z0s, ths = _cpu_ip_batch(model_name, dtype)
    assert model.kernel == model_name
    cpu = torch.device("cpu")
    for B in (1, 2, 3):
        launches, tiles = fused_ip.launches, fused_ip.tile_launches
        widths = dict(fused_ip.widths)
        got = make_fused_ip_solver(model, opts, cpu, dtype)(z0s[:B],
                                                            ths[:B])
        ref = make_fused_ip_plain(model, opts, cpu, dtype)(z0s[:B], ths[:B])
        assert (fused_ip.launches, fused_ip.tile_launches) == (launches,
                                                               tiles)
        assert dict(fused_ip.widths) == widths
        assert torch.equal(got.z, ref.z)
        assert torch.equal(got.iterations, ref.iterations)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_rollout_wrapper_runs_plain_on_cpu_at_any_width(dtype,
                                                              monkeypatch):
    """On CPU tensors the K4 wrapper runs its plain version whatever the
    width, at and above its cut (set to 2 here), and counts no launch of
    either kernel."""
    from optimization_dynamics_tpu_torch.examples.cartpole import (
        DEPLOY_IP_ACCEL)
    from optimization_dynamics_tpu_torch.models import cartpole
    from optimization_dynamics_tpu_torch.ops.kernels.fused_rollout import (
        fused_rollout, make_fused_rollout, make_fused_rollout_plain)
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    monkeypatch.setitem(_build.FUSED_IP_TILE_MAX_B,
                        ("fused_rollout", "cartpole_friction"), 2)
    model = cartpole.friction_model()
    opts = IPOptions(**DEPLOY_IP_ACCEL)
    cpu, T = torch.device("cpu"), 4
    aux = cartpole.CartpoleAux(h=0.05, friction=torch.tensor(
        [0.35, 0.35], dtype=dtype))
    rng = np.random.default_rng(3)
    for B in (1, 2, 3):
        t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype)
        args = (0.01 * t(B, 4), 0.01 * t(B, T, 4), 0.5 * t(B, T - 1, 1),
                0.1 * t(B, T - 1, 1, 4), 0.2 * t(B, T - 1, 1),
                torch.full((B,), 0.5, dtype=dtype))
        launches, tiles = fused_rollout.launches, fused_rollout.tile_launches
        widths = dict(fused_rollout.widths)
        got = make_fused_rollout(model, opts, aux, T, None, cpu, dtype)(
            *args, return_stats=True)
        ref = make_fused_rollout_plain(model, opts, aux, T, None, cpu,
                                       dtype)(*args)
        assert (fused_rollout.launches,
                fused_rollout.tile_launches) == (launches, tiles)
        assert dict(fused_rollout.widths) == widths
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
