"""The kernels' build tables against their CUDA sources, on the CPU.

The CUDA sources compile only on a machine with the card, so these tests
check what can be checked without ``nvcc``: that every C entry point the
wrappers call (``_build.SIGNATURES``) is instantiated by exactly one line
of ``csrc/*.cu``, that the functors given the narrow kernels (K1's and
K4's tiles, K1n's 64-thread group) fit them, that the library's name
follows its sources, that ``ptxas_report`` reads a ``-Xptxas -v`` log,
that K2's and K3's tile kernels fit their tiles and have a cut for every
shape they serve, that those wrappers pick their kernel by width
(``_build.batched_solve_route``, ``riccati_route``, which need no
library), and that the K1, K2, K3 and K4 wrappers run their plain
versions on CPU tensors.
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
        "ODT_BATCHED_SOLVE_TILE": lambda a: (
            "odt_batched_solve_tile_n%s_k%s_%s" % (a[0], a[1], a[2])),
        "ODT_RICCATI": lambda a: "odt_riccati_nx%s_nu%s_%s" % (a[0], a[1],
                                                               a[2]),
        "ODT_RICCATI_TILE": lambda a: "odt_riccati_tile_nx%s_nu%s_%s" % (
            a[0], a[1], a[2]),
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
                      "planar_push": 64, "rocket_projection": 16,
                      "hopper": 32}
    assert _build.fused_ip_narrow_symbol("planar_push", torch.float32) == \
        "odt_fused_ip_group_planar_push_f32"
    assert _build.fused_ip_narrow_symbol("cartpole_friction",
                                         torch.float64) == \
        "odt_fused_ip_tile_cartpole_friction_f64"
    assert {("fused_rollout", f) for f in _build.FUSED_ROLLOUT_FUNCTORS} \
        <= set(_build.FUSED_IP_TILE_MAX_B)


def _small_solve_shapes():
    return sorted((n, k) for n, k in _build.BATCHED_SOLVE_SHAPES
                  if n <= _build.UNROLL_MAX_N)


def test_tile_cut_tables_cover_every_shape():
    """K3's cut table has every RICCATI_SHAPES entry and K2's every
    BATCHED_SOLVE_SHAPES entry with n <= UNROLL_MAX_N (above it the group
    kernel runs every width); each cut is a batch the int32 launch takes,
    and a shape that was not swept takes a cut no wider than the swept
    ones (K3: (4, 1); K2: (10, 8) and (6, 6))."""
    text = (_build.CSRC / "odt_common.cuh").read_text()
    assert int(re.search(r"constexpr int UNROLL_MAX_N = (\d+);",
                         text)[1]) == _build.UNROLL_MAX_N
    assert set(_build.RICCATI_TILE_MAX_B) == set(_build.RICCATI_SHAPES)
    assert set(_build.BATCHED_SOLVE_TILE_MAX_B) == set(_small_solve_shapes())
    for table in (_build.RICCATI_TILE_MAX_B, _build.BATCHED_SOLVE_TILE_MAX_B):
        assert all(isinstance(b, int) and 0 <= b < 2 ** 31
                   for b in table.values())
    k3, k2 = _build.RICCATI_TILE_MAX_B, _build.BATCHED_SOLVE_TILE_MAX_B
    assert all(b <= k3[4, 1] for b in k3.values())
    swept = min(k2[10, 8], k2[6, 6])
    assert k2[10, 1] <= k2[10, 8]
    assert k2[2, 1] <= swept and k2[2, 6] <= swept


def _pow2_at_least(n):
    return 1 << (n - 1).bit_length()


def test_k2_k3_tile_widths_fit():
    """K2's tile holds the n + k columns of [A | b] (the smallest power of
    two >= n + k, ``solve_tile_width``) and K3's the nx columns of the
    gains (an element of the nx x nx updates a thread, capped at a warp,
    ``riccati_tile_width``), each within a warp and whole to a block: N +
    K <= W <= 32 and NX <= W <= 32, powers of two. Above
    ``RICCATI_TILE_LANE_NU`` controls K3's tile factors Quu once in a
    shared slab, and a block's float64 slabs stay within the 48 KB of
    static shared memory."""
    solve = (_build.CSRC / "batched_solve.cu").read_text()
    assert re.search(r"while \(w < N \+ K\) w \*= 2;", solve)
    sblock = int(re.search(r"constexpr int SOLVE_TILE_BLOCK = (\d+);",
                           solve)[1])
    ric = (_build.CSRC / "riccati.cuh").read_text()
    assert re.search(r"while \(w < NX \* NX && w < 32\) w \*= 2;", ric)
    rblock = int(re.search(r"constexpr int RICCATI_TILE_BLOCK = (\d+);",
                           ric)[1])
    widths = {}
    for n, k in _small_solve_shapes():
        w = _pow2_at_least(n + k)
        assert n + k <= w <= 32 and w & (w - 1) == 0 and sblock % w == 0
        assert w < 2 * (n + k)
        widths[n, k] = w
    assert widths == {(2, 1): 4, (2, 6): 8, (6, 6): 16, (10, 1): 16,
                      (10, 4): 16, (10, 8): 32, (12, 1): 16, (12, 16): 32}
    lane_nu = int(re.search(r"constexpr int RICCATI_TILE_LANE_NU = (\d+);",
                            ric)[1])
    assert lane_nu == 4
    widths = {}
    for nx, nu in _build.RICCATI_SHAPES:
        w = min(32, _pow2_at_least(nx * nx))
        assert nx <= w <= 32 and w & (w - 1) == 0 and rblock % w == 0
        # RiccatiSlab (one step's inputs, Vx, Vxx, VF, VFu, Qxx, Qux, KK,
        # QK), and above lane_nu RiccatiFactor (Quu, L, k, Quu k)
        slab = (2 * nx * nx + 2 * nx * nu + nx + nu + nu * nu
                + nx + 3 * nx * nx + nx * nu + 3 * nu * nx)
        if nu > lane_nu:
            slab += 2 * nu * nu + 2 * nu
        assert 8 * slab * (rblock // w) <= 48 * 1024, (nx, nu)
        widths[nx] = w
    assert widths == {4: 16, 6: 32, 10: 32, 16: 32}


@pytest.mark.parametrize("kind", ["batched_solve", "riccati"])
def test_tile_entry_points_declared_and_instantiated_once(kind):
    """Each of the new tile kernels' float32 and float64 entry points is in
    SIGNATURES with its per-thread kernel's argument types and is
    instantiated by one line of csrc/."""
    instantiated = _instantiated_symbols()
    if kind == "riccati":
        shapes, symbol = _build.RICCATI_SHAPES, _build.riccati_symbol
    else:
        shapes, symbol = _small_solve_shapes(), _build.batched_solve_symbol
    for a, b in shapes:
        for dt in (torch.float32, torch.float64):
            tile = symbol(a, b, dt, "tile")
            assert "_tile_" in tile and tile in _build.SIGNATURES
            assert instantiated.count(tile) == 1
            assert _build.SIGNATURES[tile] == _build.SIGNATURES[
                symbol(a, b, dt)]


@pytest.mark.parametrize("kind,shape", [
    ("riccati", s) for s in sorted(_build.RICCATI_SHAPES)] + [
    ("batched_solve", s) for s in sorted(_build.BATCHED_SOLVE_SHAPES)])
def test_k2_k3_route_by_width(kind, shape, monkeypatch):
    """The wrappers' choice of kernel is a pure function of the shape and
    B: the tile kernel up to the shape's cut, the per-thread kernel past
    it, K2's group kernel above UNROLL_MAX_N at any width; the symbol
    names the route."""
    if kind == "riccati":
        table, route, symbol = (_build.RICCATI_TILE_MAX_B,
                                _build.riccati_route, _build.riccati_symbol)
    else:
        table, route, symbol = (_build.BATCHED_SOLVE_TILE_MAX_B,
                                _build.batched_solve_route,
                                _build.batched_solve_symbol)
    if shape in table:
        monkeypatch.setitem(table, shape, 100)
        picks = [route(*shape, B) for B in (1, 99, 100, 101, 25600)]
        assert picks == ["tile"] * 3 + ["thread"] * 2
        monkeypatch.setitem(table, shape, 0)
        assert route(*shape, 1) == "thread"
    else:
        assert kind == "batched_solve" and shape[0] > _build.UNROLL_MAX_N
        assert {route(*shape, B) for B in (1, 6400, 2 ** 31 - 1)} == {
            "group"}
    for r in {route(*shape, B) for B in (1, 2 ** 31 - 1)}:
        name = symbol(*shape, torch.float64, r)
        assert name in _build.SIGNATURES
        assert ("_tile_" in name) == (r == "tile")


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
    if model_name == "rocket_projection":
        from optimization_dynamics_tpu_torch.examples import rocket as ex
        from optimization_dynamics_tpu_torch.utils.measure import (
            rocket_projection_batch)

        model, z0s, ths = rocket_projection_batch(3, 5, torch.device("cpu"),
                                                  dtype)
        return model, IPOptions(r_tol=ex.DEPLOY_R_TOL_ACCEL,
                                kappa_tol=ex.PROJ_KAPPA_TOL), z0s, ths
    if model_name == "hopper":
        from optimization_dynamics_tpu_torch.examples.hopper import (
            DEPLOY_IP_ACCEL)
        from optimization_dynamics_tpu_torch.utils.measure import (
            hopper_batch)

        model, z0s, ths = hopper_batch(3, 5, torch.device("cpu"), dtype)
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


@pytest.mark.parametrize("model_name", ["cartpole_friction", "planar_push",
                                        "rocket_projection", "hopper"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_ip_wrapper_runs_plain_on_cpu_at_any_width(dtype, model_name,
                                                         monkeypatch):
    """On CPU tensors the K1 wrapper runs its plain version whatever the
    width, below, at and above the functor's cut (set to 2 here: cartpole's,
    the rocket projection's and the hopper model's tile kernels, push's
    group kernel), and counts no launch of any kernel."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_k3_wrappers_run_plain_on_cpu_at_any_width(dtype, monkeypatch):
    """On CPU tensors the K2 and K3 wrappers run their plain versions
    whatever the width, below, at and above a cut set to 2, and count no
    launch of either kernel."""
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve, batched_solve_plain)
    from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
        riccati_backward, riccati_backward_plain)
    from optimization_dynamics_tpu_torch.utils.measure import lqr_batch

    monkeypatch.setitem(_build.BATCHED_SOLVE_TILE_MAX_B, (10, 8), 2)
    monkeypatch.setitem(_build.RICCATI_TILE_MAX_B, (4, 1), 2)
    rng = np.random.default_rng(8)
    A = torch.as_tensor(rng.standard_normal((3, 10, 10)) + 6 * np.eye(10),
                        dtype=dtype)
    b = torch.as_tensor(rng.standard_normal((3, 10, 8)), dtype=dtype)
    data = lqr_batch(9, 3, 5, 4, 1, torch.device("cpu"), dtype)
    mask = torch.ones((4, 1), dtype=dtype)
    for B in (1, 2, 3):
        counts = [(w.launches, w.tile_launches, dict(w.widths))
                  for w in (batched_solve, riccati_backward)]
        assert torch.equal(batched_solve(A[:B], b[:B]),
                           batched_solve_plain(A[:B], b[:B]))
        got = riccati_backward(*(a[:B] for a in data), mask)
        ref = riccati_backward_plain(*(a[:B] for a in data), mask)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        assert counts == [(w.launches, w.tile_launches, dict(w.widths))
                          for w in (batched_solve, riccati_backward)]


@pytest.mark.parametrize("layout,copied", [
    ("contiguous", False), ("interleaved", False), ("one_column", False),
    ("columns_strided", True)])
def test_k2_wrapper_passes_row_strided_inputs_uncopied(layout, copied):
    """K2's kernels read any strides between systems and between rows, so
    the wrapper hands them a tensor whose rows' entries are adjacent as it
    is (the IFT Jacobians, interleaved row by row; a one-column slice of
    them) and copies only one whose columns are strided."""
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        _rows_adjacent)
    from optimization_dynamics_tpu_torch.utils.measure import (
        interleave_rows)

    t = torch.arange(5 * 4 * 3, dtype=torch.float64).reshape(5, 4, 3)
    t = {"contiguous": t, "interleaved": interleave_rows([t])[0],
         "one_column": interleave_rows([t])[0][:, :, 1:2],
         "columns_strided": t.transpose(1, 2)}[layout]
    got = _rows_adjacent(t)
    assert torch.equal(got, t)
    assert (got is not t) == copied
    if copied:
        assert got.is_contiguous()


def test_interleave_rows_is_the_ift_jacobians_layout():
    """``interleave_rows`` lays a batch out as ``batched_jacobian`` gives
    the derivative sweep its Jacobians: strides (m, B m, 1)."""
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        batched_jacobian)
    from optimization_dynamics_tpu_torch.utils.measure import (
        interleave_rows)

    model, _, z0s, ths = _cpu_ip_batch("cartpole_friction", torch.float64)
    for argnum in (0, 1):
        jac = batched_jacobian(model.residual, argnum)(z0s, ths)
        mine = interleave_rows([jac.contiguous()])[0]
        assert torch.equal(mine, jac)
        assert mine.stride() == jac.stride()
        B, _, m = jac.shape
        assert jac.stride() == (m, B * m, 1)
