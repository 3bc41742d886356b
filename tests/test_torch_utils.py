"""Port parity: ``utils/checkpoint.py``, ``utils/benchmark.py`` and
``utils/viz.py`` against the JAX package's.

* Checkpoints cross-load: a shard the port writes loads with the
  reference's ``load_result`` and the reverse, arrays bit for bit, the
  metadata equal, ``completed_shards`` the same.
* ``benchmark`` returns the reference's ``BenchStats`` fields.
* Every 2-D and 3-D frame function of every model equals the
  reference's to 1e-12 on the same configurations (the rocket's rotate
  by the port's ``mrp_rotation``); the HTML players and the PNG are
  written; the OBJ mesh player gives the reference's frames.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.solver.ilqr import ILQRResult as JaxResult
from optimization_dynamics_tpu.utils import checkpoint as jck
from optimization_dynamics_tpu.utils import viz as jviz
from optimization_dynamics_tpu_torch.solver.ilqr import ILQRResult
from optimization_dynamics_tpu_torch.utils import checkpoint as tck
from optimization_dynamics_tpu_torch.utils import viz as tviz
from optimization_dynamics_tpu_torch.utils.benchmark import (BenchStats,
                                                             benchmark)

F64 = torch.float64


def _result(rng, B=3, T=5):
    """A batched ``ILQRResult``'s fields as numpy arrays."""
    f = lambda *s: rng.standard_normal(s)
    return dict(xs=f(B, T, 4), us=f(B, T - 1, 1), objective=f(B),
                al_objective=f(B),
                iterations=rng.integers(0, 50, B).astype(np.int32),
                al_iterations=rng.integers(0, 5, B).astype(np.int32),
                constraint_violation=np.abs(f(B)), gradient_norm=f(B),
                converged=rng.random(B) < 0.5, lam=f(B, T - 1, 1),
                lamT=f(B, 4), rho=np.abs(f(B)))


def test_checkpoints_cross_load(tmp_path):
    arrays = _result(np.random.default_rng(0))
    meta = {"n_converged": 2, "wall_s": 1.5, "failed_indices": [1]}
    tres = ILQRResult(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    jres = JaxResult(**{k: jnp.asarray(v) for k, v in arrays.items()})

    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tck.SweepCheckpointer(str(tdir)).save(3, tres, meta=meta)
    jck.SweepCheckpointer(str(jdir)).save(3, jres, meta=meta)
    for src in (tdir, jdir):
        path = str(src / "shard_00003.npz")
        for load in (jck.load_result, tck.load_result):
            data, m = load(path)
            assert m == meta
            assert sorted(data) == sorted(arrays)
            for k, v in arrays.items():
                assert data[k].dtype == v.dtype, k
                np.testing.assert_array_equal(data[k], v)
    assert (tck.SweepCheckpointer(str(jdir)).completed_shards()
            == jck.SweepCheckpointer(str(tdir)).completed_shards() == [3])


def test_nested_dict_layout_and_resume(tmp_path):
    """Dotted keys for nested fields, as the reference writes them; a
    ``None`` field is left out; ``done`` and the atomic save."""
    tree = {"sol": {"z": torch.ones(2, 3), "ok": torch.tensor([True, False])},
            "obj": torch.tensor([1.0, 2.0], dtype=F64), "skip": None}
    ck = tck.SweepCheckpointer(str(tmp_path))
    assert not ck.done(0)
    ck.save(0, tree, meta={"shard": 0})
    assert ck.done(0) and ck.completed_shards() == [0]
    assert not any(f.endswith(".tmp.npz") for f in os.listdir(tmp_path))
    data, meta = jck.load_result(str(tmp_path / "shard_00000.npz"))
    assert sorted(data) == ["obj", "sol.ok", "sol.z"] and meta == {"shard": 0}
    jck.save_result(str(tmp_path / "j.npz"),
                    {"sol": {"z": jnp.ones((2, 3)),
                             "ok": jnp.array([True, False])},
                     "obj": jnp.array([1.0, 2.0])})
    jdata, _ = tck.load_result(str(tmp_path / "j.npz"))
    for k in data:
        np.testing.assert_array_equal(jdata[k], data[k])


def test_benchmark_harness():
    x = torch.ones(32, 32, dtype=F64)
    st = benchmark(lambda a: a @ a, x, runs=4, warmup=2)
    assert isinstance(st, BenchStats) and st.runs == 4
    assert st._fields == ("mean_s", "median_s", "min_s", "max_s", "runs",
                          "compile_s")
    assert 0.0 < st.min_s <= st.median_s <= st.max_s
    assert st.min_s <= st.mean_s <= st.max_s and st.compile_s > 0.0
    assert "median" in repr(st)


def _configurations():
    """Per model: configurations for the 2-D / 3-D frames (rocket: full
    states), from a numpy seed."""
    rng = np.random.default_rng(3)
    return {
        "cartpole": rng.standard_normal((4, 2)),
        "acrobot": rng.standard_normal((4, 2)),
        "planar_push": rng.standard_normal((4, 5)),
        "hopper": np.abs(rng.standard_normal((4, 4))) + 0.3,
        "rocket": 0.3 * rng.standard_normal((4, 12)),
    }


def _flat(segs):
    return np.asarray([p for s in segs for p in s], dtype=float)


@pytest.mark.parametrize("name", ["cartpole", "acrobot", "planar_push",
                                  "hopper", "rocket"])
def test_frames_match_jax(name):
    qs = _configurations()[name]
    fn2 = "frame_" + name
    for q in qs:
        a, b = getattr(tviz, fn2)(q), getattr(jviz, fn2)(q)
        assert len(a) == len(b)
        for sa, sb in zip(a, b):
            np.testing.assert_allclose(_flat([sa]), _flat([sb]), atol=1e-12)
        if name == "rocket":
            u = np.array([0.2, -0.1, 1.5])
            pairs = [(tviz.frame_rocket_3d(q, u), jviz.frame_rocket_3d(q, u)),
                     (tviz.frame_rocket_3d(q), jviz.frame_rocket_3d(q))]
        else:
            pairs = [(tviz._FRAMES_3D[name](q), jviz._FRAMES_3D[name](q))]
        for a, b in pairs:
            assert len(a) == len(b)
            for sa, sb in zip(a, b):
                np.testing.assert_allclose(_flat([sa]), _flat([sb]),
                                           atol=1e-12)


def _frames_of(html):
    js = re.search(r"<script>(.*)</script>", html, re.S).group(1)
    assert js.count("{") == js.count("}")
    return json.loads(re.search(r"const frames = (\[.*?\]);\n", js,
                                re.S).group(1))


def test_players_and_png_written(tmp_path):
    """The 2-D player and PNG of ``visualize`` (from a tensor), each
    model's 3-D player, and the rocket's with its flame, against the
    reference's players' frames."""
    cfg = _configurations()
    qs = cfg["acrobot"]
    html, png = tviz.visualize("acrobot", torch.as_tensor(qs),
                               str(tmp_path / "acrobot.html"))
    assert os.path.getsize(png) > 0
    jhtml = jviz.animate_html(qs, jviz.frame_acrobot,
                              str(tmp_path / "j_acrobot.html"),
                              title="acrobot")
    np.testing.assert_allclose(
        np.asarray(_frames_of(open(html).read()), float),
        np.asarray(_frames_of(open(jhtml).read()), float), atol=1e-12)
    for name, q in cfg.items():
        t = tviz.visualize_3d(name, q, str(tmp_path / f"{name}_3d.html"))
        j = jviz.visualize_3d(name, q, str(tmp_path / f"j_{name}_3d.html"))
        ft, fj = _frames_of(open(t).read()), _frames_of(open(j).read())
        assert len(ft) == len(fj) == len(q)
        for a, b in zip(ft, fj):
            np.testing.assert_allclose(_flat(a), _flat(b), atol=1e-12)
    xs = cfg["rocket"]
    us = np.tile([0.1, 0.0, 2.0], (len(xs) - 1, 1))
    t = tviz.visualize_rocket_3d(torch.as_tensor(xs), str(tmp_path / "r.html"),
                                 us=torch.as_tensor(us))
    frames = _frames_of(open(t).read())
    assert len(frames[0]) == len(tviz.frame_rocket_3d(xs[0])) + 1


def test_maybe_visualize_follows_env(tmp_path, monkeypatch):
    monkeypatch.delenv("ODX_VIZ_DIR", raising=False)
    qs = _configurations()["cartpole"]
    assert tviz.maybe_visualize("cartpole", qs) is None
    monkeypatch.setenv("ODX_VIZ_DIR", str(tmp_path / "viz"))
    html, png = tviz.maybe_visualize("cartpole", qs)
    assert os.path.getsize(html) > 0 and os.path.getsize(png) > 0


def test_obj_mesh_player_matches_jax(tmp_path):
    obj = tmp_path / "tet.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                   "f 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n")
    segs = tviz.load_obj_segments(str(obj), scale=0.5)
    assert len(segs) == 6 and segs == jviz.load_obj_segments(str(obj),
                                                             scale=0.5)
    xs = _configurations()["rocket"]
    t = tviz.visualize_rocket_3d_mesh(xs, str(obj), str(tmp_path / "m.html"))
    j = jviz.visualize_rocket_3d_mesh(xs, str(obj), str(tmp_path / "jm.html"))
    for a, b in zip(_frames_of(open(t).read()), _frames_of(open(j).read())):
        np.testing.assert_allclose(_flat(a), _flat(b), atol=1e-12)
