"""Trajectory visualization (MeshCat-free).

Port of ``optimization_dynamics_tpu/utils/viz.py``: matplotlib frame
plots and self-contained HTML players (canvas frames, a time slider,
autoplay; the 3-D player with an orbit camera), written next to the
results. No external library is loaded by the page.

Per-model ``frame_*`` functions return 2-D line segments for one
configuration (``frame_*_3d`` 3-D ones); ``animate_html`` and
``animate_html_3d`` stitch frames into an HTML file. Everything here is
numpy on the host; the rocket's frames rotate by the port's
``models/rocket.py::mrp_rotation`` on a CPU float64 tensor. Trajectories
may be tensors on any device or arrays. matplotlib is imported only by
``plot_trajectory`` (``visualize`` and ``maybe_visualize`` call it).
"""

from __future__ import annotations

import json
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "frame_cartpole", "frame_acrobot", "frame_planar_push", "frame_hopper",
    "frame_rocket", "animate_html", "plot_trajectory", "visualize",
    "frame_rocket_3d", "animate_html_3d", "visualize_rocket_3d",
    "frame_cartpole_3d", "frame_acrobot_3d", "frame_planar_push_3d",
    "frame_hopper_3d", "visualize_3d", "load_obj_segments",
    "visualize_rocket_3d_mesh", "maybe_visualize",
]

_FRAMES = {}


def _np(a) -> np.ndarray:
    """A trajectory or state as a host array (tensors on any device)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rotation(p) -> np.ndarray:
    """The rotation matrix of MRP ``p`` (3,), by the port's rocket model
    on a CPU float64 tensor."""
    import torch

    from optimization_dynamics_tpu_torch.models.rocket import mrp_rotation
    return mrp_rotation(torch.as_tensor(np.asarray(p, np.float64))).numpy()


def visualize(model_name: str, qs, path: str, dt: float = 0.05):
    """Per-model animation export — the build's ``visualize!``
    (the Julia package's ``src/models/*/visuals.jl``). ``model_name`` in
    {cartpole, acrobot, planar_push, hopper, rocket}; writes a
    self-contained HTML player plus a PNG overlay next to it."""
    frame_fn = _FRAMES[model_name]
    html = animate_html(qs, frame_fn, path, dt=dt, title=model_name)
    png = path.rsplit(".", 1)[0] + ".png"
    plot_trajectory(qs, frame_fn, png, stride=max(len(qs) // 20, 1))
    return html, png


def frame_cartpole(q, length=0.5):
    cart = [(-0.15 + q[0], 0.0), (0.15 + q[0], 0.0)]
    tip = (q[0] + length * np.sin(q[1]), -length * np.cos(q[1]))
    pole = [(q[0], 0.0), tip]
    return [cart, pole]


def frame_acrobot(q, l1=1.0, l2=1.0):
    p1 = (l1 * np.sin(q[0]), -l1 * np.cos(q[0]))
    p2 = (p1[0] + l2 * np.sin(q[0] + q[1]),
          p1[1] - l2 * np.cos(q[0] + q[1]))
    return [[(0.0, 0.0), p1], [p1, p2]]


def frame_planar_push(q, r=0.1):
    c, s = np.cos(q[2]), np.sin(q[2])
    R = np.array([[c, -s], [s, c]])
    corners = [R @ np.array(p) + q[0:2]
               for p in [(r, r), (-r, r), (-r, -r), (r, -r), (r, r)]]
    box = [tuple(p) for p in corners]
    pusher = [(q[3] - 0.02, q[4]), (q[3] + 0.02, q[4])]
    return [box, pusher]


def frame_hopper(q, body_radius=0.1):
    foot = (q[0] + q[3] * np.sin(q[2]), q[1] - q[3] * np.cos(q[2]))
    leg = [(q[0], q[1]), foot]
    ang = np.linspace(0, 2 * np.pi, 17)
    body = [(q[0] + body_radius * np.cos(a),
             q[1] + body_radius * np.sin(a)) for a in ang]
    return [leg, body]


def frame_rocket(x, length=1.0):
    x = _np(x)
    R = _rotation(x[3:6])
    top = x[0:3] + R @ np.array([0.0, 0.0, 0.5 * length])
    bot = x[0:3] - R @ np.array([0.0, 0.0, 0.5 * length])
    # project to (x, z)
    return [[(bot[0], bot[2]), (top[0], top[2])]]


# filled at import (the reference defines this table in a ``_register``
# that nothing calls, so its ``visualize`` raises ``KeyError``)
_FRAMES.update({
    "cartpole": frame_cartpole,
    "acrobot": frame_acrobot,
    "planar_push": frame_planar_push,
    "hopper": frame_hopper,
    "rocket": frame_rocket,
})


def plot_trajectory(qs, frame_fn: Callable, path: str, stride: int = 1):
    """Overlayed frames as a PNG via matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    qs = _np(qs)
    n = len(qs)
    fig, ax = plt.subplots(figsize=(6, 6))
    for i in range(0, n, stride):
        alpha = 0.15 + 0.85 * i / max(n - 1, 1)
        for seg in frame_fn(qs[i]):
            xs, ys = zip(*seg)
            ax.plot(xs, ys, "-", color="tab:blue", alpha=alpha, lw=1.5)
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def animate_html(qs, frame_fn: Callable, path: str, dt: float = 0.05,
                 title: str = "trajectory"):
    """Self-contained HTML animation (no external deps)."""
    qs = _np(qs)
    frames = []
    for q in qs:
        frames.append([[list(map(float, p)) for p in seg]
                       for seg in frame_fn(q)])
    all_pts = [p for f in frames for seg in f for p in seg]
    xs = [p[0] for p in all_pts]
    ys = [p[1] for p in all_pts]
    pad = 0.2
    bounds = [min(xs) - pad, min(ys) - pad, max(xs) + pad, max(ys) + pad]
    html = f"""<!DOCTYPE html><html><head><title>{title}</title></head>
<body style="background:#fff;text-align:center">
<h3>{title}</h3>
<canvas id="c" width="600" height="600" style="border:1px solid #ccc"></canvas><br>
<input id="s" type="range" min="0" max="{len(frames) - 1}" value="0" style="width:600px">
<script>
const frames = {json.dumps(frames)};
const b = {json.dumps(bounds)};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
function tf(p) {{
  const sx = cv.width / (b[2] - b[0]), sy = cv.height / (b[3] - b[1]);
  const s = Math.min(sx, sy);
  return [(p[0] - b[0]) * s, cv.height - (p[1] - b[1]) * s];
}}
function draw(i) {{
  ctx.clearRect(0, 0, cv.width, cv.height);
  ctx.strokeStyle = '#1f77b4'; ctx.lineWidth = 3;
  for (const seg of frames[i]) {{
    ctx.beginPath();
    seg.forEach((p, j) => {{
      const q = tf(p);
      j ? ctx.lineTo(q[0], q[1]) : ctx.moveTo(q[0], q[1]);
    }});
    ctx.stroke();
  }}
}}
const sl = document.getElementById('s');
sl.oninput = () => draw(+sl.value);
let i = 0;
setInterval(() => {{ i = (i + 1) % frames.length; sl.value = i; draw(i); }},
            {int(dt * 1000)});
draw(0);
</script></body></html>"""
    with open(path, "w") as f:
        f.write(html)
    return path


def frame_rocket_3d(x, u=None, length=1.0, radius=0.12):
    """3-D wireframe of the rocket body (+ thrust vector when ``u`` is
    given): an octagonal prism along the body z-axis, nose lines, and the
    tail-mounted thrust direction — the build's stand-in for the
    Julia package's MeshCat Starship mesh
    (the Julia package's ``src/models/rocket/visuals.jl:5-20``)."""
    x = _np(x)
    R = _rotation(x[3:6])
    p = np.asarray(x[0:3])
    half = 0.5 * length
    ang = np.linspace(0.0, 2 * np.pi, 9)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.zeros_like(ang)], axis=1)
    bot = (p[None] + (ring + [0, 0, -half]) @ R.T)
    top = (p[None] + (ring + [0, 0, half - 0.25 * length]) @ R.T)
    nose = p + R @ np.array([0.0, 0.0, half + 0.15 * length])
    segs = [[tuple(q) for q in bot], [tuple(q) for q in top]]
    for i in range(0, 8, 2):
        segs.append([tuple(bot[i]), tuple(top[i])])     # struts
        segs.append([tuple(top[i]), tuple(nose)])       # nose cone
    if u is not None:
        u = _np(u)
    if u is not None and np.linalg.norm(np.asarray(u)) > 1e-9:
        tail = p + R @ np.array([0.0, 0.0, -half])
        flame = tail - R @ (0.4 * np.asarray(u)
                            / max(np.linalg.norm(np.asarray(u)), 1e-9))
        segs.append([tuple(tail), tuple(flame)])
    return segs


def visualize_rocket_3d(xs, path: str, us=None, dt: float = 0.05):
    """Interactive 3-D HTML player for a rocket state trajectory
    (``xs``: (T, 12); ``us`` optional (T-1, 3) thrust for the flame)."""
    xs = _np(xs)
    frames = []
    for t, x in enumerate(xs):
        u = None if us is None or t >= len(us) else _np(us[t])
        frames.append(frame_rocket_3d(x, u))
    return animate_html_3d(frames, path, dt=dt, title="rocket (3-D)")


def animate_html_3d(frames, path: str, dt: float = 0.05,
                    title: str = "trajectory"):
    """Self-contained 3-D HTML player: canvas renderer with an orbit
    camera (drag to rotate, wheel to zoom), ground grid, trace line, time
    slider and autoplay. No external libraries (works offline)."""
    frames_js = [[[list(map(float, p)) for p in seg] for seg in f]
                 for f in frames]
    pts = [p for f in frames_js for seg in f for p in seg]
    c = np.mean(np.asarray(pts), axis=0) if pts else np.zeros(3)
    ext = (np.max(np.abs(np.asarray(pts) - c[None])) + 1e-6) if pts else 1.0
    # trajectory trace: mean point of the first segment of each frame
    trace = [list(map(float, np.mean(np.asarray(f[0]), axis=0)))
             for f in frames_js if f]
    html = f"""<!DOCTYPE html><html><head><title>{title}</title></head>
<body style="background:#fff;text-align:center;font-family:sans-serif">
<h3>{title}</h3>
<canvas id="c" width="720" height="600" style="border:1px solid #ccc"></canvas><br>
<input id="s" type="range" min="0" max="{len(frames_js) - 1}" value="0" style="width:720px">
<div style="color:#888">drag: orbit &middot; wheel: zoom</div>
<script>
const frames = {json.dumps(frames_js)};
const trace = {json.dumps(trace)};
const C = {json.dumps(list(map(float, c)))};
let ext = {float(ext)};
let yaw = 0.7, pitch = 0.35, zoom = 1.0;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
function proj(p) {{
  const x = p[0] - C[0], y = p[1] - C[1], z = p[2] - C[2];
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cy * x + sy * y, y1 = -sy * x + cy * y;
  const y2 = cp * y1 + sp * z, z2 = -sp * y1 + cp * z;
  const d = 4 * ext / zoom;
  const f = d / (d + y2 + 2 * ext);
  const s = 0.35 * Math.min(cv.width, cv.height) / ext * zoom;
  return [cv.width / 2 + x1 * f * s, cv.height / 2 - z2 * f * s];
}}
function polyline(ps, style, w) {{
  ctx.strokeStyle = style; ctx.lineWidth = w; ctx.beginPath();
  ps.forEach((p, j) => {{
    const q = proj(p);
    j ? ctx.lineTo(q[0], q[1]) : ctx.moveTo(q[0], q[1]);
  }});
  ctx.stroke();
}}
function draw(i) {{
  ctx.clearRect(0, 0, cv.width, cv.height);
  const g = Math.ceil(ext);
  for (let k = -g; k <= g; k++) {{
    polyline([[k, -g, 0], [k, g, 0]], '#e5e5e5', 1);
    polyline([[-g, k, 0], [g, k, 0]], '#e5e5e5', 1);
  }}
  polyline([[0,0,0],[1,0,0]], '#d62728', 2);
  polyline([[0,0,0],[0,1,0]], '#2ca02c', 2);
  polyline([[0,0,0],[0,0,1]], '#1f77b4', 2);
  if (trace.length > 1) polyline(trace.slice(0, i + 1), '#aec7e8', 2);
  for (const seg of frames[i]) polyline(seg, '#1f77b4', 2.5);
}}
const sl = document.getElementById('s');
sl.oninput = () => draw(+sl.value);
let dragging = false, px = 0, py = 0;
cv.onmousedown = e => {{ dragging = true; px = e.clientX; py = e.clientY; }};
window.onmouseup = () => dragging = false;
window.onmousemove = e => {{
  if (!dragging) return;
  yaw += (e.clientX - px) * 0.01; pitch += (e.clientY - py) * 0.01;
  pitch = Math.max(-1.5, Math.min(1.5, pitch));
  px = e.clientX; py = e.clientY; draw(+sl.value);
}};
cv.onwheel = e => {{
  e.preventDefault();
  zoom *= e.deltaY < 0 ? 1.1 : 0.9;
  zoom = Math.max(0.2, Math.min(8, zoom)); draw(+sl.value);
}};
let i = 0;
setInterval(() => {{ i = (i + 1) % frames.length; sl.value = i; draw(i); }},
            {int(dt * 1000)});
draw(0);
</script></body></html>"""
    with open(path, "w") as f:
        f.write(html)
    return path


def _box_segments(center, half, R=None):
    """12-edge wireframe of an axis-aligned box (optionally rotated)."""
    cx, cy, cz = center
    hx, hy, hz = half
    corners = np.array([[sx * hx, sy * hy, sz * hz]
                        for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)])
    if R is not None:
        corners = corners @ np.asarray(R).T
    corners = corners + np.array([cx, cy, cz])
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6),
             (5, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
    return [[tuple(corners[a]), tuple(corners[b])] for a, b in edges]


def frame_cartpole_3d(q, length=0.5):
    """Cart as a box on a rail (x-axis), pole swinging in the x-z
    plane — the 3-D analog of the Julia package's MeshCat scene
    (the Julia package's ``src/models/cartpole/visuals.jl``)."""
    segs = [[(-2.0, 0.0, 0.0), (2.0, 0.0, 0.0)]]           # rail
    segs += _box_segments((q[0], 0.0, 0.0), (0.15, 0.08, 0.06))
    tip = (q[0] + length * np.sin(q[1]), 0.0, -length * np.cos(q[1]))
    segs.append([(q[0], 0.0, 0.0), tip])
    segs += _box_segments(tip, (0.03, 0.03, 0.03))
    return segs


def frame_acrobot_3d(q, l1=1.0, l2=1.0):
    """Double pendulum in the x-z plane with elbow/tip markers
    (the Julia package's ``src/models/acrobot/visuals.jl``)."""
    p1 = (l1 * np.sin(q[0]), 0.0, -l1 * np.cos(q[0]))
    p2 = (p1[0] + l2 * np.sin(q[0] + q[1]), 0.0,
          p1[2] - l2 * np.cos(q[0] + q[1]))
    segs = [[(0.0, 0.0, 0.0), p1], [p1, p2]]
    segs += _box_segments(p1, (0.04, 0.04, 0.04))
    segs += _box_segments(p2, (0.04, 0.04, 0.04))
    return segs


def frame_planar_push_3d(q, r=0.1):
    """Block extruded out of the table plane + vertical pusher rod
    (the Julia package's ``src/models/planar_push/visuals.jl``)."""
    c, s = np.cos(q[2]), np.sin(q[2])
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    segs = _box_segments((q[0], q[1], r), (r, r, r), R)
    segs.append([(q[3], q[4], 0.0), (q[3], q[4], 2.5 * r)])  # pusher rod
    ang = np.linspace(0, 2 * np.pi, 13)
    segs.append([(q[3] + 0.02 * np.cos(a), q[4] + 0.02 * np.sin(a), r)
                 for a in ang])                              # pusher tip
    return segs


def frame_hopper_3d(q, body_radius=0.1):
    """Hopper body as orthogonal rings + leg to the foot
    (RoboDojo's hopper, the Julia package's ``examples/hopper.jl``)."""
    ang = np.linspace(0, 2 * np.pi, 17)
    bx, bz = q[0], q[1]
    segs = [[(bx + body_radius * np.cos(a), 0.0,
              bz + body_radius * np.sin(a)) for a in ang],
            [(bx + body_radius * np.cos(a),
              body_radius * np.sin(a), bz) for a in ang]]
    foot = (bx + q[3] * np.sin(q[2]), 0.0, bz - q[3] * np.cos(q[2]))
    segs.append([(bx, 0.0, bz), foot])
    segs += _box_segments(foot, (0.03, 0.03, 0.03))
    segs.append([(-1.0, 0.0, 0.0), (3.0, 0.0, 0.0)])         # ground
    return segs


_FRAMES_3D = {
    "cartpole": frame_cartpole_3d,
    "acrobot": frame_acrobot_3d,
    "planar_push": frame_planar_push_3d,
    "hopper": frame_hopper_3d,
}


def visualize_3d(model_name: str, qs, path: str, dt: float = 0.05):
    """3-D HTML player for any model: the Julia package's MeshCat scenes
    (``src/models/visualize.jl``) as the dependency-free canvas player. ``model_name`` in
    {cartpole, acrobot, planar_push, hopper, rocket}; rocket states are
    (T, 12) and route through ``visualize_rocket_3d``."""
    if model_name == "rocket":
        return visualize_rocket_3d(qs, path, dt=dt)
    frame_fn = _FRAMES_3D[model_name]
    frames = [frame_fn(q) for q in _np(qs)]
    return animate_html_3d(frames, path, dt=dt,
                           title=f"{model_name} (3-D)")


def load_obj_segments(obj_path: str, scale: float = 1.0):
    """Edge segments of a Wavefront OBJ mesh (vertices + faces only) —
    the hook for the Julia package's optional Starship mesh
    (the Julia package's ``src/models/rocket/visuals.jl:5-20``: users supply
    their own OBJ; none ships with either repo)."""
    verts, edges = [], set()
    with open(obj_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([scale * float(v) for v in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for a, b in zip(idx, idx[1:] + idx[:1]):
                    edges.add((min(a, b), max(a, b)))
    return [[tuple(verts[a]), tuple(verts[b])] for a, b in edges]


def visualize_rocket_3d_mesh(xs, obj_path: str, path: str,
                             dt: float = 0.05, scale: float = 1.0):
    """Rocket player with a user-supplied OBJ body mesh (Starship
    option): the mesh rides the body frame instead of the built-in
    octagonal prism."""
    base = load_obj_segments(obj_path, scale=scale)
    frames = []
    for x in _np(xs):
        R = _rotation(x[3:6])
        p = np.asarray(x[0:3])
        frames.append([[tuple(p + R @ np.asarray(a)),
                        tuple(p + R @ np.asarray(b))] for a, b in base])
    return animate_html_3d(frames, path, dt=dt, title="rocket (mesh)")


def maybe_visualize(model_name: str, qs, dt: float = 0.05):
    """Write animations when ODX_VIZ_DIR is set (used by example mains)."""
    import os
    d = os.environ.get("ODX_VIZ_DIR")
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    return visualize(model_name, qs,
                     os.path.join(d, f"{model_name}.html"), dt=dt)
