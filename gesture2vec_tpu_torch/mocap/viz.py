"""Visualization + motion feature helpers.

The port's copy of the JAX package's `mocap/viz.py` (numpy, scipy and,
for the figures, matplotlib, imported inside the functions, so the
module loads where matplotlib is missing). Rebuild of pymo's viz_tools/features
(ref: scripts/pymo/viz_tools.py:12-110 draw_stickfigure{,3d};
scripts/pymo/features.py:12-43 foot-contact detection via peak finding).
Matplotlib figures; peakutils is replaced by scipy.signal.find_peaks.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from gesture2vec_tpu_torch.io.bvh import BVHData
from gesture2vec_tpu_torch.mocap.fk import _topo_order, forward_kinematics


def stickfigure_segments(data: BVHData, frame: int,
                         values: Optional[np.ndarray] = None
                         ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(parent_xyz, child_xyz), ...] line segments for one frame."""
    pos = forward_kinematics(data, values)
    segs = []
    for name in _topo_order(data):
        parent = data.skeleton[name].parent
        if parent is not None:
            segs.append((pos[parent][frame], pos[name][frame]))
    return segs


def draw_stickfigure(data: BVHData, frame: int, ax=None,
                     values: Optional[np.ndarray] = None, plane="xy"):
    """2D stick figure (ref: viz_tools.py:12-46). Returns the axis."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(4, 6))
    a, b = {"x": 0, "y": 1, "z": 2}[plane[0]], \
        {"x": 0, "y": 1, "z": 2}[plane[1]]
    for p, c in stickfigure_segments(data, frame, values):
        ax.plot([p[a], c[a]], [p[b], c[b]], "k-", lw=2)
        ax.plot([c[a]], [c[b]], "ro", ms=2)
    ax.set_aspect("equal")
    return ax


def draw_stickfigure3d(data: BVHData, frame: int, ax=None,
                       values: Optional[np.ndarray] = None):
    """3D stick figure (ref: viz_tools.py:49-110)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure(figsize=(5, 6))
        ax = fig.add_subplot(111, projection="3d")
    for p, c in stickfigure_segments(data, frame, values):
        ax.plot([p[0], c[0]], [p[2], c[2]], [p[1], c[1]], "k-", lw=2)
    return ax


def foot_contact_idxs(data: BVHData, foot_joint: str,
                      values: Optional[np.ndarray] = None,
                      up_axis: int = 1) -> np.ndarray:
    """Frames where the foot touches down: minima of the foot height
    signal (ref: features.py:12-33, peakutils on the negated signal)."""
    from scipy.signal import find_peaks

    pos = forward_kinematics(data, values)
    height = pos[foot_joint][:, up_axis]
    peaks, _ = find_peaks(-height, prominence=np.std(height) * 0.5)
    return peaks


def save_html_player(data: BVHData, path: str, title: str = "mocap",
                     values: Optional[np.ndarray] = None,
                     plane: str = "xy", max_frames: int = 2000) -> str:
    """Self-contained HTML stick-figure player - the notebook-free
    equivalent of pymo's nb_play_mocap (ref: viz_tools.py:190-233,
    which renders a JS canvas player inside Jupyter). Writes one .html
    with the FK joint positions embedded as JSON and a canvas animation
    with play/pause/scrub/speed controls; opens in any browser."""
    import json

    from gesture2vec_tpu_torch.mocap.fk import positions_matrix

    names = _topo_order(data)
    pos = positions_matrix(data, values)[:max_frames]  # (T, J, 3)
    a, b = {"x": 0, "y": 1, "z": 2}[plane[0]], \
        {"x": 0, "y": 1, "z": 2}[plane[1]]
    pts = np.stack([pos[:, :, a], pos[:, :, b]], axis=-1)  # (T, J, 2)
    idx = {n: i for i, n in enumerate(names)}
    bones = [[idx[data.skeleton[n].parent], idx[n]] for n in names
             if data.skeleton[n].parent is not None]
    payload = {"fps": float(data.framerate),
               "frames": np.round(pts, 3).tolist(), "bones": bones}
    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{font-family:sans-serif;margin:12px}}canvas{{border:1px solid #ccc}}</style>
</head><body>
<h3>{title}</h3>
<canvas id="c" width="480" height="560"></canvas><br>
<button id="play">pause</button>
<input id="seek" type="range" min="0" value="0" style="width:300px">
<select id="speed"><option>0.25</option><option>0.5</option>
<option selected>1</option><option>2</option></select>
<span id="info"></span>
<script>
const D = {json.dumps(payload)};
const cv = document.getElementById('c'), cx = cv.getContext('2d');
const seek = document.getElementById('seek');
seek.max = D.frames.length - 1;
let xs=[], ys=[];
for (const f of D.frames) for (const p of f) {{ xs.push(p[0]); ys.push(p[1]); }}
const x0=Math.min(...xs), x1=Math.max(...xs),
      y0=Math.min(...ys), y1=Math.max(...ys);
const s = Math.min(440/(x1-x0+1e-6), 520/(y1-y0+1e-6));
function draw(t) {{
  cx.clearRect(0,0,cv.width,cv.height);
  const f = D.frames[t];
  cx.strokeStyle='#222'; cx.lineWidth=2;
  for (const [p,c] of D.bones) {{
    cx.beginPath();
    cx.moveTo(20+(f[p][0]-x0)*s, cv.height-20-(f[p][1]-y0)*s);
    cx.lineTo(20+(f[c][0]-x0)*s, cv.height-20-(f[c][1]-y0)*s);
    cx.stroke();
  }}
  cx.fillStyle='#c00';
  for (const p of f) {{
    cx.beginPath();
    cx.arc(20+(p[0]-x0)*s, cv.height-20-(p[1]-y0)*s, 2.5, 0, 7);
    cx.fill();
  }}
  document.getElementById('info').textContent =
    `frame ${{t}}/${{D.frames.length-1}} @ ${{D.fps.toFixed(1)}} fps`;
}}
let t=0, acc=0, playing=true;
document.getElementById('play').onclick = function() {{
  playing = !playing; this.textContent = playing ? 'pause' : 'play';
}};
seek.oninput = () => {{ t = +seek.value; draw(t); }};
setInterval(() => {{
  if (!playing) return;
  acc += +document.getElementById('speed').value;
  const step = Math.floor(acc);
  if (step > 0) {{
    acc -= step;
    t = (t + step) % D.frames.length;
    seek.value = t; draw(t);
  }}
}}, 1000 / D.fps);
draw(0);
</script></body></html>"""
    with open(path, "w") as f:
        f.write(html)
    return path


def plot_loss_curves(history: dict, path: str, title: str = "loss") -> None:
    """Training loss plot artifact (ref: train_DAE.py:458-488)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    for key, vals in history.items():
        if vals and isinstance(vals[0], (int, float)):
            ax.plot(vals, label=key)
    ax.set_xlabel("epoch")
    ax.set_title(title)
    ax.legend()
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
