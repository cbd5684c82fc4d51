"""BVH motion-capture file parser and writer.

The port's copy of the JAX package's `io/bvh.py`, on numpy alone: the
motion block is decoded by numpy's float parser and written by one
"%.6f" row format, where the JAX package may take its native C++
helpers. Both give the same values and the same text, so a file (or a
`data_pipe.json`, which holds BVH text) written by either package reads
identically through the other.

The hierarchy is parsed with a simple token cursor and the motion block
is bulk-decoded, keeping the whole motion as one contiguous (frames,
channels) float array (the reference's pymo layer builds a pandas
DataFrame row by row, ref: scripts/pymo/parsers.py:53-260,
scripts/pymo/writers.py:4-70, scripts/pymo/data.py:3-53).

Conventions kept compatible with the reference:
  - End sites are stored as joints named "<parent>_Nub" with no channels.
  - channel order string ("ZXY" etc.) records the rotation channel order.
  - values array columns follow hierarchy (depth-first) channel order,
    column names are "<joint>_<channel>".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Joint:
    """One node of the skeleton tree."""

    parent: Optional[str]
    offsets: np.ndarray  # (3,)
    channels: List[str]
    order: str  # rotation channel order, e.g. "ZXY" ("" for end sites)
    children: List[str]


@dataclasses.dataclass
class BVHData:
    """A parsed BVH file: skeleton tree + motion channel matrix.

    Equivalent of pymo's MocapData (ref: scripts/pymo/data.py:9) with the
    per-frame values held as a single numpy array instead of a DataFrame.
    """

    skeleton: Dict[str, Joint]
    root_name: str
    frame_time: float
    channel_names: List[Tuple[str, str]]  # (joint, channel) per column
    values: np.ndarray  # (frames, channels) float32

    @property
    def framerate(self) -> float:
        return 1.0 / self.frame_time

    @property
    def n_frames(self) -> int:
        return int(self.values.shape[0])

    def column_names(self) -> List[str]:
        return [f"{j}_{c}" for j, c in self.channel_names]

    def column_index(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.column_names())}

    def clone(self) -> "BVHData":
        return BVHData(
            skeleton={
                k: Joint(v.parent, v.offsets.copy(), list(v.channels), v.order,
                         list(v.children))
                for k, v in self.skeleton.items()
            },
            root_name=self.root_name,
            frame_time=self.frame_time,
            channel_names=list(self.channel_names),
            values=self.values.copy(),
        )


class _Cursor:
    __slots__ = ("toks", "i")

    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0

    def next(self) -> str:
        t = self.toks[self.i]
        self.i += 1
        return t

    def peek(self) -> str:
        return self.toks[self.i]

    def expect(self, want: str) -> None:
        got = self.next()
        if got != want:
            raise ValueError(f"BVH parse error: expected {want!r}, got {got!r}")


def _parse_joint_block(cur: _Cursor, name: str, parent: Optional[str],
                       skeleton: Dict[str, Joint],
                       channel_names: List[Tuple[str, str]]) -> None:
    cur.expect("{")
    cur.expect("OFFSET")
    offsets = np.array([float(cur.next()) for _ in range(3)], dtype=np.float64)
    channels: List[str] = []
    order = ""
    if cur.peek() == "CHANNELS":
        cur.next()
        n = int(cur.next())
        for _ in range(n):
            ch = cur.next()
            channels.append(ch)
            if ch in ("Xrotation", "Yrotation", "Zrotation"):
                order += ch[0]
        for ch in channels:
            channel_names.append((name, ch))
    skeleton[name] = Joint(parent=parent, offsets=offsets, channels=channels,
                           order=order, children=[])
    if parent is not None:
        skeleton[parent].children.append(name)

    while True:
        t = cur.peek()
        if t == "JOINT":
            cur.next()
            child = cur.next()
            _parse_joint_block(cur, child, name, skeleton, channel_names)
        elif t == "End":
            cur.next()
            cur.next()  # "Site"
            cur.expect("{")
            cur.expect("OFFSET")
            off = np.array([float(cur.next()) for _ in range(3)],
                           dtype=np.float64)
            nub = name + "_Nub"
            skeleton[nub] = Joint(parent=name, offsets=off, channels=[],
                                  order="", children=[])
            skeleton[name].children.append(nub)
            cur.expect("}")
        elif t == "}":
            cur.next()
            return
        else:
            raise ValueError(f"BVH parse error: unexpected token {t!r}")


def parse_bvh(path_or_text: str, from_text: bool = False,
              dtype=np.float64) -> BVHData:
    """Parse a BVH file (or raw text with from_text=True).

    Returns a BVHData whose `values` matrix is (frames, channels), with
    columns in depth-first hierarchy channel order - identical column
    semantics to the reference parser (ref: scripts/pymo/parsers.py:94-103).
    """
    if from_text:
        text = path_or_text
    else:
        with open(path_or_text, "r") as f:
            text = f.read()

    midx = text.find("MOTION")
    if midx < 0:
        raise ValueError("BVH parse error: no MOTION section")
    header, motion = text[:midx], text[midx:]

    toks = header.split()
    cur = _Cursor(toks)
    cur.expect("HIERARCHY")
    cur.expect("ROOT")
    root_name = cur.next()
    skeleton: Dict[str, Joint] = {}
    channel_names: List[Tuple[str, str]] = []
    _parse_joint_block(cur, root_name, None, skeleton, channel_names)

    # MOTION section: bulk-decode all floats at once.
    lines = motion.splitlines()
    n_frames = None
    frame_time = None
    data_start = 0
    for li, line in enumerate(lines):
        s = line.strip()
        if s.startswith("Frames"):
            n_frames = int(s.split(":", 1)[1])
        elif s.startswith("Frame") and "Time" in s:
            frame_time = float(s.split(":", 1)[1])
            data_start = li + 1
            break
    if n_frames is None or frame_time is None:
        raise ValueError("BVH parse error: malformed MOTION header")

    motion_text = "\n".join(lines[data_start:])
    flat = np.array(motion_text.split(), dtype=dtype)
    n_ch = len(channel_names)
    if flat.size < n_frames * n_ch:
        n_frames = flat.size // n_ch  # tolerate truncated files
    values = flat[: n_frames * n_ch].reshape(n_frames, n_ch)

    return BVHData(skeleton=skeleton, root_name=root_name,
                   frame_time=frame_time, channel_names=channel_names,
                   values=values, )


def _write_joint(data: BVHData, name: str, depth: int, out: List[str],
                 motion_cols: List[int], col_index: Dict[str, int]) -> None:
    j = data.skeleton[name]
    tab = "\t" * depth
    if j.parent is None:
        out.append(f"ROOT {name}\n")
    elif j.children:
        out.append(f"{tab}JOINT {name}\n")
    else:
        out.append(f"{tab}End Site\n")
    out.append(f"{tab}{{\n")
    o = j.offsets
    out.append(f"{tab}\tOFFSET {o[0]:.5f} {o[1]:.5f} {o[2]:.5f}\n")
    if j.children:
        pos = [c for c in j.channels if "position" in c]
        rot = [f"{ax}rotation" for ax in j.order]
        chans = pos + rot
        if chans:
            out.append(f"{tab}\tCHANNELS {len(chans)} {' '.join(chans)}\n")
            for c in chans:
                motion_cols.append(col_index[f"{name}_{c}"])
        for c in j.children:
            _write_joint(data, c, depth + 1, out, motion_cols, col_index)
    out.append(f"{tab}}}\n")


def format_motion(mat: np.ndarray) -> str:
    """(rows, cols) float64 -> the BVH motion block: each value as
    "%.6f" (Python's formatting, the same text as f"{v:.6f}", -0.0 and
    half-way values included), space-separated, a newline after each
    row. One format string per row keeps the ~2.5M values of a
    30-minute clip out of a per-value Python loop."""
    if not mat.size:
        return "\n"
    row = " ".join(["%.6f"] * mat.shape[1])
    return "\n".join([row % tuple(r) for r in mat.tolist()]) + "\n"


def write_bvh(data: BVHData, path: Optional[str] = None,
              framerate: float = -1.0) -> Optional[str]:
    """Serialize BVHData back to BVH text (ref: scripts/pymo/writers.py:8-70).

    Channel columns are emitted in position-then-rotation(order) sequence
    per joint, matching the reference writer. Returns the text when path
    is None, else writes the file.
    """
    out: List[str] = ["HIERARCHY\n"]
    motion_cols: List[int] = []
    _write_joint(data, data.root_name, 0, out, motion_cols,
                 data.column_index())
    out.append("MOTION\n")
    out.append(f"Frames: {data.values.shape[0]}\n")
    ft = 1.0 / framerate if framerate > 0 else data.frame_time
    out.append(f"Frame Time: {ft:f}\n")

    mat = np.asarray(data.values, dtype=np.float64)[:, motion_cols]
    out.append(format_motion(mat))
    text = "".join(out)
    if path is None:
        return text
    import os
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return None
