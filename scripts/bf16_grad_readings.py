"""Rerun the bf16 gradient checks of tests/test_torch_port_train_bf16.py
and tests/test_torch_port_train_bf16_more.py over a range of input seeds
and print, for each check and seed, how far the port's bf16 gradients lie
from JAX's fp32 ones against how far JAX's bf16 gradients lie:

    JAX_PLATFORMS=cpu python scripts/bf16_grad_readings.py [--seeds 8]
        [--only form_layer,step_d_gru,...] [--out readings.jsonl]

Seed s moves each check's input seed by 100 * s (s = 0 is the test as
committed). For every tensor it records ||g_port - g32||, ||g_jax - g32||
and ||g_port - g_jax|| over the tensor's own fp32 norm (the cancelled
tensors: over the tree's largest norm), and prints per check and seed
`need`: the smallest c with ||g_port - g32|| <= c ||g_jax - g32|| + 2^-6
||g32|| for every tensor, and the tree-level errors e (port) and j (JAX)
over the whole gradient. The checks run on the CPU, flax's Dropout
patched to the identity, torch on one thread.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FWD_TOL = 2.0 ** -6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--only", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import flax.linen as fnn
    import torch

    import tests.test_torch_port_train as tt
    import tests.test_torch_port_train_audio as ta
    import tests.test_torch_port_train_bf16 as tb
    import tests.test_torch_port_train_bf16_more as tm

    fnn.Dropout.__call__ = lambda self, inputs, *a, **k: inputs
    torch.set_num_threads(1)
    seen: list = []

    def recorder(got, want, want32, what, cancelled=tb._cancelled,
                 factor=None):
        g, w, w32 = (dict(tt._leaves(t)) for t in (got, want, want32))
        top = max(float(np.linalg.norm(v)) for v in w32.values())
        rows = []
        for path, exact in w32.items():
            scale = top if cancelled(path) else float(np.linalg.norm(exact))
            if scale == 0.0:
                continue
            rows.append(("/".join(path), float(np.linalg.norm(exact)),
                         float(np.linalg.norm(g[path] - exact)) / scale,
                         float(np.linalg.norm(w[path] - exact)) / scale,
                         float(np.linalg.norm(g[path] - w[path])) / scale,
                         bool(cancelled(path))))
        seen.append(rows)

    tb._grads_close = tm._grads_close = recorder
    orig_batches, orig_inputs, orig_audio = tt._batches, tb._gru_inputs, \
        ta._batch
    checks = {f"form_{f}": (lambda f=f: tb.test_gru_forms_match_jax(f))
              for f in tb.FORMS if f != "cell"}
    checks.update({f"step_{p}": (lambda p=p: tb.test_train_step_matches_jax(
        p, None)) for p in tb.STEP_PARTS})
    checks["feedback"] = lambda: tm.test_feedback_step_matches_jax(None)
    checks["audio"] = lambda: tm.test_audio2token_step_matches_jax(None)
    only = [c for c in args.only.split(",") if c]
    out = open(args.out, "a") if args.out else None
    for name, run in checks.items():
        if only and name not in only:
            continue
        for s in range(args.seeds):
            off = 100 * s
            tb._batches = tm._batches = \
                lambda p, r, seed, n, off=off: orig_batches(p, r, seed + off,
                                                            n)
            tb._gru_inputs = lambda seed, off=off: orig_inputs(seed + off)
            ta._batch = lambda f, n, seed, off=off: orig_audio(f, n,
                                                               seed + off)
            seen.clear()
            try:
                run()
                status = "ok"
            except AssertionError as e:  # a forward check of the test
                status = f"assert: {str(e)[:120]}"
            rows = seen[-1] if seen else []
            need = max(((e - FWD_TOL) / j if j > 0 else
                        (0.0 if e <= FWD_TOL else math.inf), p)
                       for p, _, e, j, _, _ in rows) if rows else (None, "")
            tree = [r for r in rows if not r[5]]
            own2 = sum(r[1] ** 2 for r in tree)
            e_t = math.sqrt(sum((r[2] * r[1]) ** 2 for r in tree) / own2)
            j_t = math.sqrt(sum((r[3] * r[1]) ** 2 for r in tree) / own2)
            rec = {"check": name, "seed": s, "status": status,
                   "need": need[0], "need_tensor": need[1],
                   "tree_err_port": e_t, "tree_err_jax": j_t}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps({**rec, "rows": rows}) + "\n")


if __name__ == "__main__":
    main()
