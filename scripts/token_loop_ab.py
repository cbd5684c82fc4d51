"""Time the greedy decode path's token loop of several trees of this repo
against each other on one card, in alternation:

    python3 scripts/token_loop_ab.py TREE [TREE ...] [--rounds 2]
        [--arch gru|transformer]

A TREE is the root of a checkout of the repo (`.` for this one). Each
round runs every tree once in the order given and then once in reverse
(A B B A for two trees), each run a process of its own with that tree
first on sys.path, so host-clock drift within the call falls on every
tree alike. A run builds chip_smoke.py's decode-path generator (the bench
widths, random weights from seed 0; `--arch transformer`: the recommended
recipe's, chip_smoke.recipe_trees, the transformer Part d with 4 chained
stages, in trees that have it) and times, best of REPS synchronised
calls, the 6 s and 60 s requests:
  tokens   the text encoder and the greedy token decode of every window
           (the tree's `_predict_windows`, or `_predict_tokens` where it
           has that instead);
  request  `generate`, as a user calls it.
It prints one JSON line per run, then one with each tree's median over
its runs, and the card's name and power limit (nvidia-smi).
`--device cpu` runs the same on the CPU (a dry run: no times to keep).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REQUESTS_S = (6.0, 60.0)
REPS = 7


def child(device: str, arch: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
    from gesture2vec_tpu_torch.text.vocab import Vocab

    def best_s(fn) -> float:
        best = float("inf")
        for _ in range(REPS):
            if device == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            if device == "cuda":
                torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best

    vocab = Vocab("bench")
    for i in range(cs.VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    rng = np.random.default_rng(0)
    if arch == "transformer":
        trees = cs.recipe_trees(rng)
        recipe = dict(t2t_n_pre_poses=cs.RECIPE_N_PRE,
                      t2t_heads=cs.RECIPE_HEADS)
    else:
        trees, recipe = cs.jax_layout_trees(rng), {}
    gen = generator_from_jax(
        *trees, vocab, np.zeros(cs.DIM, np.float32),
        np.ones(cs.DIM, np.float32), n_frames=cs.N_FRAMES,
        sentence_frame_length=cs.SENT_LEN, fps=cs.FPS, max_words=cs.MAXW,
        device=device, mode="decode", use_fused_decoder=True, **recipe)
    out = {}
    for d in REQUESTS_S:
        w = cs.words(d)
        gen.generate(w, d)                  # warm-up (and the kernel build)
        ids, lens, _ = gen.window_inputs(w, d)
        with torch.inference_mode():
            if hasattr(gen, "_predict_windows"):
                tokens_s = best_s(lambda: gen._predict_windows(ids[None],
                                                               lens[None]))
            else:
                tokens_s = best_s(lambda: gen._predict_tokens(ids, lens))
        out[str(d)] = {"tokens_s": tokens_s,
                       "request_s": best_s(lambda: gen.generate(w, d))}
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="gru", choices=["gru", "transformer"],
                    help="the Part d timed (transformer: the recipe's)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.device, args.arch)
        return 0
    trees = [os.path.abspath(t) for t in args.trees]
    order = (trees + trees[::-1]) * args.rounds
    runs = {t: [] for t in trees}
    for tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--child",
             "--device", args.device, "--arch", args.arch], cwd=tree,
            capture_output=True,
            text=True, env={**os.environ, "PYTHONPATH": tree}, timeout=600)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(res)
        print(json.dumps({"tree": tree, **res}), flush=True)
    print(json.dumps({"median": {tree: {
        d: {k: statistics.median(r[d][k] for r in rs)
            for k in ("tokens_s", "request_s")}
        for d in rs[0]} for tree, rs in runs.items()}}), flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
