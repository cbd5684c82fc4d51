"""Time chip_smoke.py's decode-policies and recommended-recipe paths of
several trees of this repo on one card, in alternation:

    python3 scripts/smoke_paths_ab.py TREE [TREE ...]

A TREE is the root of a checkout of the repo (`.` for this one). The
trees run in the order given and then in reverse (A B B A for two), each
run a process of its own from that tree's root, so host-clock drift
within the call falls on every tree alike. A run builds the tree's
kernels, then times its `chip_smoke.policies_path` and
`chip_smoke.recipe_path` (the recipe's exemplar request over a synthetic
4,096-window bank from seed 1, in place of Part c's), each with all of
its own checks, and prints one JSON line ("tree", "policies_s",
"recipe_s", the card's name and power limit). It needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def run_here(tag: str) -> None:
    import numpy as np

    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from gesture2vec_tpu_torch.ops import build

    build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rng = np.random.default_rng(1)
    bank = {"dae_latents": rng.normal(size=(4096, 20, 40)).astype(
        np.float32), "tokens": rng.integers(0, 512, 4096).astype(np.int32)}
    t0 = time.perf_counter()
    c.policies_path(smi)
    t1 = time.perf_counter()
    c.recipe_path(smi, bank)
    t2 = time.perf_counter()
    print(json.dumps({"tree": tag, "policies_s": t1 - t0,
                      "recipe_s": t2 - t1, "card": smi}), flush=True)


def main(trees) -> int:
    here = os.path.abspath(__file__)
    lines = []
    for tree in list(trees) + list(reversed(trees)):
        out = subprocess.run(
            [sys.executable, here, "--run", tree], cwd=tree,
            capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            return out.returncode
        lines.append(out.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        run_here(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
