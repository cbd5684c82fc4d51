"""Time one card against the rows split over every card of the host in
one process, the two row-wise paths a plain process's mesh would split:

    python3 scripts/plain_mesh_cards.py      # on a host with 2+ cards

`GestureGenerator.generate_batch` at chip_smoke.py's bench widths (random
weights, decode mode, two 60 s transcripts a card, and eight a card) and
the configs/VQ-VAE.yml tokenizer's corpus sweep (`tokenize_windows`,
2,048 windows a card, at batch 512 and 4,096). Each card holds a copy of
the generator or the tokenizer; the rows split into one equal chunk a
card, run either in turn from the calling thread or at once from one
thread a card, and concatenate. Tokens must equal the one-card call's.
Prints one JSON line per workload (seconds: best of 3 after a warm-up
call) and the cards' name and power limit. This is the measurement
behind `parallel/mesh`'s choice to run a plain process's rows whole.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def copies(obj, n: int):
    """obj on card 0 and a copy on each other card."""
    import torch

    out = [obj]
    for i in range(1, n):
        dev = torch.device("cuda", i)
        if isinstance(obj, torch.nn.Module):
            out.append(copy.deepcopy(obj).to(dev))
        else:
            t2t, seq, dae = copy.deepcopy(
                (obj.t2t_model, obj.seq_decoder, obj.dae_model))
            out.append(dataclasses.replace(obj, t2t_model=t2t,
                                           seq_decoder=seq, dae_model=dae,
                                           device=dev))
    return out


def split_run(call, reps: list, chunks: list, threaded: bool) -> list:
    """call(rep, chunk) for each card's copy and chunk, in turn or from a
    thread a card (each on its own card); the results in card order."""
    import torch

    outs = [None] * len(reps)

    def one(i: int) -> None:
        with torch.cuda.device(i):
            outs[i] = call(reps[i], chunks[i])

    if not threaded:
        for i in range(len(reps)):
            one(i)
        return outs
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reps))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if any(o is None for o in outs):
        raise RuntimeError("a card's chunk failed")
    return outs


def main() -> int:
    import torch

    import chip_smoke as cs
    from gesture2vec_tpu_torch.data.teacher import tokenize_windows
    from gesture2vec_tpu_torch.ops import build
    from gesture2vec_tpu_torch.train.dae_trainer import init_model
    from gesture2vec_tpu_torch.train.seq_ae_trainer import make_seq_ae

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"plain_mesh_cards: needs two or more cards, have {n}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    build.build_all()
    problems = []

    gen = cs.scale_generator()
    gens = copies(gen, n)
    for per_card in (2, 8):
        count = per_card * n
        tr = [cs.words(60.0, seed=i) for i in range(count)]
        du = [60.0] * count
        parts = [list(range(i * per_card, (i + 1) * per_card))
                 for i in range(n)]

        def gen_call(g, idx, tr=tr, du=du):
            return g.generate_batch([tr[j] for j in idx], [du[j] for j in idx])

        want = gen.generate_batch(tr, du)
        row = {"workload": "generate_batch", "cards": n,
               "transcripts": count, "request_s": 60.0,
               "one_card_s": cs.best_s(lambda: gen.generate_batch(tr, du))}
        for name, threaded in (("in_turn", False), ("thread_a_card", True)):
            got = sum(split_run(gen_call, gens, parts, threaded), [])
            flips = sum(int((a[1] != b[1]).sum()) for a, b in zip(got, want))
            row[f"{name}_s"] = cs.best_s(
                lambda: split_run(gen_call, gens, parts, threaded))
            row[f"{name}_token_flips"] = flips
            if flips:
                problems.append(f"generate_batch {name}: {flips} flips")
        print(json.dumps(row), flush=True)

    cfg = cs.scale_config("VQ-VAE.yml")
    seq = init_model(make_seq_ae(cfg), max(cfg.random_seed, 0),
                     torch.device("cuda")).eval()
    seqs = copies(seq, n)
    wins = cs.scale_windows(2048 * n, 44)
    chunks = np.split(wins, n)
    for batch in (512, 4096):
        def sweep_call(model, chunk, batch=batch):
            return tokenize_windows(model, chunk, batch=batch)[0]

        want = tokenize_windows(seq, wins, batch=batch)[0]
        row = {"workload": "tokenize_windows", "cards": n,
               "windows": len(wins), "batch": batch,
               "one_card_s": cs.best_s(
                   lambda: tokenize_windows(seq, wins, batch=batch))}
        for name, threaded in (("in_turn", False), ("thread_a_card", True)):
            got = np.concatenate(split_run(sweep_call, seqs, chunks,
                                           threaded))
            flips = int((got != want).sum())
            row[f"{name}_s"] = cs.best_s(
                lambda: split_run(sweep_call, seqs, chunks, threaded))
            row[f"{name}_token_flips"] = flips
            if flips:
                problems.append(f"tokenize_windows {name}: {flips} flips")
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    if problems:
        print(f"plain_mesh_cards: {problems}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
