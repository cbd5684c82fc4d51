#!/usr/bin/env python3
"""Readings for setting a cell's limits: the program's and the
control's, seed by seed, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ...

For each seed one run of the cell with the shortest window (one unit of
work), judged against the reference, and the control (the reference one
precision below the configuration's, TF32 for float32, put in the
program's place at the same prompts and tokens) judged the same way.
Prints one JSON line a seed: {"seed", "program": {...}, "control":
{...}}. `--fault half_batch|token|frozen` plants one fault in the program and
reads what each number says of it (no control then). Not run by the
benchmark; its readings set the limits in the cell's workload file.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _half_batch():
    """The Part-b step's loss over the first half of its batch."""
    from gesture2vec_tpu_torch.train import seq_ae_trainer

    loss = seq_ae_trainer.TrainStep.loss

    def half(self, batch, epoch=0.0):
        return loss(self, batch[: batch.shape[0] // 2], epoch)

    seq_ae_trainer.TrainStep.loss = half


def _token():
    """One token of every decoded window batch changed where it is
    chosen."""
    from gesture2vec_tpu_torch.models import text2token

    cls = text2token.Text2Token
    decode = cls.decode_tokens

    def altered(self, *args, **kwargs):
        res = decode(self, *args, **kwargs)
        res["tokens"][0, -1] = (res["tokens"][0, -1] + 1) % self.n_tokens
        return res

    cls.decode_tokens = altered


def _frozen():
    """A step that leaves its state unchanged: Adam's update does
    nothing."""
    from gesture2vec_tpu_torch.train import optim

    optim.Adam.step = lambda self: None


# faults planted in the program, to read what each number says of them
FAULTS = {"half_batch": _half_batch, "token": _token, "frozen": _frozen}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None,
                    help="plant one fault in the program and read it")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as bench_run
    from portbench.harness import registry

    bench_run.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: the readings are the card's; no CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workload = registry.workload(args.workload)
    config = registry.config(workload["config"])
    driver = registry.driver(workload["driver"])
    if args.fault:
        FAULTS[args.fault]()
    for seed in args.seeds:
        ctx = bench_run.Context(args.workload, workload, config, seed,
                                0.0, False, t0=time.perf_counter(),
                                control=not args.fault)
        out = driver.run(ctx)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "program": out["readings"],
                          "control": out["control_readings"]}), flush=True)
        ctx.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
