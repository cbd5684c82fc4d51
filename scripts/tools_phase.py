"""chip_smoke.py's tools phase alone on the card, over what it reads: the
train path (its store, checkpoints and steps/s) and the misc train path
(its baseline and c2g checkpoints), then `chip_smoke.tools_path`. Each
phase prints its JSON lines as in chip_smoke.py; the last line gives
each phase's seconds.

    python3 scripts/tools_phase.py
"""
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools_phase: no CUDA device; the phase runs on the card")
    from gesture2vec_tpu_torch.ops import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    secs = {}
    t0 = time.perf_counter()
    build.build_all()
    secs["build_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        done = {}
        for name, phase in (("train_s", lambda: c.train_path(smi, tmp, done)),
                            ("misc_train_s",
                             lambda: c.misc_train_path(smi, done)),
                            ("tools_s", lambda: c.tools_path(smi, done))):
            t0 = time.perf_counter()
            phase()
            secs[name] = time.perf_counter() - t0
    c.emit({"phase": "paths", **secs, "card": smi})


if __name__ == "__main__":
    main()
