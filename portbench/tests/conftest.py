"""Shared set-up of the benchmark's tests: the repository root on the
path, and the cells' runs at widths a CPU test holds."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# widths of the CPU tests: every mechanism of the cells, at a size the
# test run holds
SMALL_GEN = dict(hidden_size=16, codes=32, n_words=60, wordembed_dim=12,
                 pose_dim=9, dae_latent=4, max_words=8)
SMALL_GEN_TRAFFIC = dict(transcripts=3, min_s=6.0, max_s=20.0,
                         distinct_batches=2)
SMALL_TRAIN = dict(hidden_size=16, codes=32, dae_latent=4, batch_size=8,
                   n_poses=6)
SMALL_TRAIN_TRAFFIC = dict(windows=64)


def small_run(cell: str, seed: int = 12345678901, seconds: float = 0.2,
              control: bool = False, device: str = "cpu"):
    """(context, driver output) of one run of the cell at the CPU tests'
    widths, or at the cell's own on the card (device="cuda")."""
    from portbench import run as bench_run
    from portbench.harness import registry

    workload = registry.workload(cell)
    config = registry.config(workload["config"])
    if device == "cpu":
        train = workload["driver"] == "train_step"
        config.update(SMALL_TRAIN if train else SMALL_GEN)
        workload["traffic"].update(SMALL_TRAIN_TRAFFIC if train
                                   else SMALL_GEN_TRAFFIC)
    ctx = bench_run.Context(cell, workload, config, seed, seconds, False,
                            device=device, t0=time.perf_counter(),
                            control=control)
    return ctx, registry.driver(workload["driver"]).run(ctx)


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control reads TF32, which only "
                    "the card computes")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"
