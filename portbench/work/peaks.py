"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity), at its full 700 W power limit. A card set below that
limit runs slower under load: every share is reported with the card's
power limit beside it (`power_limit_w`)."""
from __future__ import annotations

import subprocess
from typing import Optional

PEAK_BF16_FLOPS = 989e12     # tensor cores
PEAK_FP32_FLOPS = 67e12      # CUDA cores, outside the tensor cores
PEAK_BYTES_S = 3.35e12       # HBM3


def require_card() -> None:
    """A device share is measured on the card or not at all."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("a device share needs a CUDA card; a CPU run "
                           "gives no device metric")


def power_limit_w() -> Optional[float]:
    """The card's power limit from nvidia-smi, None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def bound_s(flops: float, nbytes: float,
            peak_flops: float = PEAK_FP32_FLOPS) -> float:
    """The least time for the work: operations at the peak against bytes
    (inputs read once, outputs written once) at the memory rate."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_S)
