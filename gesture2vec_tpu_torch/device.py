"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    something else (the tests pass "cpu"). Raises when CUDA is asked for
    and no card is present - there is no silent CPU fallback.

    On CUDA, TF32 is switched off for both matmuls and cuDNN
    convolutions: token ids come from argmaxes over fp32 logits, and
    cuDNN's TF32 (on by default) would run the TCN's conv1d with ~3
    decimal digits (the fp32 token contract of DESIGN.md)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gesture2vec_tpu_torch needs a CUDA device; pass "
                "device='cpu' to run the plain PyTorch path instead")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def module_device(model: torch.nn.Module) -> torch.device:
    """The device a model's parameters live on."""
    return next(model.parameters()).device
