"""Weights made from a seed on the device, in a few large calls.

A spec is a list of (name, shape, init); init is ("uniform", lo, hi),
("normal", mean, std) or ("const", value). `make` draws one uniform and
one normal block on the device for the whole spec and cuts every tensor
out of them, so set-up pays two random calls whatever the number of
tensors. The same seed gives the same tensors, so the program and the
reference each take their own copy of one set of weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

Init = Tuple
Spec = List[Tuple[str, Tuple[int, ...], Init]]


def uniform(bound: float) -> Init:
    return ("uniform", -bound, bound)


def fan_in(n: int) -> Init:
    """U(+-1/sqrt(n)), torch's and flax's layer initialisation."""
    return uniform(1.0 / math.sqrt(n))


def normal(std: float, mean: float = 0.0) -> Init:
    return ("normal", mean, std)


def const(value: float) -> Init:
    return ("const", value)


def make(spec: Spec, seed: int, device) -> Dict[str, "object"]:
    """{name: tensor} for the spec, fp32 (a const of shape () is the int64
    count a BatchNorm keeps)."""
    import torch

    sizes = [math.prod(shape) for _, shape, _ in spec]
    total = sum(sizes)
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=g, device=device)
    n = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for (name, shape, init), size in zip(spec, sizes):
        kind = init[0]
        if kind == "uniform":
            t = u[at:at + size] * (init[2] - init[1]) + init[1]
        elif kind == "normal":
            t = n[at:at + size] * init[2] + init[1]
        elif kind == "const" and shape == ():
            t = torch.full((), int(init[1]), dtype=torch.long, device=device)
        elif kind == "const":
            t = torch.full((size,), float(init[1]), device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
        out[name] = t.reshape(shape).clone()
        at += size
    return out


def group(weights: Dict[str, object], prefix: str) -> Dict[str, object]:
    """The tensors under `prefix.`, with the prefix taken off."""
    cut = len(prefix) + 1
    return {k[cut:]: v for k, v in weights.items()
            if k.startswith(prefix + ".")}
