"""Rank functions of the port's mesh tests.

`parallel/launch.run` pickles a rank function by its module and name,
so the functions the tests run on their gloo ranks live here, at module
level, and not inside a test.
"""
import contextlib
import sys
from typing import Dict

import numpy as np
import torch


def _no_dropout(x, rate, training, batch_dim=0):
    return x


def _no_noise(like):
    return torch.zeros_like(like)


@contextlib.contextmanager
def dropout_patched_off():
    """Inside: the port's dropout the identity and its VAE noise zero, in
    every module of the package that holds them (the JAX side of such a
    comparison patches flax's Dropout to the identity); a module first
    imported inside gets the originals back on the way out too."""
    from gesture2vec_tpu_torch.models import layers

    patched = {"dropout": _no_dropout, "reparam_noise": _no_noise}
    original = {name: getattr(layers, name) for name in patched}

    def swap(old: Dict, new: Dict) -> None:
        for name, mod in list(sys.modules.items()):
            if name.startswith("gesture2vec_tpu_torch") and mod is not None:
                for attr in patched:
                    if getattr(mod, attr, None) is old[attr]:
                        setattr(mod, attr, new[attr])

    swap(original, patched)
    try:
        yield
    finally:
        swap(patched, original)


def call_without_dropout(fn, *args, **kwargs):
    """fn(*args, **kwargs) inside `dropout_patched_off` (a meshed run held
    against a JAX run with its dropout patched off)."""
    with dropout_patched_off():
        return fn(*args, **kwargs)


def vq_ema_on_ranks(x: torch.Tensor, state, mesh_shape: Dict[str, int]):
    """One train-mode `models/vq.vq_ema` step on this rank's rows of x
    with the EMA statistics summed over the mesh's dp axis (its
    axis_name); returns the new state."""
    from gesture2vec_tpu_torch.models.vq import vq_ema
    from gesture2vec_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(mesh_shape, "cpu")
    _, new = vq_ema(mesh.rows(x), state, train=True, axis_name=mesh)
    return new


def sweep_on_ranks(dae_model, seq_model, windows: np.ndarray,
                   mesh_shape: Dict[str, int], batch: int = 16):
    """The corpus sweeps over a mesh of the running ranks: (DAE latents,
    tokens, sequence latents) of `data/teacher`'s encode_windows_with_dae
    and tokenize_windows."""
    from gesture2vec_tpu_torch.data.teacher import (encode_windows_with_dae,
                                                    tokenize_windows)
    from gesture2vec_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(mesh_shape, "cpu")
    lat = encode_windows_with_dae(dae_model, windows, batch=batch,
                                  mesh=mesh)
    toks, seq_lat = tokenize_windows(seq_model, lat, batch=batch, mesh=mesh)
    return lat, toks, seq_lat


def generate_on_ranks(generator, transcripts, durations_s,
                      mesh_shape: Dict[str, int]):
    """`GestureGenerator.generate_batch` over a mesh of the running
    ranks."""
    from gesture2vec_tpu_torch.parallel.mesh import make_mesh
    return generator.generate_batch(transcripts, durations_s,
                                    mesh=make_mesh(mesh_shape, "cpu"))
