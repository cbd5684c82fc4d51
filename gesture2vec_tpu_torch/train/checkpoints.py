"""Checkpoints of the port's trainers, in the JAX package's file format.

A checkpoint is the msgpack tree the JAX package's
`train/checkpoints.save_checkpoint` writes, through `utils/mpack.packb`
(byte-compatible with flax's msgpack):
    {"args": <config dict with "extras">, "epoch": int, "pose_dim": int,
     "lang_model": <vocab state or None>, "kind": str,
     "params": <the JAX-layout params tree>,
     "extra": {"batch_stats": ..., <the part's fields>,
               "opt_state": <optax's state dict>, "torch_generator": ...}}
so the JAX package's `load_checkpoint_and_model` loads it and the port's
`compat/checkpoint` and `cli/_common.build_generator` do too. The
optimizer state is optax's chain(clip_by_global_norm, adam) state dict,
{"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {}}}, with mu and nu in
the params' layout. The dropout stream is the port's torch.Generator
state ("torch_generator", bytes as uint8; a run resumed on another kind
of device restarts it from the seed); the JAX package keeps its
PRNG key under "rng", which the port does not read (a JAX-written
checkpoint resumes with a fresh generator), and the JAX package ignores
"torch_generator".
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from gesture2vec_tpu_torch.compat import checkpoint as compat_checkpoint
from gesture2vec_tpu_torch.compat.from_jax import (
    from_jax_layout, jax_tree, load_jax_variables, param_entries)
from gesture2vec_tpu_torch.train.config import Config, load_config
from gesture2vec_tpu_torch.train.optim import Adam
from gesture2vec_tpu_torch.utils import mpack


def _to_serializable(tree):
    if isinstance(tree, dict):
        return {k: _to_serializable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_serializable(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "dtype"):
        return np.asarray(tree)
    return tree


def opt_state_dict(model: torch.nn.Module, opt: Adam) -> Dict[str, Any]:
    """optax's state dict of chain(clip_by_global_norm, adam)."""
    entries = param_entries(model)
    index = {id(p): i for i, p in enumerate(opt.params)}
    mu = jax_tree(entries, {id(p): opt.mu[index[id(p)]]
                            for _, p, _, _ in entries})
    nu = jax_tree(entries, {id(p): opt.nu[index[id(p)]]
                            for _, p, _, _ in entries})
    return {"0": {}, "1": {"0": {"count": np.asarray(opt.count, np.int32),
                                 "mu": mu, "nu": nu}, "1": {}}}


@torch.no_grad()
def load_opt_state_dict(model: torch.nn.Module, opt: Adam,
                        state: Dict[str, Any]) -> None:
    adam = state["1"]["0"]
    index = {id(p): i for i, p in enumerate(opt.params)}
    for path, p, layout, _ in param_entries(model):
        i = index[id(p)]
        for dst, tree in ((opt.mu, adam["mu"]), (opt.nu, adam["nu"])):
            for k in path:
                tree = tree[k]
            dst[i].copy_(from_jax_layout(tree, layout).to(dst[i].device))
    opt.count = int(np.asarray(adam["count"]))


def resume_extra(model: torch.nn.Module, opt: Adam,
                 generator: torch.Generator,
                 config: Config) -> Dict[str, Any]:
    """The exact-resume payload: the optimizer state and the dropout
    generator's state. Empty when config.save_optimizer is off."""
    if not config.save_optimizer:
        return {}
    return {"opt_state": opt_state_dict(model, opt),
            "torch_generator": generator.get_state().numpy().copy()}


def restore_for_resume(model: torch.nn.Module, opt: Adam,
                       generator: torch.Generator, path: str
                       ) -> Tuple[int, Dict[str, Any]]:
    """Load a checkpoint (the port's or the JAX package's) into the
    model, the optimizer state and the generator where it carries them;
    returns (the epoch to start from, the payload)."""
    payload = load_checkpoint(path)
    extra = payload["extra"]
    load_jax_variables(model, payload["params"], extra.get("batch_stats"))
    if extra.get("opt_state") is not None:
        load_opt_state_dict(model, opt, extra["opt_state"])
    saved = extra.get("torch_generator")
    if saved is not None:
        state = torch.from_numpy(np.array(saved, dtype=np.uint8))
        if state.numel() == generator.get_state().numel():
            generator.set_state(state)
        else:
            # a CPU generator's state does not fit a CUDA one's
            logging.warning("%s holds the dropout stream of another "
                            "device: it restarts from the seed", path)
    start_epoch = int(payload["epoch"])
    logging.info("resumed from %s at epoch %d", path, start_epoch)
    return start_epoch, payload


def save_checkpoint(path: str, *, config: Config, epoch: int, params: Any,
                    pose_dim: int = 0, lang_model: Optional[dict] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    kind: str = "") -> None:
    """Write the payload (see the module note). Overwriting a checkpoint
    of another kind warns: two parts share a config name and save dir."""
    if kind and os.path.exists(path):
        try:
            old_kind = load_checkpoint(path).get("kind", "")
        except Exception:
            old_kind = ""
        if old_kind and old_kind != kind:
            logging.warning(
                "overwriting %s: existing checkpoint is kind=%r, new one "
                "is kind=%r - are two pipeline parts sharing a config "
                "name/save dir? Use distinct names or --save-dir.", path,
                old_kind, kind)
    payload = {"args": _to_serializable(config.to_dict()),
               "epoch": int(epoch), "pose_dim": int(pose_dim),
               "lang_model": _to_serializable(lang_model), "kind": kind,
               "params": _to_serializable(params),
               "extra": _to_serializable(extra or {})}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(mpack.packb(payload))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload, with payload["config"] the run's Config."""
    payload = compat_checkpoint.load_checkpoint(path)
    payload["config"] = load_config(payload["config"])
    return payload


def checkpoint_filename(save_dir: str, name: str,
                        epoch: "int | str") -> str:
    """"{name}_checkpoint_{epoch:03d}.bin", or a tagged one ("best")."""
    tag = f"{epoch:03d}" if isinstance(epoch, int) else str(epoch)
    return os.path.join(save_dir, f"{name}_checkpoint_{tag}.bin")
