"""Trainers of the baseline text -> pose regressor and the cluster ->
gesture decoder.

Port of the JAX package's `train/misc_trainers.py`: the loss is
custom_loss (the config's l1, continuity and variance weights) of a
train-mode forward against the targets, with Adam(0.5, 0.999) after
global-norm clipping at 5; each epoch's batches are
np.random.default_rng(seed + epoch).permutation(n), full batches only;
validation sweeps the full validation batches in eval mode; the history
is train_loss / val_loss per epoch (and the first step's loss,
first_step_loss); the checkpoint is written at the last epoch as kind
"baseline" (extra: batch_stats, n_words) or "c2g" (extra: batch_stats),
the JAX package's files, which either package loads.

On the card the baseline's text encoder runs the GRU-sequence kernel and
its backward kernel (2 layers x 2 directions: 4 of each a step), its
attention decoder plain PyTorch; c2g's pre_gru runs them at T = 1 (2 a
step) and its validation rollout the chunk-decoder kernel
(`models/c2g`). Both build their models in fp32 whatever the config's
compute_dtype says, as the JAX trainers do. A config's mesh_shape trains
over a mesh (`parallel/mesh`, its ranks started by
`parallel/launch.spmd`): each dp rank takes its rows of every global
batch, the baseline's word table is row-sharded over tp, rank 0 writes
the checkpoint.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.compat.from_jax import (flax_init,
                                                   to_jax_variables)
from gesture2vec_tpu_torch.models.baseline import Seq2SeqNet
from gesture2vec_tpu_torch.models.c2g import Cluster2Gesture
from gesture2vec_tpu_torch.models.layers import dropout_generator
from gesture2vec_tpu_torch.train import checkpoints
from gesture2vec_tpu_torch.parallel import mesh as pmesh
from gesture2vec_tpu_torch.parallel.launch import spmd
from gesture2vec_tpu_torch.train.config import Config
from gesture2vec_tpu_torch.train.losses import custom_loss
from gesture2vec_tpu_torch.train.optim import Adam, Step
from gesture2vec_tpu_torch.train.token_loop import (require_full_batch,
                                                    to_device)
from gesture2vec_tpu_torch.utils.meters import AverageMeter


def _loss(config: Config, out: torch.Tensor,
          target: torch.Tensor) -> torch.Tensor:
    return custom_loss(out, target, l1_weight=config.loss_l1_weight,
                       cont_weight=config.loss_cont_weight,
                       var_weight=config.loss_var_weight)


@torch.no_grad()
def init_misc(model: torch.nn.Module, seed: int, device: torch.device,
              embedding_weights: Optional[np.ndarray] = None
              ) -> torch.nn.Module:
    """The JAX package's initialisers from a CPU generator seeded with
    seed; every text encoder's word table is the vocabulary's vectors
    where given (normal(1) otherwise)."""
    flax_init(model, torch.Generator().manual_seed(seed))
    if embedding_weights is not None:
        table = torch.from_numpy(np.asarray(embedding_weights, np.float32))
        for name, p in model.named_parameters():
            if name.endswith("embedding_table.weight"):
                p.copy_(table)
    return model.to(device)


class BaselineStep(Step):
    """The baseline's step on (word_ids, lengths, poses)."""

    def __init__(self, config: Config, model: Seq2SeqNet, opt: Adam):
        self.config, self.model, self.opt = config, model, opt

    def loss(self, word_ids, lengths, poses) -> torch.Tensor:
        return _loss(self.config,
                     self.model(word_ids, lengths, poses)["outputs"], poses)


class C2GStep(Step):
    """c2g's step on (cluster_ids, target latents)."""

    def __init__(self, config: Config, model: Cluster2Gesture, opt: Adam):
        self.config, self.model, self.opt = config, model, opt

    def loss(self, ids, latents) -> torch.Tensor:
        return _loss(self.config, self.model(ids), latents)


@torch.no_grad()
def baseline_eval_step(config: Config, model: Seq2SeqNet, word_ids,
                       lengths, poses) -> torch.Tensor:
    return _loss(config, model(word_ids, lengths, poses)["outputs"], poses)


@torch.no_grad()
def c2g_eval_step(config: Config, model: Cluster2Gesture, ids,
                  latents) -> torch.Tensor:
    return _loss(config, model(ids), latents)


def _loop(config: Config, model: torch.nn.Module, step: Step,
          eval_step: Callable, arrays: Tuple[np.ndarray, ...],
          val_arrays: Tuple[np.ndarray, ...], device: torch.device,
          save_fn: Callable[[int], None], log_every: int = 50,
          mesh: Optional[pmesh.Mesh] = None) -> Dict[str, list]:
    """The JAX package's `_loop`: epochs of shuffled full batches, the
    epoch's mean loss, validation, the save at the last epoch (each dp
    rank on its rows of the global batches under a mesh)."""
    seed = max(config.random_seed, 0)
    gen = torch.Generator(device=device).manual_seed(seed)
    bs, n = config.batch_size, arrays[0].shape[0]
    pmesh.prepare_state(model, [step.opt], mesh)
    if mesh is not None:
        mesh.check_batch(bs)
    history: Dict[str, list] = {"train_loss": [], "val_loss": []}
    meter = AverageMeter("loss", ":.4f")
    for epoch in range(config.epochs):
        meter.reset()
        t0 = time.time()
        perm = np.random.default_rng(seed + epoch).permutation(n)
        model.train()
        losses = []
        for b in range(n // bs):
            take = pmesh.shard_batch(perm[b * bs:(b + 1) * bs], mesh)
            batch = tuple(to_device(a[take], device) for a in arrays)
            with dropout_generator(gen), pmesh.shard_context(mesh):
                losses.append(step(*batch))
            if (b + 1) % log_every == 0:
                meter.update(float(torch.stack(losses[-log_every:]).mean()),
                             log_every)
                logging.info("EP %d (%d) %s, %.0f samples/s", epoch, b + 1,
                             meter, (b + 1) * bs / (time.time() - t0))
        meter.avg = (float(torch.stack(losses).mean()) if losses
                     else float("nan"))
        history["train_loss"].append(meter.avg)
        if losses and "first_step_loss" not in history:
            history["first_step_loss"] = [float(losses[0])]
        model.eval()
        m = val_arrays[0].shape[0]
        val = [float(pmesh.average(mesh, eval_step(config, model, *(
            to_device(pmesh.shard_batch(a[s:s + bs], mesh), device)
            for a in val_arrays))))
            for s in range(0, m - bs + 1, bs)]
        history["val_loss"].append(float(np.mean(val)) if val
                                   else float("nan"))
        logging.info("EP %d done: train %.5f val %.5f", epoch, meter.avg,
                     history["val_loss"][-1])
        if epoch + 1 == config.epochs:
            with pmesh.gathered(mesh, model):
                if pmesh.is_main(mesh):
                    save_fn(epoch)
    pmesh.finish(mesh, model, step.opt)
    return history


def _saver(config: Config, model: torch.nn.Module, save_dir: Optional[str],
           pose_dim: int, kind: str, extra: dict) -> Callable[[int], None]:
    def save(epoch: int) -> None:
        if not save_dir or epoch + 1 != config.epochs:
            return
        path = checkpoints.checkpoint_filename(save_dir, config.name,
                                               epoch + 1)
        v = to_jax_variables(model)
        checkpoints.save_checkpoint(
            path, config=config, epoch=epoch + 1, params=v["params"],
            pose_dim=pose_dim,
            extra={"batch_stats": v["batch_stats"], **extra}, kind=kind)
        logging.info("saved checkpoint %s", path)
    return save


# ---------------------------------------------------------------- baseline
def make_baseline(config: Config, n_words: int,
                  pose_dim: int) -> Seq2SeqNet:
    return Seq2SeqNet(n_words=n_words, pose_dim=pose_dim,
                      n_frames=config.n_poses,
                      hidden_size=config.hidden_size,
                      n_layers=config.n_layers,
                      n_pre_poses=config.n_pre_poses,
                      dropout_rate=config.dropout_prob,
                      word_embed_size=config.wordembed_dim)


@spmd
def train_baseline(config: Config, data: Dict[str, np.ndarray],
                   val_data: Dict[str, np.ndarray], n_words: int,
                   embedding_weights: Optional[np.ndarray] = None,
                   save_dir: Optional[str] = None, log_every: int = 50,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Tuple[Seq2SeqNet, Dict[str, list]]:
    """data: {word_ids (N, S), lengths (N,), poses (N, T, D)}; returns
    (model, history). Runs on CUDA unless device says otherwise."""
    require_full_batch(data["word_ids"].shape[0], config.batch_size,
                       config.name)
    mesh, dev = pmesh.trainer_mesh(config.mesh_shape, device)
    pose_dim = data["poses"].shape[-1]
    model = init_misc(make_baseline(config, n_words, pose_dim),
                      max(config.random_seed, 0), dev, embedding_weights)
    step = BaselineStep(config, model, Adam(model.parameters(),
                                            config.learning_rate))
    fields = ("word_ids", "lengths", "poses")
    history = _loop(config, model, step, baseline_eval_step,
                    tuple(data[f] for f in fields),
                    tuple(val_data[f] for f in fields), dev,
                    _saver(config, model, save_dir, pose_dim, "baseline",
                           {"n_words": n_words}), log_every, mesh)
    return model, history


# --------------------------------------------------------------------- c2g
def make_c2g(config: Config, output_size: int) -> Cluster2Gesture:
    return Cluster2Gesture(n_clusters=config.autoencoder_vq_components,
                           output_size=output_size,
                           hidden_size=config.hidden_size,
                           n_frames=config.n_poses,
                           n_layers=config.n_layers,
                           dropout_rate=config.dropout_prob)


@spmd
def train_c2g(config: Config, cluster_ids: np.ndarray,
              target_latents: np.ndarray, val_ids: np.ndarray,
              val_latents: np.ndarray, save_dir: Optional[str] = None,
              log_every: int = 50,
              device: Optional[Union[str, torch.device]] = None
              ) -> Tuple[Cluster2Gesture, Dict[str, list]]:
    """cluster_ids (N,), target_latents (N, n_poses, rep_dim); returns
    (model, history). Runs on CUDA unless device says otherwise."""
    require_full_batch(cluster_ids.shape[0], config.batch_size,
                       config.name)
    mesh, dev = pmesh.trainer_mesh(config.mesh_shape, device)
    out_dim = target_latents.shape[-1]
    model = init_misc(make_c2g(config, out_dim), max(config.random_seed, 0),
                      dev)
    step = C2GStep(config, model, Adam(model.parameters(),
                                       config.learning_rate))
    history = _loop(config, model, step, c2g_eval_step,
                    (cluster_ids, target_latents), (val_ids, val_latents),
                    dev, _saver(config, model, save_dir, out_dim, "c2g", {}),
                    log_every, mesh)
    return model, history
