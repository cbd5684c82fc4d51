"""Part a trainer: frame-level pose representation learning.

Port of the JAX package's `train/dae_trainer.py`. The model follows the
config as in JAX: `autoencoder_vq` a VQFrame (with the VAE heads under
`autoencoder_vae`), else `autoencoder_vae` a VAEFrame, else the paper's
DAE (`models/dae.py`). The losses:
  DAE       MSE(DAE(dropout(x)), x), the denoising corruption being the
            input dropout;
  VQFrame   MSE + the quantizer's commitment loss, plus with the VAE heads
            5 * (-2.5) * mean_b mean_d (1 + logvar - e^logvar - mu^2);
  VAEFrame  MSE + the same KLD term;
with Adam(0.5, 0.999) after global-norm clipping at 5 (`train/optim.py`).
A VQFrame's step also updates its BatchNorm statistics and EMA codebook
(the module's buffers); on the card its quantizer's argmin is the
VQ-argmin kernel, one launch a train step and a validation batch.
`train_dae(..., vq_tricks=True)` runs the reference's delayed VQ start
(epochs before vq_start_epoch skip the quantizer) and re-fits the
codebook with K-Means (`reestimate_codebook`, its Lloyd steps through
the VQ-argmin kernel) every vq_reestimate_every epochs from then on.
The batch order of each epoch is np.random.default_rng(seed +
epoch).permutation(n), as in JAX; dropout masks and the VAEs' noise come
from a torch.Generator on the device seeded with random_seed. The
training frames may be a streaming source (`data/streaming.StreamingFrames`)
in place of the array, whose batches are then the source's; both go
through `utils/prefetch`. A stream refuses vq_tricks (the codebook re-fit
sweeps the array), as in JAX. A config's mesh_shape trains over a mesh
(`parallel/mesh`, its ranks started by `parallel/launch.spmd`): each dp
rank takes its rows of every global batch, the codebook re-fit runs on
the full codebook and is re-sharded, and rank 0 writes the files.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from gesture2vec_tpu_torch.cluster.kmeans import lloyd, plusplus_init
from gesture2vec_tpu_torch.compat.from_jax import (ema_state_to_jax,
                                                   flax_init,
                                                   load_ema_state,
                                                   to_jax_variables)
from gesture2vec_tpu_torch.models.dae import DAE, VAEFrame, VQFrame
from gesture2vec_tpu_torch.models.layers import dropout_generator
from gesture2vec_tpu_torch.models.vq import VQEmaState
from gesture2vec_tpu_torch.parallel import mesh as pmesh
from gesture2vec_tpu_torch.parallel.launch import spmd
from gesture2vec_tpu_torch.train import checkpoints
from gesture2vec_tpu_torch.train.config import Config
from gesture2vec_tpu_torch.train.losses import mse_loss
from gesture2vec_tpu_torch.train.optim import Adam, Step
from gesture2vec_tpu_torch.train.token_loop import (require_full_batch,
                                                    to_device)
from gesture2vec_tpu_torch.utils.meters import AverageMeter
from gesture2vec_tpu_torch.utils.prefetch import prefetch


def make_frame_model(config: Config) -> nn.Module:
    """The Part-a model the config selects (see the module note)."""
    motion_dim, latent = config.input_motion_dim, config.hidden_size
    if config.autoencoder_vq:
        return VQFrame(motion_dim, latent, config.autoencoder_vq_components,
                       vae=config.autoencoder_vae,
                       commitment_cost=config.autoencoder_vq_commitment_cost)
    if config.autoencoder_vae:
        return VAEFrame(motion_dim, latent)
    return DAE(motion_dim, latent)


def init_model(model: torch.nn.Module, seed: int,
               device: torch.device) -> torch.nn.Module:
    """The JAX package's initialisers, drawn from a CPU generator seeded
    with seed; then onto the device."""
    flax_init(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def _vae_term(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """The reference's Part-a KLD term (-2.5 coefficient, weight 5)."""
    return 5 * (-2.5) * torch.mean(torch.mean(
        1 + logvar - torch.exp(logvar) - mean ** 2, dim=1))


class TrainStep(Step):
    """The Part-a step on a batch of frames (B, motion_dim). skip_vq
    (a VQFrame only) is the delayed-VQ warmup step."""

    def __init__(self, model: nn.Module, opt: Adam, skip_vq: bool = False):
        self.model, self.opt, self.skip_vq = model, opt, skip_vq

    def loss(self, batch: torch.Tensor) -> torch.Tensor:
        m = self.model
        if isinstance(m, VQFrame):
            res = m(batch, skip_vq=self.skip_vq)
            loss = mse_loss(res["output"], batch) + res["vq"].loss
            if m.vae:
                loss = loss + _vae_term(res["mean"], res["logvar"])
            return loss
        if isinstance(m, VAEFrame):
            out, logvar, mean = m(batch)
            return mse_loss(out, batch) + _vae_term(mean, logvar)
        return mse_loss(m(batch), batch)


@torch.no_grad()
def eval_step(model: nn.Module, batch: torch.Tensor) -> torch.Tensor:
    """The validation MSE of the model's eval-mode forward."""
    if isinstance(model, VQFrame):
        return mse_loss(model(batch)["output"], batch)
    if isinstance(model, VAEFrame):
        return mse_loss(model(batch)[0], batch)
    return mse_loss(model.decode(model.encode(batch)), batch)


def _plusplus(latents: torch.Tensor, k: int) -> torch.Tensor:
    gen = torch.Generator(device=latents.device).manual_seed(0)
    return plusplus_init(latents, k, gen)


@torch.no_grad()
def reestimate_codebook(
        model: VQFrame, frames: np.ndarray, k: int, batch: int = 4096,
        seed_centers: Optional[Callable[[torch.Tensor, int],
                                        torch.Tensor]] = None) -> None:
    """Re-fit a VQFrame's codebook with K-Means over the current latents,
    in place (the JAX package's reestimate_codebook): encode every frame
    in eval mode with skip_vq in batches of `batch`, take "latent", fit
    k centers (one fit, at most 300 Lloyd steps; seed_centers(latents,
    k) gives the initial centers, by default k-means++ from a generator
    seeded 0) and reset the EMA state to codebook = centers,
    cluster_size = 1, ema_w = a copy of centers, so the centers are the
    exact codebook. "latent" is the post-BatchNorm encoder output: with
    the VAE heads the quantizer sees fc_decoder(z), yet the re-fit fits
    the post-BatchNorm value, as JAX's does."""
    dev = model.vq.codebook.device
    was_training = model.training
    model.eval()
    latents = torch.cat([
        model(to_device(frames[s:s + batch], dev), skip_vq=True)["latent"]
        for s in range(0, frames.shape[0], batch)]).float().contiguous()
    seed_centers = seed_centers or _plusplus
    centers, _, inertia, steps = lloyd(
        latents, seed_centers(latents, k).to(dev), max_iter=300)
    # load_state copies: codebook and ema_w never alias
    model.vq.load_state(VQEmaState(centers, torch.ones_like(centers[:, 0]),
                                   centers))
    logging.info("codebook re-estimated from %d latents (inertia %.2f, %d "
                 "Lloyd steps)", latents.shape[0], float(inertia), steps)
    model.train(was_training)


@spmd
def train_dae(config: Config, train_frames,
              val_frames: np.ndarray, save_dir: Optional[str] = None,
              save_every: int = 10, log_every: int = 50,
              resume_from: Optional[str] = None,
              vq_tricks: bool = False, vq_start_epoch: int = 5,
              vq_reestimate_every: int = 5,
              device: Optional[Union[str, torch.device]] = None
              ) -> Tuple[nn.Module, Dict[str, list]]:
    """The Part-a loop; returns (model, history). resume_from restores the
    parameters, the BatchNorm statistics, a VQFrame's EMA state, the
    optimizer state and the dropout generator where the checkpoint
    carries them (the port's or the JAX package's) and continues from its
    epoch. vq_tricks (a VQFrame only): see the module note. train_frames
    is an (N, motion_dim) array or a streaming source. Runs on CUDA unless
    device says otherwise."""
    streaming = hasattr(train_frames, "batches")
    if vq_tricks and streaming:
        raise ValueError("vq_tricks needs the in-RAM frame array (K-Means "
                         "codebook re-estimation sweeps it)")
    mesh, dev = pmesh.trainer_mesh(config.mesh_shape, device)
    seed = max(config.random_seed, 0)
    model = init_model(make_frame_model(config), seed, dev)
    is_vq = isinstance(model, VQFrame)
    opt = Adam(model.parameters(), config.learning_rate)
    gen = torch.Generator(device=dev).manual_seed(seed)
    start_epoch = 0
    if resume_from:
        start_epoch, payload = checkpoints.restore_for_resume(
            model, opt, gen, resume_from)
        if is_vq and payload["extra"].get("vq_state"):
            load_ema_state(model, payload["extra"]["vq_state"])
    pmesh.prepare_state(model, [opt], mesh)
    step = TrainStep(model, opt)
    warmup = TrainStep(model, opt, skip_vq=True) if vq_tricks and is_vq \
        else None
    n = len(train_frames) if streaming else train_frames.shape[0]
    bs = config.batch_size
    require_full_batch(n, bs, config.name)
    if mesh is not None:
        mesh.check_batch(bs)
    history: Dict[str, list] = {"train_loss": [], "val_loss": []}
    meter = AverageMeter("loss", ":.4f")
    for epoch in range(start_epoch, config.epochs):
        step_fn = step
        if warmup is not None:
            if epoch < vq_start_epoch:
                step_fn = warmup
            elif epoch % vq_reestimate_every == 0:
                with pmesh.gathered(mesh, model):
                    reestimate_codebook(model, train_frames,
                                        config.autoencoder_vq_components)
        meter.reset()
        t0 = time.time()
        if streaming:
            source = train_frames.batches(epoch, bs)
        else:
            perm = np.random.default_rng(seed + epoch).permutation(n)
            source = (train_frames[perm[b * bs:(b + 1) * bs]]
                      for b in range(n // bs))
        model.train()
        losses = []
        for b, batch in enumerate(prefetch(
                source, device=dev, place=pmesh.batch_placer(mesh, dev))):
            with dropout_generator(gen), pmesh.shard_context(mesh):
                losses.append(step_fn(batch))
            if (b + 1) % log_every == 0:
                meter.update(float(torch.stack(losses[-log_every:]).mean()),
                             bs * log_every)
                logging.info("EP %d (%d/%d) %s, %.0f samples/s", epoch,
                             b + 1, n // bs, meter,
                             (b + 1) * bs / (time.time() - t0))
        meter.avg = (float(torch.stack(losses).mean()) if losses
                     else float("nan"))
        history["train_loss"].append(meter.avg)
        if losses and "first_step_loss" not in history:
            history["first_step_loss"] = [float(losses[0])]
        model.eval()
        val = [float(pmesh.average(mesh, eval_step(model, to_device(
            pmesh.shard_batch(val_frames[s:s + bs], mesh), dev))))
            for s in range(0, val_frames.shape[0] - bs + 1, bs)]
        history["val_loss"].append(float(np.mean(val)) if val
                                   else float("nan"))
        logging.info("EP %d done: train %.5f val %.5f", epoch, meter.avg,
                     history["val_loss"][-1])
        if save_dir and ((epoch + 1) % save_every == 0
                         or epoch + 1 == config.epochs):
            with pmesh.gathered(mesh, model, opt):
                if pmesh.is_main(mesh):
                    _save(config, model, opt, gen, save_dir, epoch + 1)
    return pmesh.finish(mesh, model, opt), history


def _save(config: Config, model: nn.Module, opt: Adam,
          gen: torch.Generator, save_dir: str, epoch1: int) -> None:
    path = checkpoints.checkpoint_filename(
        save_dir, f"{config.name}_H{config.hidden_size}", epoch1)
    v = to_jax_variables(model)
    extra = {"batch_stats": v["batch_stats"],
             **checkpoints.resume_extra(model, opt, gen, config)}
    if isinstance(model, VQFrame):
        extra["vq_state"] = ema_state_to_jax(model)
    checkpoints.save_checkpoint(
        path, config=config, epoch=epoch1, params=v["params"],
        pose_dim=config.input_motion_dim, extra=extra, kind="DAE")
    logging.info("saved checkpoint %s", path)
