"""Part a trainer: frame-level pose representation learning.

Port of the JAX package's `train/dae_trainer.py` for the paper's DAE:
the loss is MSE(DAE(dropout(x)), x), the denoising corruption being the
input dropout (`models/dae.py`), with Adam(0.5, 0.999) after global-norm
clipping at 5 (`train/optim.py`). The batch order of each epoch is
np.random.default_rng(seed + epoch).permutation(n), as in JAX; the
dropout masks come from a torch.Generator on the device seeded with
random_seed. The VQ and VAE frame models (`autoencoder_vq`,
`autoencoder_vae`) wait for ROADMAP.md queue A item 3.3.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.compat.from_jax import (flax_init,
                                                   to_jax_variables)
from gesture2vec_tpu_torch.device import resolve_device
from gesture2vec_tpu_torch.models.dae import DAE
from gesture2vec_tpu_torch.models.layers import dropout_generator
from gesture2vec_tpu_torch.train import checkpoints
from gesture2vec_tpu_torch.train.config import Config
from gesture2vec_tpu_torch.train.losses import mse_loss
from gesture2vec_tpu_torch.train.optim import Adam, Step
from gesture2vec_tpu_torch.train.token_loop import (require_full_batch,
                                                    to_device)
from gesture2vec_tpu_torch.utils.meters import AverageMeter

_FRAME_VQ = "VQFrame / VAEFrame Part-a models (autoencoder_vq, " \
            "autoencoder_vae) are not ported yet (ROADMAP.md queue A item " \
            "3.3)"


def make_frame_model(config: Config) -> DAE:
    if config.autoencoder_vq or config.autoencoder_vae:
        raise NotImplementedError(_FRAME_VQ)
    return DAE(config.input_motion_dim, config.hidden_size)


def init_model(model: torch.nn.Module, seed: int,
               device: torch.device) -> torch.nn.Module:
    """The JAX package's initialisers, drawn from a CPU generator seeded
    with seed; then onto the device."""
    flax_init(model, torch.Generator().manual_seed(seed))
    return model.to(device)


class TrainStep(Step):
    """The Part-a step on a batch of frames (B, motion_dim)."""

    def __init__(self, model: DAE, opt: Adam):
        self.model, self.opt = model, opt

    def loss(self, batch: torch.Tensor) -> torch.Tensor:
        return mse_loss(self.model(batch), batch)


@torch.no_grad()
def eval_step(model: DAE, batch: torch.Tensor) -> torch.Tensor:
    return mse_loss(model.decode(model.encode(batch)), batch)


def train_dae(config: Config, train_frames: np.ndarray,
              val_frames: np.ndarray, save_dir: Optional[str] = None,
              save_every: int = 10, log_every: int = 50,
              resume_from: Optional[str] = None,
              device: Optional[Union[str, torch.device]] = None
              ) -> Tuple[DAE, Dict[str, list]]:
    """The Part-a loop; returns (model, history). resume_from restores the
    parameters, the optimizer state and the dropout generator where the
    checkpoint carries them (the port's or the JAX package's) and
    continues from its epoch. Runs on CUDA unless device says otherwise."""
    dev = resolve_device(device)
    seed = max(config.random_seed, 0)
    model = init_model(make_frame_model(config), seed, dev)
    opt = Adam(model.parameters(), config.learning_rate)
    gen = torch.Generator(device=dev).manual_seed(seed)
    start_epoch = 0
    if resume_from:
        start_epoch, _ = checkpoints.restore_for_resume(model, opt, gen,
                                                        resume_from)
    step = TrainStep(model, opt)
    n, bs = train_frames.shape[0], config.batch_size
    require_full_batch(n, bs, config.name)
    history: Dict[str, list] = {"train_loss": [], "val_loss": []}
    meter = AverageMeter("loss", ":.4f")
    for epoch in range(start_epoch, config.epochs):
        meter.reset()
        t0 = time.time()
        perm = np.random.default_rng(seed + epoch).permutation(n)
        model.train()
        losses = []
        for b in range(n // bs):
            batch = to_device(train_frames[perm[b * bs:(b + 1) * bs]], dev)
            with dropout_generator(gen):
                losses.append(step(batch))
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
        val = [float(eval_step(model, to_device(val_frames[s:s + bs], dev)))
               for s in range(0, val_frames.shape[0] - bs + 1, bs)]
        history["val_loss"].append(float(np.mean(val)) if val
                                   else float("nan"))
        logging.info("EP %d done: train %.5f val %.5f", epoch, meter.avg,
                     history["val_loss"][-1])
        if save_dir and ((epoch + 1) % save_every == 0
                         or epoch + 1 == config.epochs):
            path = checkpoints.checkpoint_filename(
                save_dir, f"{config.name}_H{config.hidden_size}", epoch + 1)
            checkpoints.save_checkpoint(
                path, config=config, epoch=epoch + 1,
                params=to_jax_variables(model)["params"],
                pose_dim=config.input_motion_dim,
                extra={"batch_stats": {},
                       **checkpoints.resume_extra(model, opt, gen, config)},
                kind="DAE")
            logging.info("saved checkpoint %s", path)
    return model, history
