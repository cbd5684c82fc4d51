"""The unrolled-GAN trainer of the text -> gesture GAN.

Port of the JAX package's `train/gan_trainer.py` (the reference's
train_iter_text2embedding_GAN). One step (`GANStep`) on a batch
(tokens, lengths, real poses) with a noise batch:
  1. the fake batch from the current generator in train mode, without
     gradient; its BatchNorm statistics are thrown away, as JAX throws
     away that forward's batch_stats (`running_stats_kept`);
  2. one discriminator update on real and fake (BCE with logits against
     1 and 0, D in train mode), whose losses are the step's d_real and
     d_fake;
  3. `unroll_steps` (10) further D updates on the same batch;
  4. the generator's update: its train-mode forward (whose BatchNorm
     statistics survive), the unrolled D in eval mode with its parameters
     out of autograd (`frozen`), BCE against 1; the gradient reaches the
     generator's parameters only (D's .grad stays untouched, D's
     parameters do not move);
  5. D restored to its state after the first update: its parameters and
     its Adam state (mu, nu, count) from copies taken then (the optimizer
     updates in place, so a list of references would restore nothing:
     the reference's defect). keep_unrolled (`gan_keep_unrolled`, the
     parity switch) keeps the unrolled D, the reference's literal
     behaviour.
Both optimizers are Adam(0.5, 0.999) without gradient clipping, as the
reference leaves it commented out. The step takes its noise as an
argument; `train_gan` draws it from its own torch.Generator. The
checkpoint, written at the end, is kind "text2embedding_gan": the
generator's params, with batch_stats, d_params and n_words in extra.

On the card every text encoder (the generator's and D's) runs the
GRU-sequence kernel (4 launches a forward), and D's pose GRU too (2):
a step makes 8 inference launches (the fake batch's text encoder, and
D's in the generator's update, which no gradient reaches) and 138 of the
gate-saving variant, each with its backward launch (the generator's 4,
11 D updates of 2 forwards x 6, D's pose GRU in the generator's update);
the decoder's attention runs plain PyTorch. The models are fp32 whatever
the config's compute_dtype says, as in JAX. A config's mesh_shape trains
over a mesh (`parallel/mesh`, its ranks started by
`parallel/launch.spmd`): each dp rank takes its rows of every global
batch and of its noise, the word tables are row-sharded over tp, rank 0
writes the checkpoint.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gesture2vec_tpu_torch.compat.from_jax import to_jax_variables
from gesture2vec_tpu_torch.models.gan import T2GDiscriminator, T2GGenerator
from gesture2vec_tpu_torch.models.layers import dropout_generator
from gesture2vec_tpu_torch.train import checkpoints
from gesture2vec_tpu_torch.parallel import mesh as pmesh
from gesture2vec_tpu_torch.parallel.launch import spmd
from gesture2vec_tpu_torch.train.config import Config
from gesture2vec_tpu_torch.train.misc_trainers import init_misc
from gesture2vec_tpu_torch.train.optim import Adam
from gesture2vec_tpu_torch.train.token_loop import to_device
from gesture2vec_tpu_torch.utils.meters import AverageMeter


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy against a constant label,
    averaged."""
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


@contextlib.contextmanager
def running_stats_kept(model: nn.Module) -> Iterator[None]:
    """Train-mode forwards inside leave every BatchNorm's running
    statistics as they were before."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm1d)]
    saved = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    try:
        yield
    finally:
        with torch.no_grad():
            for m, (mean, var) in zip(bns, saved):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)


@contextlib.contextmanager
def frozen(model: nn.Module) -> Iterator[None]:
    """The model in eval mode with its parameters out of autograd: a loss
    through it reaches what feeds it, never its own .grad (and what it
    computes from inputs that need no gradient runs without one)."""
    params = [p for p in model.parameters() if p.requires_grad]
    model.eval()
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)
        model.train()


class GANStep:
    """One unrolled-GAN step (see the module note); calling it returns
    {"d_real", "d_fake", "g_loss"}, detached (on the device)."""

    def __init__(self, g: T2GGenerator, d: T2GDiscriminator, g_opt: Adam,
                 d_opt: Adam, unroll_steps: int = 10,
                 keep_unrolled: bool = False):
        self.g, self.d, self.g_opt, self.d_opt = g, d, g_opt, d_opt
        self.unroll_steps, self.keep_unrolled = unroll_steps, keep_unrolled

    def d_update(self, tokens, lengths, real, fake
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One D update on real and fake; returns (real_err, fake_err)."""
        self.d_opt.zero_grad()
        real_err = bce_with_logits(self.d(tokens, lengths, real), 1.0)
        fake_err = bce_with_logits(self.d(tokens, lengths, fake), 0.0)
        (real_err + fake_err).backward()
        self.d_opt.step()
        return real_err.detach(), fake_err.detach()

    def d_state(self) -> Tuple[List[torch.Tensor], ...]:
        """Copies of D's parameters and Adam state (count kept aside)."""
        o = self.d_opt
        return tuple([t.detach().clone() for t in ts]
                     for ts in (o.params, o.mu, o.nu))

    @torch.no_grad()
    def restore_d(self, state: Tuple[List[torch.Tensor], ...],
                  count: int) -> None:
        o = self.d_opt
        for dst, src in zip(o.params + o.mu + o.nu,
                            state[0] + state[1] + state[2]):
            dst.copy_(src)
        o.count = count

    def fake_batch(self, tokens, lengths, noise, seed_pose
                   ) -> torch.Tensor:
        """Stage 1: the generator's train-mode forward without gradient,
        its BatchNorm statistics left as they were."""
        with torch.no_grad(), running_stats_kept(self.g):
            return self.g(tokens, lengths, noise, seed_pose)

    def unroll(self, tokens, lengths, real, fake) -> tuple:
        """Stages 2 and 3: the first D update, a copy of D's state after it
        (None with keep_unrolled), the unrolled updates; returns (real_err,
        fake_err, the copy)."""
        real_err, fake_err = self.d_update(tokens, lengths, real, fake)
        saved = None if self.keep_unrolled else (self.d_state(),
                                                 self.d_opt.count)
        for _ in range(self.unroll_steps):
            self.d_update(tokens, lengths, real, fake)
        return real_err, fake_err, saved

    def g_update(self, tokens, lengths, noise, seed_pose) -> torch.Tensor:
        """Stage 4: the generator's update against the unrolled D."""
        self.g_opt.zero_grad()
        gen = self.g(tokens, lengths, noise, seed_pose)
        with frozen(self.d):
            g_err = bce_with_logits(self.d(tokens, lengths, gen), 1.0)
        g_err.backward()
        self.g_opt.step()
        return g_err.detach()

    def __call__(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 real: torch.Tensor, noise: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        self.g.train()
        self.d.train()
        seed_pose = real[:, 0]
        fake = self.fake_batch(tokens, lengths, noise, seed_pose)
        real_err, fake_err, saved = self.unroll(tokens, lengths, real, fake)
        g_err = self.g_update(tokens, lengths, noise, seed_pose)
        if saved is not None:
            self.restore_d(*saved)
        return {"d_real": real_err, "d_fake": fake_err, "g_loss": g_err}


def build_gan(config: Config, n_words: int, pose_dim: int
              ) -> Tuple[T2GGenerator, T2GDiscriminator]:
    g = T2GGenerator(n_words=n_words, pose_dim=pose_dim,
                     n_frames=config.n_poses, hidden_size=config.hidden_size,
                     n_layers=config.n_layers, noise_dim=config.noise_dim,
                     dropout_rate=config.dropout_prob,
                     word_embed_size=config.wordembed_dim)
    d = T2GDiscriminator(n_words=n_words, pose_dim=pose_dim,
                         hidden_size=config.hidden_size,
                         n_layers=config.n_layers,
                         dropout_rate=config.dropout_prob,
                         word_embed_size=config.wordembed_dim)
    return g, d


def init_gan(g: T2GGenerator, d: T2GDiscriminator, seed: int,
             device: torch.device,
             embedding_weights: Optional[np.ndarray] = None
             ) -> Tuple[T2GGenerator, T2GDiscriminator]:
    """The JAX package's initialisers (the generator from seed, D from
    seed + 2, as JAX folds its key); both word tables the vocabulary's
    vectors where given."""
    return (init_misc(g, seed, device, embedding_weights),
            init_misc(d, seed + 2, device, embedding_weights))


@spmd
def train_gan(config: Config, data: Dict[str, np.ndarray], n_words: int,
              embedding_weights: Optional[np.ndarray] = None,
              save_dir: Optional[str] = None,
              device: Optional[Union[str, torch.device]] = None
              ) -> Tuple[Tuple[T2GGenerator, T2GDiscriminator],
                         Dict[str, list]]:
    """The unrolled-GAN loop over {word_ids (N, S), lengths (N,), poses
    (N, T, D)}; returns ((generator, discriminator), history of the
    epochs' mean g_loss, d_real and d_fake, and the first step's D loss
    d_real + d_fake, first_step_d_loss). Runs on CUDA unless device says
    otherwise."""
    mesh, dev = pmesh.trainer_mesh(config.mesh_shape, device)
    seed = max(config.random_seed, 0)
    pose_dim = data["poses"].shape[-1]
    g, d = init_gan(*build_gan(config, n_words, pose_dim), seed, dev,
                    embedding_weights)
    step = GANStep(g, d, Adam(g.parameters(), config.learning_rate,
                              clip_norm=None),
                   Adam(d.parameters(), config.learning_rate,
                        clip_norm=None),
                   keep_unrolled=config.gan_keep_unrolled)
    pmesh.prepare_state(g, [step.g_opt], mesh)
    pmesh.prepare_state(d, [step.d_opt], mesh)
    drop = torch.Generator(device=dev).manual_seed(seed)
    noise_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    bs = config.batch_size
    n = data["word_ids"].shape[0]
    if n < bs:
        raise ValueError(f"GAN training needs at least one full batch "
                         f"({n} windows < batch_size {bs})")
    if mesh is not None:
        mesh.check_batch(bs)
    fields = ("word_ids", "lengths", "poses")
    history: Dict[str, list] = {"g_loss": [], "d_real": [], "d_fake": []}
    meter = AverageMeter("g_loss", ":.4f")
    for epoch in range(config.epochs):
        perm = np.random.default_rng(seed + epoch).permutation(n)
        meter.reset()
        metrics: List[Dict[str, torch.Tensor]] = []
        for s in range(0, n - bs + 1, bs):
            take = pmesh.shard_batch(perm[s:s + bs], mesh)
            batch = [to_device(data[f][take], dev) for f in fields]
            noise = pmesh.shard_batch(torch.randn(
                (bs, config.noise_dim), generator=noise_gen, device=dev), mesh)
            with dropout_generator(drop), pmesh.shard_context(mesh):
                metrics.append(pmesh.average(mesh, step(*batch, noise)))
        means = {k: float(torch.stack([m[k] for m in metrics]).mean())
                 for k in ("g_loss", "d_real", "d_fake")}
        for k, v in means.items():
            history[k].append(v)
        if "first_step_d_loss" not in history:
            history["first_step_d_loss"] = [
                float(metrics[0]["d_real"] + metrics[0]["d_fake"])]
        meter.avg = means["g_loss"]
        logging.info("EP %d done: g %.4f d_real %.4f d_fake %.4f", epoch,
                     meter.avg, means["d_real"], means["d_fake"])
    pmesh.finish(mesh, g, step.g_opt)
    pmesh.finish(mesh, d, step.d_opt)
    if save_dir and pmesh.is_main(mesh):
        path = checkpoints.checkpoint_filename(save_dir, config.name,
                                               config.epochs)
        gv = to_jax_variables(g)
        checkpoints.save_checkpoint(
            path, config=config, epoch=config.epochs, params=gv["params"],
            pose_dim=pose_dim,
            extra={"batch_stats": gv["batch_stats"],
                   "d_params": to_jax_variables(d)["params"],
                   "n_words": n_words}, kind="text2embedding_gan")
        logging.info("saved checkpoint %s", path)
    return (g, d), history
