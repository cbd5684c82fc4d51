"""Part b trainer: the gesture tokenizer (sequence VQ autoencoder).

Port of the JAX package's `train/seq_ae_trainer.py`:
  loss = custom_loss(outputs, windows) + vq_loss / 400
         (+ kld_loss_standard * 0.1 * (epoch + 1) / epochs with the VAE
         heads)
over the teacher-forced decode of a train-mode forward
(`models/seq_ae.SeqVQAutoencoder`, with the BiGRU or, for `seq_arch:
transformer`, the transformer chunk encoder; without a quantizer under
`autoencoder_vq: false`, with the VAE heads under `autoencoder_vae`, the
decoder attention over the encoder outputs under `autoencoder_att`;
`use_derivative` doubles the window width the model takes), with
Adam(0.5, 0.999) after global-norm clipping at 5. The similarity-
supervised step (`use_similarity` with a `similarity_labels` file,
`SSLTrainStep`) adds loss_label_weight * sum(+-cos) over 3 labelled
window pairs a step, each pair member through its own train-mode
forward. On the card the BiGRU encoder's four recurrences run the
GRU-sequence kernel forward and its backward kernel backward (the
transformer encoder runs no kernel), and the residual quantizer's hard
assignments the VQ-argmin kernel; validation (eval BatchNorm, no
dropout, the VAE heads' mean) decodes through the chunk-decoder kernel,
so on the card a decoder the kernel cannot run is refused before the
first step, except an attention decoder: the kernel has no attention
(nor has the JAX package's), so its validation decode runs in plain
PyTorch on the card, as its train-mode decode does (logged once).
`rvq_reestimate_every` re-fits each residual stage's
codebook with K-Means (`cluster/kmeans`, assignments through the
VQ-argmin kernel) over the current encoder latents.

`compute_dtype: bfloat16` builds the tokenizer in bf16
(`models/seq_ae`): on the card the BiGRU runs the bf16 instantiations of
the GRU-sequence and GRU-backward kernels and validation the chunk
decoder's; parameters, Adam's state, gradients and checkpoints stay
fp32. The training windows may be a streaming source
(`data/streaming.StreamingWindows`, with its frozen-DAE transform) in
place of the array; both go through `utils/prefetch`. A stream refuses
use_similarity (pair sampling indexes the array) and trains without the
residual-VQ re-fit (it sweeps the array), as in JAX. `plot_every` N
writes the codebook's t-SNE (`cluster/plots.plot_codebook_tsne`,
matplotlib and scikit-learn) every N epochs into the save dir, as the
JAX trainer does. A config's mesh_shape trains over a mesh
(`parallel/mesh`, its ranks started by `parallel/launch.spmd`): each dp
rank takes its rows of every global batch, the codebooks are
row-sharded over tp (the residual re-fit runs on the full codebooks and
is re-sharded), rank 0 writes the files; the similarity step stays
refused there, with the JAX package's message.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.cluster.kmeans import lloyd, plusplus_init
from gesture2vec_tpu_torch.compat.from_jax import to_jax_variables
from gesture2vec_tpu_torch.data.similarity import (read_gesture_labels,
                                                   sample_pairs)
from gesture2vec_tpu_torch.models.layers import (compute_dtype,
                                                 dropout_generator)
from gesture2vec_tpu_torch.models.seq_ae import (SeqVQAutoencoder,
                                                 _flatten_hidden)
from gesture2vec_tpu_torch.ops.vq_kernel import vq_argmin
from gesture2vec_tpu_torch.parallel import mesh as pmesh
from gesture2vec_tpu_torch.parallel.launch import spmd
from gesture2vec_tpu_torch.train import checkpoints
from gesture2vec_tpu_torch.train.config import Config
from gesture2vec_tpu_torch.train.dae_trainer import init_model
from gesture2vec_tpu_torch.train.losses import (custom_loss, kld_loss,
                                                kld_loss_standard)
from gesture2vec_tpu_torch.train.optim import Adam, Step
from gesture2vec_tpu_torch.train.token_loop import (require_full_batch,
                                                    to_device)
from gesture2vec_tpu_torch.utils.meters import AverageMeter
from gesture2vec_tpu_torch.utils.prefetch import prefetch

def make_seq_ae(config: Config) -> SeqVQAutoencoder:
    """The tokenizer the JAX package's make_seq_ae builds (per_sample
    flattening, the trainers' default; the encoder from `seq_arch`;
    `use_derivative` doubles rep_dim; the compute dtype from
    `compute_dtype`; the decoder attention from `autoencoder_att`)."""
    rep_dim = config.rep_learning_dim * (2 if config.use_derivative else 1)
    return SeqVQAutoencoder(
        rep_dim=rep_dim, hidden_size=config.hidden_size,
        n_layers=config.n_layers, n_frames=config.n_poses,
        vq_components=config.autoencoder_vq_components,
        n_pre_poses=config.n_pre_poses,
        vq_variant=config.autoencoder_vq_variant,
        rvq_stages=config.rvq_stages,
        commitment_cost=config.autoencoder_vq_commitment_cost,
        conditioned=config.autoencoder_conditioned,
        encoder_arch=config.extras.get("seq_arch", "bigru"),
        dropout_rate=config.dropout_prob, use_vq=config.autoencoder_vq,
        use_vae=config.autoencoder_vae,
        compute_dtype=compute_dtype(config.compute_dtype),
        use_attention=config.autoencoder_att)


def _rec(config: Config, res: dict, batch: torch.Tensor) -> torch.Tensor:
    return custom_loss(res["outputs"], batch,
                       l1_weight=config.loss_l1_weight,
                       cont_weight=config.loss_cont_weight,
                       var_weight=config.loss_var_weight)


def _vq_terms(model: SeqVQAutoencoder, res: dict
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the quantizer's loss / 400, its perplexity); zeros without one."""
    if not model.use_vq:
        zero = res["outputs"].new_zeros(())
        return zero, zero
    return res["vq"].loss / 400.0, res["vq"].perplexity


class TrainStep(Step):
    """The Part-b step on a batch of windows (B, n_poses, rep_dim) in a
    0-indexed epoch (the VAE's KLD weight anneals over config.epochs); its
    loss comes with the quantizer's perplexity (0 without one)."""

    def __init__(self, config: Config, model: SeqVQAutoencoder, opt: Adam):
        self.config, self.model, self.opt = config, model, opt

    def loss(self, batch: torch.Tensor, epoch: float = 0.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        res = self.model(batch, batch)
        loss = _rec(self.config, res, batch)
        if self.model.use_vae:
            # the reference's 1-indexed epochs: weight 0.1 * 1 / N from
            # the first
            loss = loss + kld_loss_standard(res["mean"], res["logvar"]) \
                * 0.1 * (epoch + 1.0) / self.config.epochs
        vq_loss, perp = _vq_terms(self.model, res)
        return loss + vq_loss, perp


def pair_latents(model: SeqVQAutoencoder, windows: torch.Tensor
                 ) -> torch.Tensor:
    """A train-mode forward's first_hidden, one (L*H) row per window."""
    h = model(windows, windows)["first_hidden"]
    L, B, H = h.shape
    return h.transpose(0, 1).reshape(B, L * H)


class SSLTrainStep(Step):
    """The similarity-supervised Part-b step (the JAX package's
    make_ssl_train_step): the main batch, then pair_a, then pair_b, each
    through a train-mode forward in that order (the BatchNorm statistics
    update in that order); cos = <a, b> / (|a| |b| + 1e-8) of each pair's
    latents, sim = sum(label > 0.5 ? -cos : cos), loss = rec +
    loss_label_weight * sim (+ the VQ term; with the VAE heads +
    kld_loss * 0.1 * (epoch + 1 - 10) / epochs once epoch + 1 > 10).
    Returns (loss, perplexity, rec, sim)."""

    def __init__(self, config: Config, model: SeqVQAutoencoder, opt: Adam):
        self.config, self.model, self.opt = config, model, opt

    def loss(self, batch: torch.Tensor, pair_a: torch.Tensor,
             pair_b: torch.Tensor, pair_label: torch.Tensor,
             epoch: float = 0.0) -> Tuple[torch.Tensor, ...]:
        c, m = self.config, self.model
        res = m(batch, batch)
        rec = _rec(c, res, batch)
        la, lb = pair_latents(m, pair_a), pair_latents(m, pair_b)
        cos = torch.sum(la * lb, dim=-1) / (
            torch.linalg.vector_norm(la, dim=-1)
            * torch.linalg.vector_norm(lb, dim=-1) + 1e-8)
        sim = torch.sum(torch.where(pair_label > 0.5, -cos, cos))
        loss = rec + c.loss_label_weight * sim
        if m.use_vae and epoch + 1.0 > 10.0:
            loss = loss + kld_loss(res["mean"], res["logvar"]) * 0.1 \
                * (epoch + 1.0 - 10.0) / c.epochs
        vq_loss, perp = _vq_terms(m, res)
        return loss + vq_loss, perp, rec, sim


@torch.no_grad()
def eval_step(config: Config, model: SeqVQAutoencoder,
              batch: torch.Tensor) -> torch.Tensor:
    """The validation loss (eval mode: the decode goes through the
    chunk-decoder kernel where it is eligible)."""
    return _rec(config, model(batch, batch), batch)


def _plusplus(resid: torch.Tensor, k: int, stage: int) -> torch.Tensor:
    gen = torch.Generator(device=resid.device).manual_seed(stage)
    return plusplus_init(resid, k, gen)


@torch.no_grad()
def reestimate_rvq_codebooks(
        model: SeqVQAutoencoder, windows: np.ndarray, k: int, stages: int,
        batch: int = 512, max_rows: int = 20000,
        seed_centers: Optional[Callable[[torch.Tensor, int, int],
                                        torch.Tensor]] = None) -> None:
    """K-Means re-fit of every residual-VQ stage codebook over the
    current encoder latents, in place (the JAX package's
    reestimate_rvq_codebooks): stage 0 fits the flattened
    decoder-initial hiddens of (at most max_rows, a sorted subsample
    drawn by np.random.default_rng(0)) windows in full batches, stage s
    the residual left by stages < s; 100 Lloyd steps at most.
    seed_centers(resid, k, stage) gives each stage's initial centers
    (default: k-means++ from a generator seeded with the stage)."""
    dev = model.vq_layer.codebook.device
    was_training = model.training
    model.eval()
    sub = windows
    if windows.shape[0] > max_rows:
        pick = np.random.default_rng(0).permutation(
            windows.shape[0])[:max_rows]
        sub = windows[np.sort(pick)]
    starts = list(range(0, sub.shape[0] - batch + 1, batch)) or [None]
    rows = []
    for s in starts:
        x = sub if s is None else sub[s:s + batch]
        h = model.encode_hidden(to_device(x, dev))
        rows.append(_flatten_hidden(h, model.vq_flatten))
    resid = torch.cat(rows, dim=0).float().contiguous()
    seed_centers = seed_centers or _plusplus
    for s, cb in enumerate(model.vq_layer.codebooks()[:stages]):
        centers, _, _, _ = lloyd(resid, seed_centers(resid, k, s).to(dev),
                                 max_iter=100)
        cb.copy_(centers)
        idx, _ = vq_argmin(resid, centers.contiguous())
        resid = (resid - centers[idx]).contiguous()
    logging.info("RVQ codebooks re-estimated from %d latents (%d stages, "
                 "k=%d)", resid.shape[0], stages, k)
    model.train(was_training)


@spmd
def train_seq_ae(config: Config, train_windows,
                 val_windows: np.ndarray, save_dir: Optional[str] = None,
                 save_every: int = 20, log_every: int = 50,
                 resume_from: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 plot_every: int = 0
                 ) -> Tuple[SeqVQAutoencoder, Dict[str, list]]:
    """The Part-b loop over frozen-DAE latent windows (N, n_poses,
    rep_dim), an array or a streaming source (`data/streaming`); returns
    (model, history). resume_from as in dae_trainer.train_dae. With
    use_similarity and a similarity_labels file every step is the
    SSLTrainStep, its 3 pairs drawn by np.random.default_rng(seed + epoch
    * 65536 + b) among the windows (as in JAX; use_similarity without
    labels trains the plain step). plot_every N (with a save_dir and a
    quantizer) writes codebook_tsne_ep{epoch:03d}.png every N epochs.
    Runs on CUDA unless device says otherwise."""
    streaming = hasattr(train_windows, "batches")
    if streaming and config.use_similarity:
        raise ValueError("use_similarity needs the in-RAM window array "
                         "(pair sampling indexes it)")
    mesh, dev = pmesh.trainer_mesh(config.mesh_shape, device)
    seed = max(config.random_seed, 0)
    model = init_model(make_seq_ae(config), seed, dev)
    if not streaming and train_windows.shape[-1] != model.rep_dim:
        # use_derivative: the JAX package's trainer fails the same way
        # (a parameter-shape error at its first step): neither package's
        # Part-b data appends the derivative
        raise ValueError(
            f"the windows are {train_windows.shape[-1]} wide, the model "
            f"takes {model.rep_dim} (rep_learning_dim "
            f"{config.rep_learning_dim}"
            f"{', doubled by use_derivative' if config.use_derivative else ''})")
    reason = model.decoder.kernel_reason()
    if dev.type == "cuda" and model.decoder.use_attention:
        model.decoder.use_kernel = False
        logging.info("validation decodes in plain PyTorch: %s", reason)
    elif dev.type == "cuda" and reason:
        raise ValueError(f"validation decodes through the chunk-decoder "
                         f"kernel on the card: {reason}")
    opt = Adam(model.parameters(), config.learning_rate)
    gen = torch.Generator(device=dev).manual_seed(seed)
    start_epoch = 0
    if resume_from:
        start_epoch, _ = checkpoints.restore_for_resume(model, opt, gen,
                                                        resume_from)
    pmesh.prepare_state(model, [opt], mesh)
    pairs = None
    if config.use_similarity and config.similarity_labels:
        if mesh is not None:
            raise ValueError("use_similarity training is single-device "
                             "(the reference has no distributed variant); "
                             "unset mesh_shape")
        pairs = read_gesture_labels(config.similarity_labels)
        logging.info("similarity-supervised: %d labelled pairs from %s",
                     len(pairs), config.similarity_labels)
    step = (SSLTrainStep if pairs is not None else TrainStep)(
        config, model, opt)
    n = len(train_windows) if streaming else train_windows.shape[0]
    bs = config.batch_size
    require_full_batch(n, bs, config.name)
    if mesh is not None:
        mesh.check_batch(bs)
    history: Dict[str, list] = {"train_loss": [], "val_loss": [],
                                "perplexity": []}
    meter = AverageMeter("loss", ":.4f")
    rvq_every = (config.rvq_reestimate_every
                 if config.autoencoder_vq and not streaming
                 and config.autoencoder_vq_variant == "rvq" else 0)
    for epoch in range(start_epoch, config.epochs):
        if rvq_every and epoch and epoch % rvq_every == 0:
            with pmesh.gathered(mesh, model):
                reestimate_rvq_codebooks(model, train_windows,
                                         config.autoencoder_vq_components,
                                         config.rvq_stages)
        meter.reset()
        t0 = time.time()
        if streaming:
            source = train_windows.batches(epoch, bs)
        else:
            perm = np.random.default_rng(seed + epoch).permutation(n)
            source = (train_windows[perm[b * bs:(b + 1) * bs]]
                      for b in range(n // bs))
        model.train()
        losses, perps = [], []
        for b, windows in enumerate(prefetch(
                source, device=dev, place=pmesh.batch_placer(mesh, dev))):
            batch = (windows,)
            if pairs is not None:
                pa, pb, pl = sample_pairs(pairs, 3, np.random.default_rng(
                    seed + epoch * 65536 + b), n)
                batch += tuple(to_device(a, dev) for a in (
                    train_windows[pa], train_windows[pb], pl))
            with dropout_generator(gen), pmesh.shard_context(mesh):
                loss, perp = step(*batch, float(epoch))[:2]
            losses.append(loss)
            perps.append(perp)
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
        history["perplexity"].append(float(torch.stack(perps).mean())
                                     if perps else float("nan"))
        model.eval()
        val = [float(pmesh.average(mesh, eval_step(config, model, to_device(
            pmesh.shard_batch(val_windows[s:s + bs], mesh), dev))))
            for s in range(0, val_windows.shape[0] - bs + 1, bs)]
        history["val_loss"].append(float(np.mean(val)) if val
                                   else float("nan"))
        logging.info("EP %d done: train %.5f val %.5f perp %.1f", epoch,
                     meter.avg, history["val_loss"][-1],
                     history["perplexity"][-1])
        plot = plot_every and save_dir and model.use_vq \
            and (epoch + 1) % plot_every == 0
        save = save_dir and ((epoch + 1) % save_every == 0
                             or epoch + 1 == config.epochs)
        if not (plot or save):
            continue
        with pmesh.gathered(mesh, model, opt):
            if not pmesh.is_main(mesh):
                continue
            if plot:
                from gesture2vec_tpu_torch.cluster.plots import \
                    plot_codebook_tsne
                plot_codebook_tsne(
                    model.vq_layer.codebook.detach().cpu().numpy(),
                    os.path.join(save_dir,
                                 f"codebook_tsne_ep{epoch + 1:03d}.png"),
                    title=f"{config.name} codebook ep{epoch + 1}")
            if save:
                _save(config, model, opt, gen, save_dir, epoch + 1)
    return pmesh.finish(mesh, model, opt), history


def _save(config: Config, model: SeqVQAutoencoder, opt: Adam,
          gen: torch.Generator, save_dir: str, epoch1: int) -> None:
    path = checkpoints.checkpoint_filename(save_dir, config.name, epoch1)
    v = to_jax_variables(model)
    checkpoints.save_checkpoint(
        path, config=config, epoch=epoch1, params=v["params"],
        pose_dim=model.rep_dim,
        extra={"batch_stats": v["batch_stats"], "parity": False,
               **checkpoints.resume_extra(model, opt, gen, config)},
        kind="autoencoder_vq" if model.use_vq else "autoencoder")
    logging.info("saved checkpoint %s", path)
