"""The audio-context Part d's trainer: speech windows -> gesture tokens.

Port of the JAX package's `train/audio2token_trainer.py`. The loss is the
gesture-token cross-entropy over positions 1.. (with `label_smoothing`)
of a train-mode forward, plus the residual-stage heads' CE when
token_stages > 1 (the stage chain reading the teacher codes with
stage_conditional); validation reports the plain CE and the stage-0
accuracy. The batch is (mel (B, seconds, 128, frames), tokens[,
stage_tokens]) for audio_fusion "audio", (word_ids, wav (B, seconds,
16000), tokens[, stage_tokens]) for "both". On the card the encoder
BiGRU's recurrences run the GRU-sequence kernel's gate-saving variant (4
launches a step) and its backward kernel (4). Checkpoints are the JAX
package's kind "audio2token" files (optax's state in extra), which
either package resumes. `compute_dtype: bfloat16` builds the model in
bf16 (`models/audio2token`): the encoder BiGRU then runs the bf16
instantiations of both GRU kernels; parameters, Adam's state and
checkpoints stay fp32. A config's mesh_shape trains over a mesh
(`parallel/mesh`, its ranks started by `parallel/launch.spmd`): each dp
rank takes its rows of every global batch; rank 0 writes the
checkpoints.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.compat.from_jax import (flax_init,
                                                   to_jax_variables)
from gesture2vec_tpu_torch.models.layers import compute_dtype
from gesture2vec_tpu_torch.models.audio2token import Audio2Token
from gesture2vec_tpu_torch.train import checkpoints
from gesture2vec_tpu_torch.parallel import mesh as pmesh
from gesture2vec_tpu_torch.parallel.launch import spmd
from gesture2vec_tpu_torch.train.config import Config
from gesture2vec_tpu_torch.train.losses import stage_ce, token_cross_entropy
from gesture2vec_tpu_torch.train.optim import Adam, Step
from gesture2vec_tpu_torch.train.token_loop import run_token_training


def make_audio2token(config: Config, n_words: int = 0) -> Audio2Token:
    """The JAX package's make_audio2token: n_words (the vocabulary's size)
    is needed with audio_fusion "both"; the compute dtype from
    `compute_dtype`."""
    if config.audio_fusion == "both" and n_words <= 0:
        raise ValueError("audio_fusion='both' needs n_words > 0")
    return Audio2Token(
        n_tokens=config.autoencoder_vq_components,
        hidden_size=config.hidden_size, n_layers=config.n_layers,
        n_steps=config.sentence_frame_length // config.n_poses,
        n_pre_poses=config.n_pre_poses, use_attention=config.autoencoder_att,
        fusion=config.audio_fusion, n_words=n_words,
        embed_size=config.wordembed_dim, token_stages=config.token_stages,
        stage_conditional=config.stage_conditional,
        dropout_rate=config.dropout_prob,
        compute_dtype=compute_dtype(config.compute_dtype))


@torch.no_grad()
def init_audio2token(model: Audio2Token, seed: int,
                     device: torch.device) -> Audio2Token:
    """The JAX package's initialisers, drawn from a seeded generator."""
    flax_init(model, torch.Generator().manual_seed(seed))
    return model.to(device)


class TrainStep(Step):
    """The audio Part-d step on (*encoder inputs, tokens[,
    stage_tokens])."""

    def __init__(self, model: Audio2Token, opt: Adam,
                 label_smoothing: float = 0.0):
        self.model, self.opt = model, opt
        self.label_smoothing = label_smoothing

    def loss(self, *batch) -> torch.Tensor:
        m = self.model
        enc_in, targets, stage = split_batch(m, batch)
        kw = {"stage_targets": stage} if m.stage_conditional else {}
        res = m(enc_in, targets, **kw)
        loss = token_cross_entropy(res["logits"], targets,
                                   label_smoothing=self.label_smoothing)
        if m.token_stages > 1:
            loss = loss + stage_ce(res, stage)
        return loss


def split_batch(model: Audio2Token, batch):
    """(encoder inputs, tokens, stage_tokens or None) of a batch."""
    n_enc = 2 if model.fusion == "both" else 1
    enc_in = batch[0] if n_enc == 1 else tuple(batch[:2])
    rest = batch[n_enc:]
    return enc_in, rest[0], rest[1] if len(rest) > 1 else None


def make_eval_step(model: Audio2Token):
    @torch.no_grad()
    def step(*batch):
        enc_in, targets, stage = split_batch(model, batch)
        res = model(enc_in, targets)
        loss = token_cross_entropy(res["logits"], targets)
        if model.token_stages > 1:
            loss = loss + stage_ce(res, stage)
        pred = torch.argmax(res["logits"], dim=-1)
        acc = (pred[:, 1:] == targets[:, 1:]).float().mean()
        return loss, acc, pred
    return step


@spmd
def train_audio2token(config: Config, data: Dict[str, np.ndarray],
                      val_data: Dict[str, np.ndarray],
                      save_dir: Optional[str] = None, save_every: int = 20,
                      log_every: int = 50, resume_from: Optional[str] = None,
                      n_words: int = 0,
                      lang_model_state: Optional[dict] = None,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Tuple[Audio2Token, Dict[str, list]]:
    """The audio Part-d loop over build_sentence_dataset's arrays ({mel,
    tokens} for audio_fusion "audio"; {word_ids, wav, tokens} and
    n_words, with the vocabulary's lang_model_state saved for inference,
    for "both"); returns (model, history). Runs on CUDA unless device
    says otherwise."""
    mesh, dev = pmesh.trainer_mesh(config.mesh_shape, device)
    seed = max(config.random_seed, 0)
    model = init_audio2token(make_audio2token(config, n_words), seed, dev)
    opt = Adam(model.parameters(), config.learning_rate)
    gen = torch.Generator(device=dev).manual_seed(seed)
    start_epoch = 0
    if resume_from:
        start_epoch, _ = checkpoints.restore_for_resume(model, opt, gen,
                                                        resume_from)
    pmesh.prepare_state(model, [opt], mesh)
    both = model.fusion == "both"
    audio_key = "wav" if both else "mel"

    def save(epoch1: int, tag: Optional[str] = None) -> None:
        if not save_dir:
            return
        path = checkpoints.checkpoint_filename(save_dir, config.name,
                                               tag if tag else epoch1)
        v = to_jax_variables(model)
        checkpoints.save_checkpoint(
            path, config=config, epoch=epoch1, params=v["params"],
            pose_dim=config.autoencoder_vq_components,
            lang_model=lang_model_state,
            extra={"batch_stats": v["batch_stats"],
                   "mel_shape": list(data[audio_key].shape[1:]),
                   "n_words": n_words,
                   **checkpoints.resume_extra(model, opt, gen, config)},
            kind="audio2token")

    fields = (("word_ids", "wav", "tokens") if both
              else ("mel", "tokens"))
    if config.token_stages > 1:
        if "stage_tokens" not in data:
            raise ValueError("token_stages > 1 needs stage_tokens in the "
                             "dataset (build_sentence_dataset "
                             "emit_stage_tokens=True over a residual-VQ "
                             "Part-b tokenizer)")
        fields = fields + ("stage_tokens",)
    history = run_token_training(
        config, model, opt, gen, start_epoch, fields, data, val_data,
        TrainStep(model, opt, config.label_smoothing), make_eval_step(model),
        dev, save, save_every, log_every, mesh=mesh)
    return pmesh.finish(mesh, model, opt), history
