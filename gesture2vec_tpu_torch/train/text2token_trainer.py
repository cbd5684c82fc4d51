"""Part d trainer: text -> gesture-token translation.

Port of the JAX package's `train/text2token_trainer.py` for the GRU
Part d (`t2t_arch: gru`, the TCN or the GRU text encoder): the loss is
the gesture-token cross-entropy over positions 1.. (with
`label_smoothing` in training) of a train-mode forward, plus the
residual-stage heads' CE when token_stages > 1 (the stage chain reads
the teacher codes with stage_conditional); validation reports the plain
CE and the stage-0 accuracy. With `text_encoder: gru` the masked BiGRU's
recurrences run the GRU-sequence kernel and its backward kernel on the
card. The epoch loop is `train/token_loop.run_token_training`
(`keep_best` included).

Refused, each naming the ROADMAP.md queue A item that ports it:
`t2t_arch: transformer` training (3.1), `feedback_finetune_epochs` > 0
(3.6), `compute_dtype: bfloat16` (3.7).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.compat.from_jax import (flax_init,
                                                   to_jax_variables)
from gesture2vec_tpu_torch.device import resolve_device
from gesture2vec_tpu_torch.models.text2token import Text2Token
from gesture2vec_tpu_torch.train import checkpoints
from gesture2vec_tpu_torch.train.config import Config
from gesture2vec_tpu_torch.train.losses import stage_ce, token_cross_entropy
from gesture2vec_tpu_torch.train.optim import Adam, Step
from gesture2vec_tpu_torch.train.token_loop import run_token_training

_LATER = "{} is not ported yet (ROADMAP.md queue A item {})"


def make_text2token(config: Config, n_words: int) -> Text2Token:
    """The Part-d model of make_text2token in the JAX package
    (n_steps = sentence_frame_length // n_poses, tokens = the codebook
    size)."""
    refused = (
        (config.extras.get("t2t_arch", "gru") == "transformer",
         "t2t_arch: transformer training", "3.1"),
        (config.feedback_finetune_epochs > 0, "feedback_finetune_epochs",
         "3.6"),
        (config.compute_dtype != "float32", "compute_dtype: bfloat16",
         "3.7"))
    for cond, what, item in refused:
        if cond:
            raise NotImplementedError(_LATER.format(what, item))
    return Text2Token(
        n_words=n_words, n_tokens=config.autoencoder_vq_components,
        hidden_size=config.hidden_size, n_layers=config.n_layers,
        n_steps=config.sentence_frame_length // config.n_poses,
        n_pre_poses=config.n_pre_poses,
        word_embed_size=config.wordembed_dim,
        encoder_type=config.extras.get("text_encoder", "tcn"),
        use_attention=config.autoencoder_att,
        token_stages=config.token_stages,
        stage_conditional=config.stage_conditional,
        dropout_rate=config.dropout_prob)


@torch.no_grad()
def init_text2token(model: Text2Token, seed: int, device: torch.device,
                    embedding_weights: Optional[np.ndarray] = None
                    ) -> Text2Token:
    """The JAX package's initialisers; the word table is the vocabulary's
    vectors, or normal(1) without them."""
    gen = torch.Generator().manual_seed(seed)
    flax_init(model, gen)
    table = model.encoder.embedding_table.weight
    if embedding_weights is not None:
        table.copy_(torch.from_numpy(np.asarray(embedding_weights,
                                                np.float32)))
    else:
        table.copy_(torch.randn(table.shape, generator=gen))
    return model.to(device)


class TrainStep(Step):
    """The Part-d step on (word_ids, lengths, tokens[, stage_tokens])."""

    def __init__(self, model: Text2Token, opt: Adam,
                 label_smoothing: float = 0.0):
        self.model, self.opt = model, opt
        self.label_smoothing = label_smoothing

    def loss(self, word_ids, lengths, targets, stage=None) -> torch.Tensor:
        m = self.model
        kw = {"stage_targets": stage} if m.stage_conditional else {}
        res = m(word_ids, lengths, targets, **kw)
        loss = token_cross_entropy(res["logits"], targets,
                                   label_smoothing=self.label_smoothing)
        if m.token_stages > 1:
            loss = loss + stage_ce(res, stage)
        return loss


def make_eval_step(model: Text2Token):
    @torch.no_grad()
    def step(word_ids, lengths, targets, stage=None):
        res = model(word_ids, lengths, targets)
        loss = token_cross_entropy(res["logits"], targets)
        if model.token_stages > 1:
            loss = loss + stage_ce(res, stage)
        pred = torch.argmax(res["logits"], dim=-1)
        acc = (pred[:, 1:] == targets[:, 1:]).float().mean()
        return loss, acc, pred
    return step


def train_text2token(config: Config, data: Dict[str, np.ndarray],
                     val_data: Dict[str, np.ndarray], n_words: int,
                     embedding_weights: Optional[np.ndarray] = None,
                     lang_model_state: Optional[dict] = None,
                     save_dir: Optional[str] = None, save_every: int = 20,
                     log_every: int = 50, resume_from: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Tuple[Text2Token, Dict[str, list]]:
    """The Part-d loop over build_sentence_dataset's arrays; returns
    (model, history). Runs on CUDA unless device says otherwise."""
    dev = resolve_device(device)
    seed = max(config.random_seed, 0)
    model = init_text2token(make_text2token(config, n_words), seed, dev,
                            embedding_weights)
    opt = Adam(model.parameters(), config.learning_rate)
    gen = torch.Generator(device=dev).manual_seed(seed)
    start_epoch = 0
    if resume_from:
        start_epoch, _ = checkpoints.restore_for_resume(model, opt, gen,
                                                        resume_from)

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
            extra={"batch_stats": v["batch_stats"], "n_words": n_words,
                   **checkpoints.resume_extra(model, opt, gen, config)},
            kind="text2embedding")

    fields = ("word_ids", "lengths", "tokens")
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
        dev, save, save_every, log_every)
    return model, history
