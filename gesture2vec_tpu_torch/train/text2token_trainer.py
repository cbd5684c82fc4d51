"""Part d trainer: text -> gesture-token translation.

Port of the JAX package's `train/text2token_trainer.py`, both
architectures: the GRU Part d (`t2t_arch: gru`, the TCN or the GRU text
encoder) and the transformer (`t2t_arch: transformer`, `t2t_heads`
heads, the recommended recipe's). The loss is the gesture-token
cross-entropy over positions 1.. (with `label_smoothing` in training) of
a train-mode forward, plus the residual-stage heads' CE when
token_stages > 1 (the stage chain reads the teacher codes with
stage_conditional); the transformer's train-mode forward is its
teacher-forced parallel pass. Validation reports the plain CE and the
stage-0 accuracy. With `text_encoder: gru` the masked BiGRU's
recurrences run the GRU-sequence kernel and its backward kernel on the
card. The epoch loop is `train/token_loop.run_token_training`
(`keep_best` included).

`feedback_finetune_epochs` N > 0 trains the last N epochs with
`FeedbackTrainStep` (JAX `make_feedback_train_step`): the decode-time
rollout in eval mode (no dropout, BatchNorm on its running statistics)
with grad enabled, each step feeding back the model's own argmax, or at
`feedback_temperature` > 0 a sample whose Gumbel noise is drawn from the
trainer's generator, and the CE against the ground-truth codes.

`compute_dtype: bfloat16` builds the model in bf16 (`models/text2token`,
`models/transformer`), for the training step and the feedback finetune
alike, as JAX builds both with the compute dtype: on the card the GRU
text encoder runs the bf16 GRU kernels; the logits, the CE, parameters,
Adam's state and checkpoints stay fp32.

A config's mesh_shape trains over a mesh (`parallel/mesh`, its ranks
started by `parallel/launch.spmd`): each dp rank takes its rows of every
global batch (the feedback step's Gumbel noise drawn at the global
batch's shape), the word table is row-sharded over tp, rank 0 writes the
checkpoints.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.compat.from_jax import (flax_init,
                                                   to_jax_variables)
from gesture2vec_tpu_torch.models.layers import compute_dtype, global_draw
from gesture2vec_tpu_torch.models.text2token import Text2Token, gumbel_noise
from gesture2vec_tpu_torch.models.transformer import TransformerText2Token
from gesture2vec_tpu_torch.train import checkpoints
from gesture2vec_tpu_torch.parallel import mesh as pmesh
from gesture2vec_tpu_torch.parallel.launch import spmd
from gesture2vec_tpu_torch.train.config import Config
from gesture2vec_tpu_torch.train.losses import stage_ce, token_cross_entropy
from gesture2vec_tpu_torch.train.optim import Adam, Step
from gesture2vec_tpu_torch.train.token_loop import run_token_training


Part = Union[Text2Token, TransformerText2Token]


def make_text2token(config: Config, n_words: int) -> Part:
    """The Part-d model of make_text2token in the JAX package
    (n_steps = sentence_frame_length // n_poses, tokens = the codebook
    size): the transformer for `t2t_arch: transformer`, else the GRU
    model; the compute dtype from `compute_dtype`."""
    dtype = compute_dtype(config.compute_dtype)
    n_steps = config.sentence_frame_length // config.n_poses
    if config.extras.get("t2t_arch", "gru") == "transformer":
        return TransformerText2Token(
            n_words=n_words, n_tokens=config.autoencoder_vq_components,
            hidden_size=config.hidden_size, n_layers=config.n_layers,
            n_steps=n_steps, n_pre_poses=config.n_pre_poses,
            word_embed_size=config.wordembed_dim,
            n_heads=int(config.extras.get("t2t_heads", 4)),
            token_stages=config.token_stages,
            stage_conditional=config.stage_conditional,
            dropout_rate=config.dropout_prob, compute_dtype=dtype)
    return Text2Token(
        n_words=n_words, n_tokens=config.autoencoder_vq_components,
        hidden_size=config.hidden_size, n_layers=config.n_layers,
        n_steps=n_steps, n_pre_poses=config.n_pre_poses,
        word_embed_size=config.wordembed_dim,
        encoder_type=config.extras.get("text_encoder", "tcn"),
        use_attention=config.autoencoder_att,
        token_stages=config.token_stages,
        stage_conditional=config.stage_conditional,
        dropout_rate=config.dropout_prob, compute_dtype=dtype)


@torch.no_grad()
def init_text2token(model: Part, seed: int, device: torch.device,
                    embedding_weights: Optional[np.ndarray] = None
                    ) -> Part:
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
    """The Part-d step on (word_ids, lengths, tokens[, stage_tokens]),
    either architecture (the transformer has no BatchNorm)."""

    def __init__(self, model: Part, opt: Adam,
                 label_smoothing: float = 0.0):
        self.model, self.opt = model, opt
        self.label_smoothing = label_smoothing

    def loss(self, word_ids, lengths, targets, stage=None) -> torch.Tensor:
        m = self.model
        kw = {"stage_targets": stage} if m.stage_conditional else {}
        return self.ce(m(word_ids, lengths, targets, **kw), targets, stage)

    def ce(self, res: Dict[str, torch.Tensor], targets: torch.Tensor,
           stage: Optional[torch.Tensor]) -> torch.Tensor:
        loss = token_cross_entropy(res["logits"], targets,
                                   label_smoothing=self.label_smoothing)
        if self.model.token_stages > 1:
            loss = loss + stage_ce(res, stage)
        return loss


class FeedbackTrainStep(TrainStep):
    """The feedback-matched finetune step (JAX make_feedback_train_step):
    the decode-time rollout, the model in eval mode with grad enabled,
    its own argmax fed back after the teacher prefix (and the stage chain
    conditioned on its own choices), the CE against the ground-truth
    codes; the integer feedback carries no gradient. At temperature > 0
    the feedback is sampled: gumbel (B, n_steps - 1, token_stages, K) is
    its noise, drawn from generator (on its device) when not given."""

    def __init__(self, model: Part, opt: Adam, label_smoothing: float = 0.0,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(model, opt, label_smoothing)
        self.temperature, self.generator = temperature, generator

    def loss(self, word_ids, lengths, targets, stage=None,
             gumbel=None) -> torch.Tensor:
        m = self.model
        kw = {}
        if self.temperature > 0.0:
            if gumbel is None:
                gumbel = global_draw(
                    lambda shape: gumbel_noise(shape, self.generator),
                    (targets.shape[0], m.n_steps - 1, m.token_stages,
                     m.n_tokens))
            kw = {"temperature": self.temperature,
                  "gumbel": gumbel.to(targets.device)}
        was = m.training
        m.eval()
        try:
            res = m(word_ids, lengths, targets, **kw)
        finally:
            m.train(was)
        return self.ce(res, targets, stage)


def make_eval_step(model: Part):
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


@spmd
def train_text2token(config: Config, data: Dict[str, np.ndarray],
                     val_data: Dict[str, np.ndarray], n_words: int,
                     embedding_weights: Optional[np.ndarray] = None,
                     lang_model_state: Optional[dict] = None,
                     save_dir: Optional[str] = None, save_every: int = 20,
                     log_every: int = 50, resume_from: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Tuple[Part, Dict[str, list]]:
    """The Part-d loop over build_sentence_dataset's arrays; returns
    (model, history). Runs on CUDA unless device says otherwise."""
    mesh, dev = pmesh.trainer_mesh(config.mesh_shape, device)
    seed = max(config.random_seed, 0)
    model = init_text2token(make_text2token(config, n_words), seed, dev,
                            embedding_weights)
    opt = Adam(model.parameters(), config.learning_rate)
    gen = torch.Generator(device=dev).manual_seed(seed)
    start_epoch = 0
    if resume_from:
        start_epoch, _ = checkpoints.restore_for_resume(model, opt, gen,
                                                        resume_from)
    pmesh.prepare_state(model, [opt], mesh)

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
    late, late_from = None, None
    if config.feedback_finetune_epochs > 0:
        late_from = max(0, config.epochs - config.feedback_finetune_epochs)
        late = FeedbackTrainStep(model, opt, config.label_smoothing,
                                 config.feedback_temperature, gen)
    history = run_token_training(
        config, model, opt, gen, start_epoch, fields, data, val_data,
        TrainStep(model, opt, config.label_smoothing), make_eval_step(model),
        dev, save, save_every, log_every, train_step_late=late,
        late_from_epoch=late_from, mesh=mesh)
    return pmesh.finish(mesh, model, opt), history
