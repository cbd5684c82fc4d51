"""The JAX package's checkpoint files -> the port's models.

A checkpoint (`train/checkpoints.save_checkpoint` in the JAX package) is
one flax msgpack tree:
    {"args": <config dict, with "extras">, "epoch": int, "pose_dim": int,
     "lang_model": ..., "kind": str, "params": <flax params>,
     "extra": {"batch_stats": ..., "parity": ..., ...}}
`load_checkpoint` reads it with `utils/mpack` (no flax, msgpack or yaml)
and merges `extras` into the config, as the JAX loader does. The
constructors mirror the JAX registry for the kinds the Part-c path loads:
  DAE             `dae_trainer.make_frame_model`: a VQFrame
                  (autoencoder_vq; with the VAE heads under
                  autoencoder_vae; batch_stats and extra["vq_state"] when
                  the file holds them), else a VAEFrame (autoencoder_vae),
                  else a plain DAE (motion_dim = input_motion_dim, latent
                  = hidden_size);
  autoencoder_vq  `seq_ae_trainer.make_seq_ae`: the gesture tokenizer,
  (autoencoder)   vq_flatten "torch_view" when extra["parity"], and then
                  eval_step_dropout as the config's eval_dropout_quirk
                  (default true) says, fp32; the BiGRU or (extras
                  "seq_arch: transformer") the transformer chunk encoder;
                  the VAE heads, the input width (use_derivative) and the
                  decoder attention (autoencoder_att) as the weights hold
                  them; a tokenizer without a quantizer is refused (it
                  gives no tokens);
  text2embedding  `text2token_trainer._build_t2t` / `make_text2token`: the
                  Part-d model, n_words from extra, the architecture
                  (extras "t2t_arch": the GRU model, or the transformer
                  with "t2t_heads" heads), the text encoder (extras
                  "text_encoder"), token_stages, stage_conditional and
                  autoencoder_att (decoder attention) from the config,
                  fp32 whatever the training dtype;
  audio2token     `audio2token_trainer._build_a2t`: the audio Part d,
                  audio_fusion ("both": n_words from extra, and the file
                  carries the vocabulary in lang_model), token_stages,
                  stage_conditional and autoencoder_att (the token
                  decoder's attention) from the config, fp32.
  baseline, c2g,  `misc_trainers._build_baseline` / `_build_c2g`,
  text2embedding_ `gan_trainer._build_gan_generator`: the Seq2SeqNet,
  gan             the Cluster2Gesture (parity_frozen_hidden off, as the
                  JAX maker builds it) and the GAN's generator, widths
                  from the weights (held against the config's and the
                  file's n_words and pose_dim), n_poses and n_pre_poses
                  from the config, fp32.
Each maker holds what the config says against what the weights hold.
Every model loaded here computes in fp32 (`compute_dtype` None) and
`load_checkpoint_and_model` sets the payload config's `compute_dtype` to
"float32", as the JAX registry does: a checkpoint trained with
`compute_dtype: bfloat16` (its parameters are fp32) generates through the
fp32 kernels.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from gesture2vec_tpu_torch.compat.from_jax import (
    audio2token_from_jax, baseline_from_jax, c2g_from_jax,
    frame_model_from_jax, gan_generator_from_jax, is_transformer_text2token,
    seq_ae_from_jax, text2token_from_jax, transformer_text2token_from_jax)
from gesture2vec_tpu_torch.device import resolve_device
from gesture2vec_tpu_torch.utils import mpack

def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload, with payload["config"] the run's config as a dict
    (the args with their extras merged in)."""
    with open(path, "rb") as f:
        payload = mpack.unpackb(f.read())
    args = dict(payload["args"])
    extras = args.pop("extras", {}) or {}
    payload["config"] = {**args, **extras}
    return payload


def dae_from_checkpoint(payload: Dict[str, Any]) -> nn.Module:
    cfg, extra = payload["config"], payload["extra"]
    vq = bool(cfg.get("autoencoder_vq", False))
    return frame_model_from_jax(
        {"params": payload["params"],
         "batch_stats": extra.get("batch_stats", {})},
        motion_dim=int(cfg["input_motion_dim"]),
        latent_dim=int(cfg["hidden_size"]),
        vq_components=int(cfg.get("autoencoder_vq_components", 512)) if vq
        else 0, vae=bool(cfg.get("autoencoder_vae", False)),
        commitment_cost=float(cfg.get("autoencoder_vq_commitment_cost",
                                      0.25)),
        vq_state=extra.get("vq_state"))


def seq_ae_from_checkpoint(payload: Dict[str, Any]) -> nn.Module:
    cfg = payload["config"]
    if not cfg.get("autoencoder_vq", False):
        raise ValueError("the checkpoint has no quantizer "
                         "(autoencoder_vq is false): it gives no tokens")
    parity = bool(payload["extra"].get("parity", False))
    variables = {"params": payload["params"],
                 "batch_stats": payload["extra"].get("batch_stats", {})}
    model = seq_ae_from_jax(
        variables, n_frames=int(cfg["n_poses"]),
        n_pre_poses=int(cfg["n_pre_poses"]),
        conditioned=cfg.get("autoencoder_conditioned", True),
        vq_flatten="torch_view" if parity else "per_sample",
        commitment_cost=float(cfg["autoencoder_vq_commitment_cost"]),
        eval_step_dropout=bool(cfg.get("eval_dropout_quirk", True))
        and parity)
    # the JAX package builds the transformer for "transformer", else the
    # BiGRU
    want = "transformer" if cfg.get("seq_arch") == "transformer" \
        else "bigru"
    if model.encoder_arch != want:
        raise ValueError(f"the checkpoint's config says seq_arch {want}, "
                         f"its weights hold {model.encoder_arch}")
    att = bool(cfg.get("autoencoder_att", False))
    if model.decoder.use_attention != att:
        raise ValueError(f"the checkpoint's config says autoencoder_att "
                         f"{att}, its weights say "
                         f"{model.decoder.use_attention}")
    return model


# the JAX package's Config defaults for the Part-d fields read here
T2T_CONFIG_DEFAULTS = {"n_poses": 50, "n_pre_poses": 5,
                 "sentence_frame_length": 120, "autoencoder_att": False,
                 "token_stages": 1, "stage_conditional": False,
                 "text_encoder": "tcn", "t2t_arch": "gru", "t2t_heads": 4}


def text2token_from_checkpoint(payload: Dict[str, Any]) -> nn.Module:
    cfg = {**T2T_CONFIG_DEFAULTS, **payload["config"]}
    variables = {"params": payload["params"],
                 "batch_stats": payload["extra"].get("batch_stats", {})}
    kw = dict(n_steps=int(cfg["sentence_frame_length"])
              // int(cfg["n_poses"]), n_pre_poses=int(cfg["n_pre_poses"]))
    stages = int(cfg["token_stages"])
    want = {"arch": "transformer" if cfg["t2t_arch"] == "transformer"
            else "gru", "n_words": int(payload["extra"]["n_words"]),
            "token_stages": stages,
            "stage_conditional": bool(cfg["stage_conditional"])
            and stages > 1}
    if is_transformer_text2token(variables):
        model = transformer_text2token_from_jax(
            variables, n_heads=int(cfg["t2t_heads"]), **kw)
        got = {"arch": "transformer"}
    else:
        model = text2token_from_jax(variables, **kw)
        want.update(text_encoder=cfg["text_encoder"],
                    autoencoder_att=bool(cfg["autoencoder_att"]))
        got = {"arch": "gru", "text_encoder": model.encoder_type,
               "autoencoder_att": model.decoder_step.use_attention}
    got.update(n_words=model.encoder.embedding_table.num_embeddings,
               token_stages=model.token_stages,
               stage_conditional=model.stage_conditional)
    if got != want:
        raise ValueError(f"the checkpoint's config says {want}, its "
                         f"weights hold {got}")
    return model


def audio2token_from_checkpoint(payload: Dict[str, Any]) -> nn.Module:
    cfg = {**T2T_CONFIG_DEFAULTS, "audio_fusion": "audio",
           **payload["config"]}
    variables = {"params": payload["params"],
                 "batch_stats": payload["extra"].get("batch_stats", {})}
    model = audio2token_from_jax(
        variables, n_steps=int(cfg["sentence_frame_length"])
        // int(cfg["n_poses"]), n_pre_poses=int(cfg["n_pre_poses"]))
    stages = int(cfg["token_stages"])
    both = cfg["audio_fusion"] == "both"
    want = {"fusion": cfg["audio_fusion"],
            "n_words": int(payload["extra"].get("n_words", 0)) if both
            else 0, "token_stages": stages,
            "stage_conditional": bool(cfg["stage_conditional"])
            and stages > 1, "autoencoder_att": bool(cfg["autoencoder_att"])}
    got = {"fusion": model.fusion,
           "n_words": model.encoder.embedding.num_embeddings if both
           else 0, "token_stages": model.token_stages,
           "stage_conditional": model.stage_conditional,
           "autoencoder_att": model.decoder_step.use_attention}
    if got != want:
        raise ValueError(f"the checkpoint's config says {want}, its "
                         f"weights hold {got}")
    return model


# the JAX package's Config defaults for the fields the baseline, c2g and
# GAN makers read
MISC_CONFIG_DEFAULTS = {"n_poses": 50, "n_pre_poses": 5, "hidden_size": 200,
                        "n_layers": 2, "noise_dim": 200}


def _check_misc(model: nn.Module, cfg: Dict[str, Any], payload, kind: str
                ) -> nn.Module:
    """Holds the config's widths (and the file's n_words and pose_dim)
    against the weights."""
    want = {"hidden_size": int(cfg["hidden_size"]),
            "n_layers": int(cfg["n_layers"]),
            "pose_dim": int(payload["pose_dim"])}
    if kind == "c2g":
        got = {"hidden_size": model.pre_gru.hidden_size,
               "n_layers": model.pre_gru.n_layers,
               "pose_dim": model.output_size}
    else:
        enc = model.encoder
        got = {"hidden_size": enc.hidden_size, "n_layers": enc.gru.n_layers,
               "pose_dim": model.pose_dim,
               "n_words": enc.embedding_table.num_embeddings}
        want["n_words"] = int(payload["extra"]["n_words"])
    if kind == "text2embedding_gan":
        got["noise_dim"] = model.noise_dim
        want["noise_dim"] = int(cfg["noise_dim"])
    if got != want:
        raise ValueError(f"the {kind} checkpoint's config says {want}, its "
                         f"weights hold {got}")
    return model


def misc_from_checkpoint(kind: str):
    """The maker of the baseline's (Seq2SeqNet), c2g's (Cluster2Gesture)
    or the GAN generator's (T2GGenerator) checkpoint kind."""
    def make(payload: Dict[str, Any]) -> nn.Module:
        cfg = {**MISC_CONFIG_DEFAULTS, **payload["config"]}
        variables = {"params": payload["params"],
                     "batch_stats": payload["extra"].get("batch_stats", {})}
        n_frames = int(cfg["n_poses"])
        if kind == "baseline":
            model = baseline_from_jax(variables, n_frames=n_frames,
                                      n_pre_poses=int(cfg["n_pre_poses"]))
        elif kind == "c2g":
            model = c2g_from_jax(variables, n_frames=n_frames)
        else:
            model = gan_generator_from_jax(variables, n_frames=n_frames)
        return _check_misc(model, cfg, payload, kind)
    return make


_MAKERS = {"DAE": dae_from_checkpoint,
           "autoencoder_vq": seq_ae_from_checkpoint,
           "autoencoder": seq_ae_from_checkpoint,
           "text2embedding": text2token_from_checkpoint,
           "audio2token": audio2token_from_checkpoint,
           **{kind: misc_from_checkpoint(kind)
              for kind in ("baseline", "c2g", "text2embedding_gan")}}


def load_checkpoint_and_model(path: str, what: str,
                              device: Optional[Union[str, torch.device]]
                              = None) -> Tuple[nn.Module, Dict[str, Any]]:
    """(model in eval mode on the device, payload). `what` is the JAX
    registry kind; a checkpoint saved as another kind is loaded with a
    warning, as the JAX loader does. Runs on CUDA unless device says
    otherwise."""
    dev = resolve_device(device)
    if what not in _MAKERS:
        raise KeyError(f"unknown checkpoint kind {what!r}; known: "
                       f"{sorted(_MAKERS)}")
    payload = load_checkpoint(path)
    # registry loads serve inference: fp32 whatever the training dtype
    payload["config"]["compute_dtype"] = "float32"
    stored = payload.get("kind", "")
    alias = {"autoencoder": "autoencoder_vq"}
    if stored and alias.get(stored, stored) != alias.get(what, what):
        logging.warning("%s was saved as kind=%r but is being loaded as "
                        "%r - wrong checkpoint passed?", path, stored, what)
    model = _MAKERS[what](payload)
    return model.to(dev).eval(), payload
