"""Weight bridge: the JAX package's variables -> the port's modules.

Input trees are nested dicts of numpy arrays in the JAX package's
layout (the `{"params": ..., "batch_stats": ...}` variables of its
Text2Token, SeqVQAutoencoder and DAE). Conversions:
  flax Dense kernel (in, out)       -> Linear weight (out, in)
  GRU l{n}_w_ih / w_hh / b_ih / b_hh -> copied, already torch layout
  pre_bn scale/bias + batch_stats    -> BatchNorm1d (eps 1e-5)
  TCN Conv_0.kernel (k, in, out) + WeightNorm scale
      -> w = kernel * rsqrt(sum_{k,in} kernel^2 + 1e-12) * scale,
         permuted to (out, in, k)
  downsample kernel (1, in, out)     -> (out, in, 1)
  BiGRU l{n}_w_ih[_reverse] ...       -> copied, already torch layout
  (the tokenizer's encoder, and the text encoder's masked biGRU)
  vq_layer codebook / codebook_r{s} / mean_layer / logvar_layer
                                     -> the quantizer, same names; the
                                        token decoder keeps codebook and
                                        codebook_r{s} too
  decoder_step out_layer_r{s} / stage_embed_{s}
                                     -> the residual-stage heads and the
                                        stage chain's embeddings
  transformer layer_{i} (ln_self, self_attn q/k/v/o, ln_cross,
  cross_attn, ln_mlp, mlp_in, mlp_out), final_ln, embed_proj,
  hidden_proj, decoder out_layer_r{s} / stage_embed_{s}
                                     -> the same names (LayerNorm scale
                                        -> weight); the transformer Part
                                        d, and the chunk encoder of a
                                        `seq_arch: transformer` tokenizer
Shapes (widths, layers, vocabulary, codes, stages, the text encoder, the
stage chain, attention, the architecture) are read from the arrays; what
the arrays cannot say (steps, teacher prefix, flatten mode, attention
heads) is passed in. `compat/
checkpoint.py` reads the JAX package's checkpoint files into these
trees.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
from gesture2vec_tpu_torch.models.dae import DAE
from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder, SeqVQAutoencoder
from gesture2vec_tpu_torch.models.text2token import Text2Token
from gesture2vec_tpu_torch.models.transformer import TransformerText2Token
from gesture2vec_tpu_torch.text.vocab import Vocab

Tree = Mapping[str, object]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


@torch.no_grad()
def _set(param: torch.Tensor, value: torch.Tensor) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit "
                         f"{tuple(param.shape)}")
    param.copy_(value)


def _dense(mod: nn.Linear, p: Tree) -> None:
    _set(mod.weight, _t(p["kernel"]).t())
    _set(mod.bias, _t(p["bias"]))


def _bn(mod: nn.BatchNorm1d, p: Tree, stats: Tree) -> None:
    _set(mod.weight, _t(p["scale"]))
    _set(mod.bias, _t(p["bias"]))
    _set(mod.running_mean, _t(stats["mean"]))
    _set(mod.running_var, _t(stats["var"]))


def _gru(mod: nn.Module, p: Tree) -> None:
    for name, param in mod.named_parameters():
        _set(param, _t(p[name]))


def _n_layers(gru: Tree) -> int:
    return sum(1 for k in gru if k.endswith("_w_hh"))


def _n_blocks(tree: Tree) -> int:
    return sum(1 for k in tree if k.startswith("layer_"))


def _ln(mod: nn.LayerNorm, p: Tree) -> None:
    _set(mod.weight, _t(p["scale"]))
    _set(mod.bias, _t(p["bias"]))


def _block(mod: nn.Module, p: Tree) -> None:
    """A transformer Block: LayerNorms, attention q/k/v/o and the MLP."""
    attns = ("self_attn", "cross_attn") if mod.cross else ("self_attn",)
    for ln in ("ln_self", "ln_mlp") + (("ln_cross",) if mod.cross else ()):
        _ln(getattr(mod, ln), p[ln])
    for attn in attns:
        for proj in "qkvo":
            _dense(getattr(getattr(mod, attn), proj), p[attn][proj])
    _dense(mod.mlp_in, p["mlp_in"])
    _dense(mod.mlp_out, p["mlp_out"])


def _fill_blocks(mod: nn.Module, p: Tree) -> None:
    if _n_blocks(p) != mod.n_layers:
        raise ValueError(f"{_n_blocks(p)} transformer blocks for "
                         f"{mod.n_layers} layers")
    for i in range(mod.n_layers):
        _block(getattr(mod, f"layer_{i}"), p[f"layer_{i}"])
    _ln(mod.final_ln, p["final_ln"])


def _stage_heads(mod: nn.Module, p: Tree) -> None:
    for s in range(mod.n_stage_heads):
        _dense(getattr(mod, f"out_layer_r{s + 1}"), p[f"out_layer_r{s + 1}"])
        if mod.stage_conditional:
            _set(getattr(mod, f"stage_embed_{s}").weight,
                 _t(p[f"stage_embed_{s}"]["embedding"]))


def _n_stages(vq: Tree) -> int:
    return 1 + sum(1 for k in vq if k.startswith("codebook_r"))


def _weight_norm_conv(conv: Tree, wn: Tree) -> torch.Tensor:
    k = np.asarray(conv["kernel"], np.float32)               # (k, in, out)
    scale = np.asarray(wn["Conv_0/kernel/scale"], np.float32)
    norm = (k * k).sum(axis=(0, 1), keepdims=True) + 1e-12
    w = k / np.sqrt(norm) * scale[None, None, :]
    return torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))


def text2token_from_jax(variables: Tree, *, n_steps: int,
                        n_pre_poses: int = 2) -> Text2Token:
    """A Text2Token from JAX variables: the TCN or the GRU text encoder,
    and the residual-stage heads (chained when the variables hold
    stage_embed_{s} tables)."""
    p = variables["params"]
    enc, dec = p["encoder"], p["decoder_step"]
    n_words, embed = np.shape(enc["embedding_table"])
    n_tokens, hidden = np.shape(dec["token_embedding"]["embedding"])
    encoder_type = "tcn" if "tcn" in enc else "gru"
    kernel_size = 2
    if encoder_type == "tcn":
        kernel_size = np.shape(enc["tcn"]["block0"]["conv1"]["Conv_0"]
                               ["kernel"])[0]
    model = Text2Token(
        n_words=n_words, n_tokens=n_tokens, hidden_size=hidden,
        n_layers=_n_layers(dec["gru"]), n_steps=n_steps,
        n_pre_poses=n_pre_poses, word_embed_size=embed,
        encoder_type=encoder_type, use_attention="attn" in dec,
        token_stages=1 + sum(1 for k in dec if k.startswith("out_layer_r")),
        kernel_size=kernel_size, stage_conditional="stage_embed_0" in dec)

    e = model.encoder
    _set(e.embedding_table.weight, _t(enc["embedding_table"]))
    if encoder_type == "gru":
        if _n_layers(enc["gru"]) != model.n_layers:
            raise ValueError(f"{_n_layers(enc['gru'])} encoder GRU layers "
                             f"for {model.n_layers} decoder layers")
        _gru(e.gru, enc["gru"])
    else:
        _fill_tcn(e, enc, model.n_layers)

    d = model.decoder_step
    _set(d.token_embedding.weight, _t(dec["token_embedding"]["embedding"]))
    if d.attn is not None:
        _dense(d.attn.attn, dec["attn"]["attn"])
        _set(d.attn.v, _t(dec["attn"]["v"]))
    _dense(d.pre_linear, dec["pre_linear"])
    _bn(d.pre_bn, dec["pre_bn"],
        variables["batch_stats"]["decoder_step"]["pre_bn"])
    _gru(d.gru, dec["gru"])
    _dense(d.out_layer, dec["out_layer"])
    _stage_heads(d, dec)
    return model.eval()


def transformer_text2token_from_jax(variables: Tree, *, n_steps: int,
                                    n_pre_poses: int = 2, n_heads: int = 4
                                    ) -> TransformerText2Token:
    """A TransformerText2Token from JAX variables (`t2t_arch:
    transformer`). n_heads is the config's `t2t_heads` (4 by default):
    the weights do not say it."""
    p = variables["params"]
    enc, dec = p["encoder"], p["decoder"]
    n_words, embed = np.shape(enc["embedding_table"])
    n_tokens, hidden = np.shape(dec["token_embedding"]["embedding"])
    if _n_blocks(dec) != _n_blocks(enc):
        raise ValueError(f"{_n_blocks(enc)} encoder blocks, "
                         f"{_n_blocks(dec)} decoder blocks")
    model = TransformerText2Token(
        n_words=n_words, n_tokens=n_tokens, hidden_size=hidden,
        n_layers=_n_blocks(enc), n_steps=n_steps, n_pre_poses=n_pre_poses,
        word_embed_size=embed, n_heads=n_heads,
        token_stages=1 + sum(1 for k in dec if k.startswith("out_layer_r")),
        stage_conditional="stage_embed_0" in dec)
    e, d = model.encoder, model.decoder
    _set(e.embedding_table.weight, _t(enc["embedding_table"]))
    _dense(e.embed_proj, enc["embed_proj"])
    _fill_blocks(e, enc)
    _set(d.token_embedding.weight, _t(dec["token_embedding"]["embedding"]))
    _fill_blocks(d, dec)
    _dense(d.out_layer, dec["out_layer"])
    _stage_heads(d, dec)
    return model.eval()


def is_transformer_text2token(variables: Tree) -> bool:
    """Whether Part-d variables are a transformer's (`decoder`) or the GRU
    model's (`decoder_step`)."""
    return "decoder" in variables["params"]


def _fill_tcn(e: nn.Module, enc: Tree, n_layers: int) -> None:
    blocks = sorted(enc["tcn"], key=lambda b: int(b[len("block"):]))
    if len(blocks) != n_layers:
        raise ValueError(f"{len(blocks)} TCN blocks for "
                         f"{n_layers} decoder layers")
    for block, name in zip(e.tcn.blocks, blocks):
        src = enc["tcn"][name]
        for conv in ("conv1", "conv2"):
            _set(getattr(block, conv).weight,
                 _weight_norm_conv(src[conv]["Conv_0"], src[conv]["wn"]))
            _set(getattr(block, conv).bias, _t(src[conv]["Conv_0"]["bias"]))
        if block.downsample is not None:
            _set(block.downsample.weight,
                 _t(src["downsample"]["kernel"]).permute(2, 1, 0))
            _set(block.downsample.bias, _t(src["downsample"]["bias"]))
    _dense(e.decoder, enc["decoder"])
    _dense(e.hidden_proj, enc["hidden_proj"])


def _fill_seq_decoder(model: SeqDecoder, variables: Tree) -> None:
    p = variables["params"]
    dec = p["decoder_step"]
    _set(model.codebook, _t(p["vq_layer"]["codebook"]))
    for i in range(1, model.stages):
        _set(getattr(model, f"codebook_r{i}"),
             _t(p["vq_layer"][f"codebook_r{i}"]))
    s = model.decoder_step
    _dense(s.pre_linear, dec["pre_linear"])
    _bn(s.pre_bn, dec["pre_bn"],
        variables["batch_stats"]["decoder_step"]["pre_bn"])
    _gru(s.gru, dec["gru"])
    _dense(s.out_layer, dec["out_layer"])


def seq_decoder_from_jax(variables: Tree, *, n_frames: int,
                         n_pre_poses: int = 1,
                         conditioned: bool = True) -> SeqDecoder:
    """The decoder half (codebooks + decoder step) of a JAX
    SeqVQAutoencoder; a residual-VQ one keeps every stage's codebook."""
    p = variables["params"]
    dec = p["decoder_step"]
    rep_dim, hidden = np.shape(dec["pre_linear"]["kernel"])
    vq = p["vq_layer"]
    model = SeqDecoder(rep_dim=rep_dim, hidden_size=hidden,
                       n_layers=_n_layers(dec["gru"]), n_frames=n_frames,
                       n_codes=np.shape(vq["codebook"])[0],
                       n_pre_poses=n_pre_poses, conditioned=conditioned,
                       stages=_n_stages(vq) if "mean_layer" not in vq
                       else 1)
    _fill_seq_decoder(model, variables)
    return model.eval()


def seq_ae_from_jax(variables: Tree, *, n_frames: int,
                    n_pre_poses: int = 1, conditioned: bool = True,
                    vq_flatten: str = "per_sample",
                    commitment_cost: float = 0.25) -> SeqVQAutoencoder:
    """A whole JAX SeqVQAutoencoder (BiGRU or transformer encoder, GS-Soft
    or residual quantizer, decoder). The encoder, the variant and the
    stage count come from the variables."""
    p = variables["params"]
    enc, vq = p["encoder"], p["vq_layer"]
    rep_dim, hidden = np.shape(enc["in_layer"]["kernel"])
    arch = "bigru" if "gru" in enc else "transformer"
    n_layers = _n_layers(enc["gru"]) if arch == "bigru" else _n_blocks(enc)
    rvq = "mean_layer" not in vq
    model = SeqVQAutoencoder(
        rep_dim=rep_dim, hidden_size=hidden, n_layers=n_layers,
        n_frames=n_frames, vq_components=np.shape(vq["codebook"])[0],
        n_pre_poses=n_pre_poses, vq_variant="rvq" if rvq else "gssoft",
        rvq_stages=_n_stages(vq), commitment_cost=commitment_cost,
        conditioned=conditioned, vq_flatten=vq_flatten, encoder_arch=arch)
    _dense(model.encoder.in_layer, enc["in_layer"])
    if arch == "bigru":
        _gru(model.encoder.gru, enc["gru"])
    else:
        _fill_blocks(model.encoder, enc)
        _dense(model.encoder.hidden_proj, enc["hidden_proj"])
    q = model.vq_layer
    if rvq:
        for name, param in q.named_parameters():
            _set(param, _t(vq[name]))
    else:
        _set(q.codebook, _t(vq["codebook"]))
        _dense(q.mean_layer, vq["mean_layer"])
        _dense(q.logvar_layer, vq["logvar_layer"])
    _fill_seq_decoder(model.decoder, variables)
    return model.eval()


def dae_from_jax(variables: Tree, *, motion_dim: int,
                 latent_dim: int) -> DAE:
    """A DAE from JAX variables (latent_dim -1 / -2 are the sentinels)."""
    model = DAE(motion_dim, latent_dim)
    if latent_dim != -1:
        p = variables["params"]
        _dense(model.encoder, p["encoder"])
        _dense(model.decoder, p["decoder"])
    return model.eval()


def generator_from_jax(t2t_variables: Tree, seq_variables: Tree,
                       dae_variables: Tree, vocab: Vocab,
                       pose_mean: np.ndarray, pose_std: np.ndarray, *,
                       n_frames: int = 20, sentence_frame_length: int = 120,
                       fps: int = 20, max_words: int = 48,
                       t2t_n_pre_poses: int = 2, t2t_heads: int = 4,
                       dae_latent_dim: Optional[int] = None,
                       device: Optional[Union[str, torch.device]] = None,
                       **gen_kwargs) -> GestureGenerator:
    """A GestureGenerator from the three JAX variable trees, with the
    same settings as the JAX package's GestureGenerator (mode,
    latent_bank, seed and the decode policies pass through gen_kwargs).
    The Part-d architecture comes from its variables (t2t_heads: a
    transformer's heads). dae_latent_dim None reads the latent width from
    the DAE weights."""
    motion_dim = np.shape(pose_mean)[0]
    n_steps = sentence_frame_length // n_frames
    if is_transformer_text2token(t2t_variables):
        t2t = transformer_text2token_from_jax(
            t2t_variables, n_steps=n_steps, n_pre_poses=t2t_n_pre_poses,
            n_heads=t2t_heads)
    else:
        t2t = text2token_from_jax(t2t_variables, n_steps=n_steps,
                                  n_pre_poses=t2t_n_pre_poses)
    if dae_latent_dim is None:
        dae_latent_dim = np.shape(dae_variables["params"]["decoder"]
                                  ["kernel"])[0]
    return GestureGenerator(
        t2t_model=t2t,
        seq_decoder=seq_decoder_from_jax(seq_variables, n_frames=n_frames),
        dae_model=dae_from_jax(dae_variables, motion_dim=motion_dim,
                               latent_dim=dae_latent_dim),
        vocab=vocab, pose_mean=pose_mean, pose_std=pose_std,
        n_frames=n_frames, sentence_frame_length=sentence_frame_length,
        fps=fps, max_words=max_words, device=device, **gen_kwargs)
