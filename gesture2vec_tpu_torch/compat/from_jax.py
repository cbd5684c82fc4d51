"""Weight bridge: the JAX package's variables -> the port's modules.

Input trees are nested dicts of numpy arrays in the JAX package's
layout (the `{"params": ..., "batch_stats": ...}` variables of its
Text2Token, SeqVQAutoencoder and DAE). Conversions:
  flax Dense kernel (in, out)       -> Linear weight (out, in)
  GRU l{n}_w_ih / w_hh / b_ih / b_hh -> copied, already torch layout
  pre_bn scale/bias + batch_stats    -> BatchNorm1d (eps 1e-5)
  TCN Conv_0.kernel (k, in, out) + WeightNorm scale
      -> the weight-normalised conv's kernel, permuted to (out, in, k),
         and scale
  downsample kernel (1, in, out)     -> (out, in, 1)
  BiGRU l{n}_w_ih[_reverse] ...       -> copied, already torch layout
  (the tokenizer's encoder, and the text encoder's masked biGRU)
  vq_layer codebook / codebook_r{s} / mean_layer / logvar_layer
                                     -> the quantizer, same names; the
                                        token decoder keeps codebook and
                                        codebook_r{s} too
  decoder_step attn (the attn Dense and v)
                                     -> the token decoder's and the
                                        Part-b decoder's (autoencoder_att)
                                        Bahdanau attention
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
  Audio2Token encoder: wav_encoder conv{i} kernel (k, in, out) + bias,
  bn{i} / fc_bn (batch_stats too), fc / out_layer, the fusion's
  embedding, the BiGRU         -> the same names (convs permuted to
                                  (out, in, k)); the decoder step as the
                                  text model's
  Seq2SeqNet (baseline), Cluster2Gesture (c2g), T2GGenerator and
  T2GDiscriminator (the GAN): encoder / text_encoder (embedding_table,
  the masked BiGRU), decoder_step / step (attention, pre_linear, pre_bn
  with batch_stats, the GRU stack, out_layer), embedding, pre_gru and
  pose_gru (l{n}_*), fuse, pose_in, head layers_0 / layers_2
                                     -> the same names
The other way, for training: `param_entries` lists a trainable port
model's parameters with their JAX path, layout and initialiser;
`to_jax_variables` / `load_jax_variables` carry params and batch_stats
across, `jax_tree` any per-parameter tensors (gradients, Adam moments),
and `flax_init` initialises a model as the JAX package would. The
Part-a models cover the DAE, `VAEFrame` and `VQFrame` (its BatchNorm
`bn` in batch_stats; its EMA state, the JAX package's `VQEmaState` dict
{"codebook", "cluster_size", "ema_w"} in a checkpoint's
extra["vq_state"], through `ema_state_to_jax` / `load_ema_state`).
Shapes (widths, layers, vocabulary, codes, stages, the text encoder, the
stage chain, attention, the architecture) are read from the arrays; what
the arrays cannot say (steps, teacher prefix, flatten mode, attention
heads) is passed in. `compat/
checkpoint.py` reads the JAX package's checkpoint files into these
trees.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
from gesture2vec_tpu_torch.models.audio import (AudioContextEncoder,
                                               AudioTextFusionEncoder,
                                               WavEncoderRaw,
                                               WavEncoderSpectral,
                                               WavEncoderTri)
from gesture2vec_tpu_torch.models.audio2token import Audio2Token
from gesture2vec_tpu_torch.models.baseline import Seq2SeqNet
from gesture2vec_tpu_torch.models.c2g import Cluster2Gesture
from gesture2vec_tpu_torch.models.dae import DAE, VAEFrame, VQFrame
from gesture2vec_tpu_torch.models.gan import T2GDiscriminator, T2GGenerator
from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder, SeqVQAutoencoder
from gesture2vec_tpu_torch.models.text2token import Text2Token
from gesture2vec_tpu_torch.models.transformer import TransformerText2Token
from gesture2vec_tpu_torch.models.vq import VQEmaState, init_ema_state
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
            mod = getattr(block, conv)
            _set(mod.kernel, _t(src[conv]["Conv_0"]["kernel"]).permute(
                2, 1, 0))
            _set(mod.scale, _t(src[conv]["wn"]["Conv_0/kernel/scale"]))
            _set(mod.bias, _t(src[conv]["Conv_0"]["bias"]))
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
    if s.attn is not None:
        _dense(s.attn.attn, dec["attn"]["attn"])
        _set(s.attn.v, _t(dec["attn"]["v"]))
    _dense(s.pre_linear, dec["pre_linear"])
    _bn(s.pre_bn, dec["pre_bn"],
        variables["batch_stats"]["decoder_step"]["pre_bn"])
    _gru(s.gru, dec["gru"])
    _dense(s.out_layer, dec["out_layer"])


def seq_decoder_from_jax(variables: Tree, *, n_frames: int,
                         n_pre_poses: int = 1,
                         conditioned: bool = True) -> SeqDecoder:
    """The decoder half (codebooks + decoder step, with its attention when
    the variables hold one) of a JAX SeqVQAutoencoder; a residual-VQ one
    keeps every stage's codebook."""
    p = variables["params"]
    dec = p["decoder_step"]
    hidden, rep_dim = np.shape(dec["out_layer"]["kernel"])
    vq = p["vq_layer"]
    model = SeqDecoder(rep_dim=rep_dim, hidden_size=hidden,
                       n_layers=_n_layers(dec["gru"]), n_frames=n_frames,
                       n_codes=np.shape(vq["codebook"])[0],
                       n_pre_poses=n_pre_poses, conditioned=conditioned,
                       stages=_n_stages(vq) if "mean_layer" not in vq
                       else 1, use_attention="attn" in dec)
    _fill_seq_decoder(model, variables)
    return model.eval()


def seq_ae_from_jax(variables: Tree, *, n_frames: int,
                    n_pre_poses: int = 1, conditioned: bool = True,
                    vq_flatten: str = "per_sample",
                    commitment_cost: float = 0.25,
                    eval_step_dropout: bool = False) -> SeqVQAutoencoder:
    """A whole JAX SeqVQAutoencoder (BiGRU or transformer encoder, GS-Soft,
    residual or no quantizer, the VAE heads, decoder with or without
    attention). The encoder, the quantizer, its stage count, the VAE heads
    and the decoder attention come from the variables."""
    p = variables["params"]
    enc = p["encoder"]
    rep_dim, hidden = np.shape(enc["in_layer"]["kernel"])
    arch = "bigru" if "gru" in enc else "transformer"
    n_layers = _n_layers(enc["gru"]) if arch == "bigru" else _n_blocks(enc)
    vq = p.get("vq_layer")
    rvq = vq is not None and "mean_layer" not in vq
    model = SeqVQAutoencoder(
        rep_dim=rep_dim, hidden_size=hidden, n_layers=n_layers,
        n_frames=n_frames,
        vq_components=np.shape(vq["codebook"])[0] if vq else 1,
        n_pre_poses=n_pre_poses, vq_variant="rvq" if rvq else "gssoft",
        rvq_stages=_n_stages(vq) if rvq else 1,
        commitment_cost=commitment_cost, conditioned=conditioned,
        vq_flatten=vq_flatten, encoder_arch=arch, use_vq=vq is not None,
        use_vae="vae_mean" in p, use_attention="attn" in p["decoder_step"],
        eval_step_dropout=eval_step_dropout)
    load_jax_variables(model, p, variables.get("batch_stats"))
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


def frame_model_from_jax(variables: Tree, *, motion_dim: int,
                         latent_dim: int, vq_components: int = 0,
                         vae: bool = False, commitment_cost: float = 0.25,
                         vq_state: Optional[Tree] = None) -> nn.Module:
    """A Part-a model from JAX variables, chosen as the JAX package's
    make_frame_model does: vq_components > 0 a VQFrame (vae: with its
    VAE heads; vq_state its EMA state, where given), else vae a VAEFrame,
    else a DAE."""
    if vq_components > 0:
        model = VQFrame(motion_dim, latent_dim, vq_components, vae=vae,
                        commitment_cost=commitment_cost)
        if vq_state:
            load_ema_state(model, vq_state)
    elif vae:
        model = VAEFrame(motion_dim, latent_dim)
    else:
        return dae_from_jax(variables, motion_dim=motion_dim,
                            latent_dim=latent_dim)
    load_jax_variables(model, variables["params"],
                       variables.get("batch_stats"))
    return model.eval()


def ema_state_to_jax(model: VQFrame) -> Dict[str, np.ndarray]:
    """A VQFrame's EMA state as the JAX package's VQEmaState dict."""
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in model.vq.state()._asdict().items()}


def load_ema_state(model: VQFrame, state: Tree) -> None:
    """Set a VQFrame's EMA buffers from a VQEmaState dict (copies)."""
    model.vq.load_state(VQEmaState(*(_t(state[k]) for k in
                                     VQEmaState._fields)))


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


def audio2token_from_jax(variables: Tree, *, n_steps: int,
                         n_pre_poses: int = 2) -> Audio2Token:
    """An Audio2Token from JAX variables: fusion "both" when the encoder
    holds a word embedding, else "audio"; widths, layers, attention and
    the stage heads (chained with stage_embed_{s}) from the arrays."""
    p = variables["params"]
    enc, dec = p["encoder"], p["decoder_step"]
    n_tokens, hidden = np.shape(dec["token_embedding"]["embedding"])
    both = "embedding" in enc
    n_words, embed = (np.shape(enc["embedding"]["embedding"]) if both
                      else (0, 300))
    model = Audio2Token(
        n_tokens=n_tokens, hidden_size=hidden,
        n_layers=_n_layers(dec["gru"]), n_steps=n_steps,
        n_pre_poses=n_pre_poses, use_attention="attn" in dec,
        fusion="both" if both else "audio", n_words=n_words,
        embed_size=embed,
        token_stages=1 + sum(1 for k in dec if k.startswith("out_layer_r")),
        stage_conditional="stage_embed_0" in dec)
    if _n_layers(enc["gru"]) != model.n_layers:
        raise ValueError(f"{_n_layers(enc['gru'])} encoder GRU layers "
                         f"for {model.n_layers} decoder layers")
    load_jax_variables(model, p, variables.get("batch_stats"))
    return model.eval()


def _text_encoder_shape(enc: Tree) -> Tuple[int, int, int, int]:
    """(n_words, embed, hidden, layers) of a TextEncoderRNN's params."""
    n_words, embed = np.shape(enc["embedding_table"])
    return (n_words, embed, np.shape(enc["gru"]["l0_w_hh"])[1],
            _n_layers(enc["gru"]))


def _load(model: nn.Module, variables: Tree) -> nn.Module:
    load_jax_variables(model, variables["params"],
                       variables.get("batch_stats"))
    return model.eval()


def baseline_from_jax(variables: Tree, *, n_frames: int,
                      n_pre_poses: int = 5) -> Seq2SeqNet:
    """A Seq2SeqNet from JAX variables; widths, layers, vocabulary and
    pose width from the arrays."""
    n_words, embed, hidden, layers = _text_encoder_shape(
        variables["params"]["encoder"])
    pose_dim = np.shape(variables["params"]["decoder_step"]["out_layer"]
                        ["kernel"])[1]
    return _load(Seq2SeqNet(n_words, pose_dim, n_frames, hidden, layers,
                            n_pre_poses=n_pre_poses, word_embed_size=embed),
                 variables)


def c2g_from_jax(variables: Tree, *, n_frames: int,
                 parity_frozen_hidden: bool = False) -> Cluster2Gesture:
    """A Cluster2Gesture from JAX variables; clusters, widths and layers
    from the arrays."""
    p = variables["params"]
    n_clusters, hidden = np.shape(p["embedding"]["embedding"])
    output = np.shape(p["step"]["out_layer"]["kernel"])[1]
    return _load(Cluster2Gesture(n_clusters, output, hidden, n_frames,
                                 _n_layers(p["pre_gru"]),
                                 parity_frozen_hidden=parity_frozen_hidden),
                 variables)


def gan_generator_from_jax(variables: Tree, *,
                           n_frames: int) -> T2GGenerator:
    """A T2GGenerator from JAX variables; the noise width is what `fuse`
    takes beyond the L*H hidden."""
    p = variables["params"]
    n_words, embed, hidden, layers = _text_encoder_shape(p["encoder"])
    pose_dim = np.shape(p["decoder_step"]["out_layer"]["kernel"])[1]
    noise_dim = np.shape(p["fuse"]["kernel"])[0] - layers * hidden
    return _load(T2GGenerator(n_words, pose_dim, n_frames, hidden, layers,
                              noise_dim=noise_dim, word_embed_size=embed),
                 variables)


def gan_discriminator_from_jax(params: Tree) -> T2GDiscriminator:
    """A T2GDiscriminator from its JAX params (it has no batch_stats)."""
    n_words, embed, hidden, layers = _text_encoder_shape(
        params["text_encoder"])
    pose_dim = np.shape(params["pose_in"]["kernel"])[0]
    return _load(T2GDiscriminator(n_words, pose_dim, hidden, layers,
                                  word_embed_size=embed), {"params": params})


# -- the port's modules -> the JAX package's layout ----------------------
# One entry per parameter: (path in the JAX params tree, the port's
# tensor, layout, initialiser). Layouts: "dense" (Linear weight (out, in)
# <-> kernel (in, out)), "conv" ((out, in, k) <-> (k, in, out)), "same".
# Initialisers are the JAX package's for that layer (flax's Dense:
# lecun_normal kernel and zero bias; nn.Embed: normal(1/sqrt(features));
# the GRUs' U(+-1/sqrt(H)); the TCN's normal(0.01) kernels, WeightNorm
# scale 1; BatchNorm and LayerNorm scale 1, bias 0; the codebooks'
# normal(1)).
Entry = Tuple[Tuple[str, ...], torch.Tensor, str, str]


def _dense_entries(path, mod: nn.Linear, kernel_init: str = "lecun"
                   ) -> List[Entry]:
    return [(path + ("kernel",), mod.weight, "dense", kernel_init),
            (path + ("bias",), mod.bias, "same", "zeros")]


def _gru_entries(path, mod: nn.Module, hidden: int) -> List[Entry]:
    init = f"uniform:{1.0 / np.sqrt(hidden)}"
    return [(path + (name,), p, "same", init)
            for name, p in mod.named_parameters()]


def _norm_entries(path, mod: nn.Module) -> List[Entry]:
    """A BatchNorm's or LayerNorm's scale (ones) and bias (zeros)."""
    return [(path + ("scale",), mod.weight, "same", "ones"),
            (path + ("bias",), mod.bias, "same", "zeros")]


def _embed(path, mod: nn.Embedding) -> Entry:
    return (path, mod.weight, "same",
            f"normal:{1.0 / np.sqrt(mod.embedding_dim)}")


def _decoder_step_entries(d: nn.Module, hidden: int) -> List[Entry]:
    """A decoder step's attention (when it has one), pre_linear, pre_bn,
    GRU stack and out_layer (the Part-b and the token decoder's)."""
    p = ("decoder_step",)
    out: List[Entry] = []
    if d.attn is not None:
        out += _dense_entries(p + ("attn", "attn"), d.attn.attn)
        out.append((p + ("attn", "v"), d.attn.v, "same",
                    f"normal:{1.0 / np.sqrt(hidden)}"))
    out += _dense_entries(p + ("pre_linear",), d.pre_linear) \
        + _norm_entries(p + ("pre_bn",), d.pre_bn) \
        + _gru_entries(p + ("gru",), d.gru, hidden) \
        + _dense_entries(p + ("out_layer",), d.out_layer)
    return out


def _blocks_entries(path, mod: nn.Module) -> List[Entry]:
    """A transformer stack's `layer_{i}` blocks and its final_ln."""
    out: List[Entry] = []
    for i in range(mod.n_layers):
        b, p = getattr(mod, f"layer_{i}"), path + (f"layer_{i}",)
        attns = ("self_attn", "cross_attn") if b.cross else ("self_attn",)
        for ln in ("ln_self", "ln_mlp") + (("ln_cross",) if b.cross
                                           else ()):
            out += _norm_entries(p + (ln,), getattr(b, ln))
        for attn in attns:
            for proj in "qkvo":
                out += _dense_entries(p + (attn, proj),
                                      getattr(getattr(b, attn), proj))
        out += _dense_entries(p + ("mlp_in",), b.mlp_in)
        out += _dense_entries(p + ("mlp_out",), b.mlp_out)
    return out + _norm_entries(path + ("final_ln",), mod.final_ln)


def _stage_head_entries(path, d: nn.Module) -> List[Entry]:
    out: List[Entry] = []
    for s in range(d.n_stage_heads):
        out += _dense_entries(path + (f"out_layer_r{s + 1}",),
                              getattr(d, f"out_layer_r{s + 1}"))
        if d.stage_conditional:
            out.append(_embed(path + (f"stage_embed_{s}", "embedding"),
                              getattr(d, f"stage_embed_{s}")))
    return out


def _text_encoder_entries(path, enc: nn.Module) -> List[Entry]:
    """A TextEncoderRNN's word table (normal(1), the JAX init without
    word vectors) and masked BiGRU."""
    return [(path + ("embedding_table",), enc.embedding_table.weight,
             "same", "normal:1.0")] \
        + _gru_entries(path + ("gru",), enc.gru, enc.hidden_size)


def misc_entries(model: nn.Module) -> List[Entry]:
    """The baseline's, c2g's and the GAN's parameters."""
    if isinstance(model, Cluster2Gesture):
        H = model.pre_gru.hidden_size
        out = [_embed(("embedding", "embedding"), model.embedding)]
        out += _gru_entries(("pre_gru",), model.pre_gru, H)
        return out + [(("step",) + path[1:], *rest) for path, *rest
                      in _decoder_step_entries(model.step, H)]
    if isinstance(model, T2GDiscriminator):
        e = model.text_encoder
        H = e.hidden_size
        out = _text_encoder_entries(("text_encoder",), e)
        out += _dense_entries(("pose_in",), model.pose_in)
        out += _gru_entries(("pose_gru",), model.pose_gru, H)
        for name in ("layers_0", "layers_2"):
            out += _dense_entries(("head", name), model.head[name])
        return out
    e = model.encoder
    out = _text_encoder_entries(("encoder",), e)
    if isinstance(model, T2GGenerator):
        out += _dense_entries(("fuse",), model.fuse)
    return out + _decoder_step_entries(model.decoder_step, e.hidden_size)


_MISC = (Seq2SeqNet, Cluster2Gesture, T2GGenerator, T2GDiscriminator)


def dae_entries(model: DAE) -> List[Entry]:
    if model.latent_dim == -1:
        return []
    return _dense_entries(("encoder",), model.encoder) \
        + _dense_entries(("decoder",), model.decoder)


def frame_entries(model: Union[VAEFrame, VQFrame]) -> List[Entry]:
    """A VAEFrame's or VQFrame's parameters (the VQFrame's encoder and
    decoder kernels xavier-normal, as flax declares them)."""
    vq = isinstance(model, VQFrame)
    kernel = "xavier" if vq else "lecun"
    out = _dense_entries(("encoder",), model.encoder, kernel)
    if vq:
        out += _norm_entries(("bn",), model.bn)
    if not vq or model.vae:
        for name in ("fc_mean", "fc_std", "fc_decoder"):
            out += _dense_entries((name,), getattr(model, name))
    return out + _dense_entries(("decoder",), model.decoder, kernel)


def seq_ae_entries(model: SeqVQAutoencoder) -> List[Entry]:
    """A tokenizer's parameters, BiGRU or transformer encoder."""
    H, e = model.hidden_size, model.encoder
    out = _dense_entries(("encoder", "in_layer"), e.in_layer)
    if model.encoder_arch == "bigru":
        out += _gru_entries(("encoder", "gru"), e.gru, H)
    else:
        out += _blocks_entries(("encoder",), e)
        out += _dense_entries(("encoder", "hidden_proj"), e.hidden_proj)
    q = model.vq_layer
    if q is None:
        pass
    elif model.vq_variant == "rvq":
        out += [(("vq_layer", name), p, "same", "normal:1.0")
                for name, p in q.named_parameters()]
    else:
        out += [(("vq_layer", "codebook"), q.codebook, "same", "normal:1.0")]
        out += _dense_entries(("vq_layer", "mean_layer"), q.mean_layer)
        out += _dense_entries(("vq_layer", "logvar_layer"), q.logvar_layer)
    if model.use_vae:
        for name in ("vae_mean", "vae_std", "vae_dec"):
            out += _dense_entries((name,), getattr(model, name))
    return out + _decoder_step_entries(model.decoder.decoder_step, H)


def text2token_entries(model: Text2Token) -> List[Entry]:
    """A GRU-decoder Part d's parameters (TCN or GRU text encoder). The
    embedding table keeps the values it has (the vocabulary's vectors)."""
    e, d = model.encoder, model.decoder_step
    H = e.hidden_size
    out: List[Entry] = [(("encoder", "embedding_table"),
                         e.embedding_table.weight, "same", "keep")]
    if model.encoder_type == "gru":
        out += _gru_entries(("encoder", "gru"), e.gru, H)
    else:
        for i, block in enumerate(e.tcn.blocks):
            p = ("encoder", "tcn", f"block{i}")
            for conv in ("conv1", "conv2"):
                mod = getattr(block, conv)
                out += [(p + (conv, "Conv_0", "kernel"), mod.kernel, "conv",
                         "normal:0.01"),
                        (p + (conv, "Conv_0", "bias"), mod.bias, "same",
                         "zeros"),
                        (p + (conv, "wn", "Conv_0/kernel/scale"), mod.scale,
                         "same", "ones")]
            if block.downsample is not None:
                out += [(p + ("downsample", "kernel"),
                         block.downsample.weight, "conv", "normal:0.01"),
                        (p + ("downsample", "bias"), block.downsample.bias,
                         "same", "zeros")]
        out += _dense_entries(("encoder", "decoder"), e.decoder,
                              "normal:0.01")
        out += _dense_entries(("encoder", "hidden_proj"), e.hidden_proj)
    return out + _token_decoder_entries(d, H)


def _token_decoder_entries(d: nn.Module, hidden: int) -> List[Entry]:
    """A `TokenDecoderStep`'s parameters (Text2Token, Audio2Token)."""
    p = ("decoder_step",)
    out = [_embed(p + ("token_embedding", "embedding"), d.token_embedding)]
    return out + _decoder_step_entries(d, hidden) + _stage_head_entries(p, d)


def _conv_stack_entries(path, convs: nn.Module) -> List[Entry]:
    """An audio encoder's conv{i} (flax's lecun_normal kernel, zero bias)
    and bn{i}."""
    out: List[Entry] = []
    for i in range(len(convs.specs)):
        conv = getattr(convs, f"conv{i}")
        out += [(path + (f"conv{i}", "kernel"), conv.weight, "conv",
                 "lecun"),
                (path + (f"conv{i}", "bias"), conv.bias, "same", "zeros")]
        if i < convs.n_norm:
            out += _norm_entries(path + (f"bn{i}",),
                                 getattr(convs, f"bn{i}"))
    return out


def audio_entries(model: nn.Module, path=()) -> List[Entry]:
    """An audio encoder's parameters under path: a WavEncoder*, or the
    context / fusion encoder with its BiGRU."""
    if isinstance(model, (AudioContextEncoder, AudioTextFusionEncoder)):
        out: List[Entry] = []
        if isinstance(model, AudioTextFusionEncoder):
            out.append(_embed(path + ("embedding", "embedding"),
                              model.embedding))
        return out + audio_entries(model.wav_encoder,
                                   path + ("wav_encoder",)) \
            + _gru_entries(path + ("gru",), model.gru, model.hidden_size)
    out = _conv_stack_entries(path, model.convs)
    if isinstance(model, WavEncoderSpectral):
        out += _dense_entries(path + ("fc",), model.fc)
        out += _norm_entries(path + ("fc_bn",), model.fc_bn)
    elif isinstance(model, WavEncoderTri):
        out += _dense_entries(path + ("out_layer",), model.out_layer)
    return out


def audio_batch_norms(model: nn.Module, path=()
                      ) -> Dict[Tuple[str, ...], nn.Module]:
    """An audio encoder's BatchNorms by their path in batch_stats."""
    if isinstance(model, (AudioContextEncoder, AudioTextFusionEncoder)):
        return audio_batch_norms(model.wav_encoder, path + ("wav_encoder",))
    out = {path + (f"bn{i}",): getattr(model.convs, f"bn{i}")
           for i in range(model.convs.n_norm)}
    if isinstance(model, WavEncoderSpectral):
        out[path + ("fc_bn",)] = model.fc_bn
    return out


_AUDIO_ENCODERS = (WavEncoderRaw, WavEncoderSpectral, WavEncoderTri,
                   AudioContextEncoder, AudioTextFusionEncoder)


def transformer_text2token_entries(model: TransformerText2Token
                                   ) -> List[Entry]:
    """A transformer Part d's parameters; the embedding table keeps the
    values it has, as in text2token_entries."""
    e, d = model.encoder, model.decoder
    out: List[Entry] = [(("encoder", "embedding_table"),
                         e.embedding_table.weight, "same", "keep")]
    out += _dense_entries(("encoder", "embed_proj"), e.embed_proj)
    out += _blocks_entries(("encoder",), e)
    out.append(_embed(("decoder", "token_embedding", "embedding"),
                      d.token_embedding))
    out += _blocks_entries(("decoder",), d)
    out += _dense_entries(("decoder", "out_layer"), d.out_layer)
    return out + _stage_head_entries(("decoder",), d)


def param_entries(model: nn.Module) -> List[Entry]:
    """The entries of a trainable port model (DAE, tokenizer, Part d, the
    audio Part d and its encoders, the baseline, c2g and the GAN's two
    models)."""
    if isinstance(model, DAE):
        return dae_entries(model)
    if isinstance(model, (VAEFrame, VQFrame)):
        return frame_entries(model)
    if isinstance(model, SeqVQAutoencoder):
        return seq_ae_entries(model)
    if isinstance(model, Text2Token):
        return text2token_entries(model)
    if isinstance(model, TransformerText2Token):
        return transformer_text2token_entries(model)
    if isinstance(model, Audio2Token):
        return audio_entries(model.encoder, ("encoder",)) \
            + _token_decoder_entries(model.decoder_step,
                                     model.encoder.hidden_size)
    if isinstance(model, _AUDIO_ENCODERS):
        return audio_entries(model)
    if isinstance(model, _MISC):
        return misc_entries(model)
    raise NotImplementedError(f"no JAX layout for {type(model).__name__}")


def batch_norms(model: nn.Module) -> Dict[Tuple[str, ...], nn.Module]:
    """{path in the JAX batch_stats tree: BatchNorm}."""
    if isinstance(model, SeqVQAutoencoder):
        return {("decoder_step", "pre_bn"): model.decoder.decoder_step.pre_bn}
    if isinstance(model, Text2Token):
        return {("decoder_step", "pre_bn"): model.decoder_step.pre_bn}
    if isinstance(model, VQFrame):
        return {("bn",): model.bn}
    if isinstance(model, Audio2Token):
        return {**audio_batch_norms(model.encoder, ("encoder",)),
                ("decoder_step", "pre_bn"): model.decoder_step.pre_bn}
    if isinstance(model, _AUDIO_ENCODERS):
        return audio_batch_norms(model)
    if isinstance(model, (Seq2SeqNet, T2GGenerator)):
        return {("decoder_step", "pre_bn"): model.decoder_step.pre_bn}
    if isinstance(model, Cluster2Gesture):
        return {("step", "pre_bn"): model.step.pre_bn}
    return {}


def to_jax_layout(t: torch.Tensor, layout: str) -> np.ndarray:
    a = t.detach().float().cpu().numpy()
    if layout == "dense":
        a = a.T
    elif layout == "conv":
        a = a.transpose(2, 1, 0)
    return np.ascontiguousarray(a, dtype=np.float32)


def from_jax_layout(a, layout: str) -> torch.Tensor:
    t = _t(a)
    if layout == "dense":
        t = t.t()
    elif layout == "conv":
        t = t.permute(2, 1, 0)
    return t.contiguous()


def _put(tree: dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree: Tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def jax_tree(entries: List[Entry], values=None) -> dict:
    """The JAX-layout numpy tree of the entries' tensors, or of values
    {id(parameter): tensor of its shape} (gradients, Adam moments)."""
    out: dict = {}
    for path, param, layout, _ in entries:
        t = param if values is None else values[id(param)]
        _put(out, path, to_jax_layout(t, layout))
    return out


def to_jax_variables(model: nn.Module) -> dict:
    """{"params": ..., "batch_stats": ...} in the JAX package's layout
    (numpy), the inverse of the `*_from_jax` converters."""
    bs: dict = {}
    for path, bn in batch_norms(model).items():
        _put(bs, path, {"mean": bn.running_mean.detach().cpu().numpy()
                        .astype(np.float32),
                        "var": bn.running_var.detach().cpu().numpy()
                        .astype(np.float32)})
    return {"params": jax_tree(param_entries(model)), "batch_stats": bs}


@torch.no_grad()
def load_jax_variables(model: nn.Module, params: Tree,
                       batch_stats: Optional[Tree] = None) -> None:
    """Set a port model's parameters (and BatchNorm statistics) from a
    JAX-layout tree, in place."""
    for path, param, layout, _ in param_entries(model):
        _set(param, from_jax_layout(_get(params, path), layout).to(
            param.device))
    for path, bn in batch_norms(model).items():
        if batch_stats:
            stats = _get(batch_stats, path)
            _set(bn.running_mean, _t(stats["mean"]).to(bn.running_mean.device))
            _set(bn.running_var, _t(stats["var"]).to(bn.running_var.device))


@torch.no_grad()
def flax_init(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise a port model as the JAX package initialises the same
    layers (see the entries' initialisers), drawing on the CPU from
    generator; BatchNorm statistics start at mean 0, var 1."""
    for _, param, layout, init in param_entries(model):
        shape = param.shape
        if init == "keep":
            continue
        if init == "zeros":
            v = torch.zeros(shape)
        elif init == "ones":
            v = torch.ones(shape)
        elif init in ("lecun", "xavier"):
            # flax's lecun_normal (xavier_normal): a normal truncated at 2
            # sigma, rescaled so the std is 1/sqrt(fan_in) (sqrt(2 /
            # (fan_in + fan_out))); a conv's fan_in is in * k
            fan = (int(np.prod(shape[1:])) if init == "lecun"
                   else (shape[0] + shape[1]) / 2)
            std = (1.0 / fan) ** 0.5 / .87962566103423978
            v = torch.empty(shape)
            torch.nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
        elif init.startswith("normal:"):
            v = torch.randn(shape, generator=generator) * float(init[7:])
        elif init.startswith("uniform:"):
            b = float(init[8:])
            v = (torch.rand(shape, generator=generator) * 2 - 1) * b
        else:
            raise ValueError(f"unknown initialiser {init!r}")
        param.copy_(v.to(param.device))
    for bn in batch_norms(model).values():
        bn.reset_running_stats()
    if isinstance(model, VQFrame):
        model.vq.load_state(init_ema_state(model.vq_components,
                                           model.latent_dim, generator))
