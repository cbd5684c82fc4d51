"""The reference's state-dict layout, written from JAX-layout trees.

The inverse of `compat/torch_import`'s converters (both packages'): each
function takes the numpy params (and batch_stats) tree a converter
returns and gives the reference module's `state_dict()` with its key
names, torch's (out, in) Linear and (out, in, k) Conv1d weights,
BatchNorm buffers with `num_batches_tracked`, weight-normed TCN convs as
weight_v / weight_g, and the audio encoders' fc / out_layer weights in
torch's channel-major flatten. `reference_payload` wraps one as the
reference trainer's checkpoint file holds it ({args, epoch, pose_dim,
gen_dict}, ref: scripts/utils/train_utils.py:98-113).

Used by the port's tests and by chip_smoke.py (loaded by path, as it
loads tests/corpus.py). Imports torch and numpy only.
"""
import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

Tree = Dict[str, Any]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _dense(sd: dict, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd: dict, prefix: str, p: Tree, s: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _gru(sd: dict, prefix: str, tree: Tree, n_layers: int,
         bidirectional: bool) -> None:
    for layer in range(n_layers):
        for suf in (["", "_reverse"] if bidirectional else [""]):
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                sd[f"{prefix}.{theirs}_l{layer}{suf}"] = _t(
                    tree[f"l{layer}_{ours}{suf}"])


def _conv(sd: dict, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _channel_major(kernel, n_ch: int) -> torch.Tensor:
    """A time-major (t*C+c) flattened Dense kernel -> torch's (out, C*T)
    weight over the channel-major flatten (c*T+t)."""
    w = np.asarray(kernel).T                      # (out, T*C)
    out_dim, flat = w.shape
    return _t(w.reshape(out_dim, flat // n_ch, n_ch).transpose(0, 2, 1)
              .reshape(out_dim, flat))


def _attn(sd: dict, prefix: str, p: Tree) -> None:
    _dense(sd, f"{prefix}.attn", p["attn"])
    sd[f"{prefix}.v"] = _t(p["v"])


def dae_sd(params: Tree) -> dict:
    """DAE_Network (ref: DAE_model.py:22-114)."""
    sd: dict = {}
    _dense(sd, "encoder.0", params["encoder"])
    _dense(sd, "decoder.0", params["decoder"])
    return sd


def vq_frame_sd(params: Tree, stats: Tree, vq: Tree) -> dict:
    """VQ_Frame (ref: DAE_model.py:118-274), with its VAE heads where
    the tree has them and the EMA quantizer's state."""
    sd = dae_sd(params)
    _bn(sd, "bachnorm", params["bn"], stats["bn"])
    for ours, theirs in (("fc_mean", "VAE_fc_mean"), ("fc_std", "VAE_fc_std"),
                         ("fc_decoder", "VAE_fc_decoder")):
        if ours in params:
            _dense(sd, theirs, params[ours])
    sd["vq_layer._embedding.weight"] = _t(vq["codebook"])
    sd["vq_layer._ema_cluster_size"] = _t(vq["cluster_size"])
    sd["vq_layer._ema_w"] = _t(vq["ema_w"])
    return sd


def seq_ae_sd(params: Tree, stats: Tree, n_layers: int) -> dict:
    """Autoencoder_VQVAE (ref: Autoencoder_VQVAE_model.py:686), with the
    decoder attention and the VAE heads where the tree has them."""
    sd: dict = {}
    enc, vq, step = params["encoder"], params["vq_layer"], \
        params["decoder_step"]
    _dense(sd, "encoder.in_layer", enc["in_layer"])
    _gru(sd, "encoder.gru", enc["gru"], n_layers, True)
    sd["vq_layer._embedding.weight"] = _t(vq["codebook"])
    _dense(sd, "vq_layer.mean_layer", vq["mean_layer"])
    _dense(sd, "vq_layer.logvar_layer", vq["logvar_layer"])
    _dense(sd, "decoder.decoder.pre_linear.0", step["pre_linear"])
    _bn(sd, "decoder.decoder.pre_linear.1", step["pre_bn"],
        stats["decoder_step"]["pre_bn"])
    _gru(sd, "decoder.decoder.gru", step["gru"], n_layers, False)
    _dense(sd, "decoder.decoder.out_layer", step["out_layer"])
    if "attn" in step:
        _attn(sd, "decoder.decoder.attn", step["attn"])
    for ours, theirs in (("vae_mean", "VAE_fc_mean"), ("vae_std", "VAE_fc_std"),
                         ("vae_dec", "VAE_fc_decoder")):
        if ours in params:
            _dense(sd, theirs, params[ours])
    return sd


def text2token_sd(params: Tree, stats: Tree, n_layers: int) -> dict:
    """text2embedding_model's GRU text-encoder path (ref:
    text2embedding_model.py:488), with the attention where the tree has
    it."""
    sd: dict = {}
    enc, step = params["encoder"], params["decoder_step"]
    sd["encoder.embedding.weight"] = _t(enc["embedding_table"])
    _gru(sd, "encoder.gru", enc["gru"], n_layers, True)
    sd["decoder.decoder.embedding.weight"] = _t(
        step["token_embedding"]["embedding"])
    _dense(sd, "decoder.decoder.pre_linear.0", step["pre_linear"])
    _bn(sd, "decoder.decoder.pre_linear.1", step["pre_bn"],
        stats["decoder_step"]["pre_bn"])
    _gru(sd, "decoder.decoder.gru", step["gru"], n_layers, False)
    _dense(sd, "decoder.decoder.out", step["out_layer"])
    if "attn" in step:
        _attn(sd, "decoder.decoder.attn", step["attn"])
    return sd


def tcn_encoder_sd(enc: Tree, n_layers: int) -> dict:
    """TextEncoderTCN (ref: Helper_models.py:371-449): the weight-normed
    convs as weight_v (out, in, k) and weight_g (out, 1, 1)."""
    sd: dict = {"embedding.weight": _t(enc["embedding_table"])}
    for i in range(n_layers):
        block = enc["tcn"][f"block{i}"]
        for conv in ("conv1", "conv2"):
            p = block[conv]
            v = np.asarray(p["Conv_0"]["kernel"]).transpose(2, 1, 0)
            sd[f"tcn.network.{i}.{conv}.weight_v"] = _t(v)
            sd[f"tcn.network.{i}.{conv}.weight_g"] = _t(
                np.asarray(p["wn"]["Conv_0/kernel/scale"]).reshape(-1, 1, 1))
            sd[f"tcn.network.{i}.{conv}.bias"] = _t(p["Conv_0"]["bias"])
        if "downsample" in block:
            _conv(sd, f"tcn.network.{i}.downsample", block["downsample"])
    _dense(sd, "decoder", enc["decoder"])
    return sd


def baseline_sd(params: Tree, stats: Tree, n_layers: int) -> dict:
    """Seq2SeqNet (ref: seq2seq_net.py:220-256)."""
    sd: dict = {}
    enc, step = params["encoder"], params["decoder_step"]
    sd["encoder.embedding.weight"] = _t(enc["embedding_table"])
    _gru(sd, "encoder.gru", enc["gru"], n_layers, True)
    _dense(sd, "decoder.decoder.pre_linear.0", step["pre_linear"])
    _bn(sd, "decoder.decoder.pre_linear.1", step["pre_bn"],
        stats["decoder_step"]["pre_bn"])
    _attn(sd, "decoder.decoder.attn", step["attn"])
    _gru(sd, "decoder.decoder.gru", step["gru"], n_layers, False)
    _dense(sd, "decoder.decoder.out", step["out_layer"])
    return sd


def c2g_sd(params: Tree, stats: Tree, n_layers: int = 1) -> dict:
    """cluster2gesture_model (ref: seq2seq_with_cluster_model.py:8-70)."""
    sd: dict = {"embedding.weight": _t(params["embedding"]["embedding"])}
    _gru(sd, "pre_gru", params["pre_gru"], n_layers, False)
    step = params["step"]
    _dense(sd, "pre_linear.0", step["pre_linear"])
    _bn(sd, "pre_linear.1", step["pre_bn"], stats["step"]["pre_bn"])
    _gru(sd, "gru", step["gru"], n_layers, False)
    _dense(sd, "out_layer", step["out_layer"])
    return sd


def audio_encoder_sd(params: Tree, stats: Tree, n_layers: int = 2) -> dict:
    """EncoderRNN_With_Audio's Audio_Features branch (ref:
    Helper_models.py:179-317, WavEncoder2 :116-172)."""
    sd: dict = {}
    wp, ws = params["wav_encoder"], stats["wav_encoder"]
    for i, (conv_idx, bn_idx) in enumerate(((0, 2), (3, 5), (6, 8))):
        _conv(sd, f"audio_encoder.encoder.{conv_idx}", wp[f"conv{i}"])
        _bn(sd, f"audio_encoder.encoder.{bn_idx}", wp[f"bn{i}"],
            ws[f"bn{i}"])
    n_ch = np.asarray(wp["conv2"]["kernel"]).shape[-1]
    sd["audio_encoder.encoder_fc.0.weight"] = _channel_major(
        wp["fc"]["kernel"], n_ch)
    sd["audio_encoder.encoder_fc.0.bias"] = _t(wp["fc"]["bias"])
    _bn(sd, "audio_encoder.encoder_fc.1", wp["fc_bn"], ws["fc_bn"])
    _gru(sd, "gru", params["gru"], n_layers, True)
    return sd


def wav_encoder_tri_sd(params: Tree, stats: Tree, prefix: str = "") -> dict:
    """WavEncoder_tri (ref: Helper_models.py:325-368)."""
    sd: dict = {}
    for i, conv_idx in enumerate((0, 3, 6, 9)):
        _conv(sd, f"{prefix}feat_extractor.{conv_idx}", params[f"conv{i}"])
        if i < 3:
            _bn(sd, f"{prefix}feat_extractor.{conv_idx + 1}",
                params[f"bn{i}"], stats[f"bn{i}"])
    n_ch = np.asarray(params["conv3"]["kernel"]).shape[-1]
    sd[f"{prefix}out_layer.weight"] = _channel_major(
        params["out_layer"]["kernel"], n_ch)
    sd[f"{prefix}out_layer.bias"] = _t(params["out_layer"]["bias"])
    return sd


def reference_payload(state_dict: dict, args: dict, epoch: int = 1,
                      pose_dim: int = 0,
                      lang_model: Optional[Any] = None) -> dict:
    """The reference trainer's checkpoint payload: its args an
    argparse.Namespace with the reference's key names, the model's state
    dict under gen_dict."""
    return {"args": argparse.Namespace(**args), "epoch": epoch,
            "lang_model": lang_model, "pose_dim": pose_dim,
            "gen_dict": state_dict}


# the flags the reference declares as string booleans
# (ref: config/parse_args.py:44-63,79-82)
STRING_BOOL_FLAGS = {
    "sentence_level", "autoencoder_denoising", "autoencoder_att",
    "autoencoder_fixed_weight", "autoencoder_conditioned", "use_derivative",
    "autoencoder_vae", "autoencoder_freeze_encoder", "autoencoder_vq",
    "text2_embedding_discrete", "use_similarity", "Modality_Audio",
    "Modality_Text", "Modality_Gesture"}


def reference_args(config: Dict[str, Any]) -> dict:
    """A checkpoint's config (the args with their extras merged in) as
    the reference's args: its string booleans written "True" / "False"
    as its argparse leaves them."""
    return {k: str(v) if k in STRING_BOOL_FLAGS and isinstance(v, bool)
            else v for k, v in config.items() if k != "extras"}
