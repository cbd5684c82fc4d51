"""Import reference PyTorch checkpoints into the port's checkpoint trees.

The port's copy of the JAX package's `compat/torch_import.py`. The
reference saves torch state dicts inside
{args, epoch, lang_model, pose_dim, gen_dict} payloads
(ref: scripts/utils/train_utils.py:98-113). Each converter here maps the
reference modules' parameter names onto the JAX-layout numpy tree that
the JAX package's converter returns, leaf for leaf. That layout is the
one the port's checkpoint files hold (`train/checkpoints.save_checkpoint`)
and its models are built from (`compat/from_jax`,
`compat/checkpoint.load_checkpoint_and_model`), so an imported file loads
in both packages.

Name maps follow the reference model definitions:
  DAE_Network            ref: scripts/model/DAE_model.py:22-114
  Autoencoder_VQVAE      ref: scripts/model/Autoencoder_VQVAE_model.py:686
    (encoder EncoderRNN :30, decoder Generator->BahdanauAttnDecoderRNN
     :401, vq VQ_Payam_GSSoft :1304)
  text2embedding_model   ref: scripts/model/text2embedding_model.py:488
    (GRU text-encoder path :46; the TCN path cannot produce runnable
     checkpoints - see models/tcn.py)

Torch Linear stores (out, in) weights; the tree's Dense kernels are
(in, out) - transposed on the way in. GRU weights keep torch layout
because the tree holds torch-shaped (3H, in) matrices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _gru_params(sd: Dict[str, Any], prefix: str, n_layers: int,
                bidirectional: bool) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    sufs = ["", "_reverse"] if bidirectional else [""]
    for layer in range(n_layers):
        for suf in sufs:
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                key = f"{prefix}.{theirs}_l{layer}{suf}"
                out[f"l{layer}_{ours}{suf}"] = np.asarray(sd[key])
    return out


def _dense(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _t(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _batchnorm(sd: Dict[str, Any], prefix: str
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    params = {"scale": np.asarray(sd[f"{prefix}.weight"]),
              "bias": np.asarray(sd[f"{prefix}.bias"])}
    stats = {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])}
    return params, stats


def convert_dae_state(sd: Dict[str, Any]) -> Dict[str, Any]:
    """DAE_Network state dict -> params
    (ref key names: encoder.0.*, decoder.0.*)."""
    return {"encoder": _dense(sd, "encoder.0"),
            "decoder": _dense(sd, "decoder.0")}


def convert_vq_frame_state(sd: Dict[str, Any]
                           ) -> Tuple[Dict[str, Any], Dict[str, Any],
                                      Dict[str, np.ndarray]]:
    """VQ_Frame (ref: DAE_model.py:118-274) state dict ->
    (params, batch_stats, vq_state_arrays). The EMA quantizer's
    codebook/cluster-size/accumulator live outside the param tree here
    (explicit VQEmaState); returned as plain arrays for the caller."""
    bn_params, bn_stats = _batchnorm(sd, "bachnorm")
    params = {"encoder": _dense(sd, "encoder.0"),
              "bn": bn_params,
              "decoder": _dense(sd, "decoder.0")}
    for ours, theirs in (("fc_mean", "VAE_fc_mean"),
                         ("fc_std", "VAE_fc_std"),
                         ("fc_decoder", "VAE_fc_decoder")):
        if f"{theirs}.weight" in sd:
            params[ours] = _dense(sd, theirs)
    vq = {"codebook": np.asarray(sd["vq_layer._embedding.weight"]),
          "cluster_size": np.asarray(sd["vq_layer._ema_cluster_size"]),
          "ema_w": np.asarray(sd["vq_layer._ema_w"])}
    return params, {"bn": bn_stats}, vq


def convert_seq_ae_state(sd: Dict[str, Any], n_layers: int = 2
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Autoencoder_VQVAE state dict -> (params, batch_stats).

    Reference key names: encoder.in_layer.*, encoder.gru.*,
    vq_layer.{mean_layer,logvar_layer,_embedding}.*,
    decoder.decoder.{pre_linear.0,pre_linear.1,gru,out_layer}.*
    (+ attn when autoencoder_att).
    """
    params: Dict[str, Any] = {
        "encoder": {
            "in_layer": _dense(sd, "encoder.in_layer"),
            "gru": _gru_params(sd, "encoder.gru", n_layers,
                               bidirectional=True),
        },
        "vq_layer": {
            "codebook": np.asarray(sd["vq_layer._embedding.weight"]),
            "mean_layer": _dense(sd, "vq_layer.mean_layer"),
            "logvar_layer": _dense(sd, "vq_layer.logvar_layer"),
        },
    }
    bn_params, bn_stats = _batchnorm(sd, "decoder.decoder.pre_linear.1")
    step: Dict[str, Any] = {
        "pre_linear": _dense(sd, "decoder.decoder.pre_linear.0"),
        "pre_bn": bn_params,
        "gru": _gru_params(sd, "decoder.decoder.gru", n_layers,
                           bidirectional=False),
        "out_layer": _dense(sd, "decoder.decoder.out_layer"),
    }
    if "decoder.decoder.attn.attn.weight" in sd:
        step["attn"] = {
            "attn": _dense(sd, "decoder.decoder.attn.attn"),
            "v": np.asarray(sd["decoder.decoder.attn.v"]),
        }
    params["decoder_step"] = step
    # VAE heads (autoencoder_vae checkpoints, ref :778-790,1002-1006);
    # absent keys mean a non-VAE model
    for ours, theirs in (("vae_mean", "VAE_fc_mean"),
                         ("vae_std", "VAE_fc_std"),
                         ("vae_dec", "VAE_fc_decoder")):
        if f"{theirs}.weight" in sd:
            params[ours] = _dense(sd, theirs)
    batch_stats = {"decoder_step": {"pre_bn": bn_stats}}
    return params, batch_stats


def convert_text2token_state(sd: Dict[str, Any], n_layers: int = 2
                             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """text2embedding_model (GRU text-encoder path) state dict ->
    (params, batch_stats). Reference key names: encoder.embedding.weight,
    encoder.gru.*, decoder.decoder.{embedding,attn,pre_linear,gru,out}.*.
    """
    params: Dict[str, Any] = {
        "encoder": {
            "embedding_table": np.asarray(sd["encoder.embedding.weight"]),
            "gru": _gru_params(sd, "encoder.gru", n_layers,
                               bidirectional=True),
        },
    }
    bn_params, bn_stats = _batchnorm(sd, "decoder.decoder.pre_linear.1")
    step: Dict[str, Any] = {
        "token_embedding": {
            "embedding": np.asarray(sd["decoder.decoder.embedding.weight"])},
        "pre_linear": _dense(sd, "decoder.decoder.pre_linear.0"),
        "pre_bn": bn_params,
        "gru": _gru_params(sd, "decoder.decoder.gru", n_layers,
                           bidirectional=False),
        "out_layer": _dense(sd, "decoder.decoder.out"),
    }
    if "decoder.decoder.attn.attn.weight" in sd:
        step["attn"] = {
            "attn": _dense(sd, "decoder.decoder.attn.attn"),
            "v": np.asarray(sd["decoder.decoder.attn.v"]),
        }
    params["decoder_step"] = step
    return params, {"decoder_step": {"pre_bn": bn_stats}}


def _weight_norm_conv(sd: Dict[str, Any], prefix: str
                      ) -> Dict[str, Any]:
    """torch weight_norm(Conv1d) -> the JAX layout of flax's
    nn.WeightNorm(nn.Conv) params (`compat/from_jax` folds them).

    torch stores weight_v (out, in, k) + weight_g (out, 1, 1) with the
    norm taken per output channel (dim=0); the tree keeps the direction
    as the wrapped Conv kernel (k, in, out) plus a per-feature scale -
    identical effective weight g * v / ||v||.
    """
    v = np.asarray(sd[f"{prefix}.weight_v"])
    g = np.asarray(sd[f"{prefix}.weight_g"])
    return {"Conv_0": {"kernel": np.ascontiguousarray(v.transpose(2, 1, 0)),
                       "bias": np.asarray(sd[f"{prefix}.bias"])},
            "wn": {"Conv_0/kernel/scale": g.reshape(-1)}}


def convert_tcn_encoder_state(sd: Dict[str, Any], n_layers: int = 2
                              ) -> Dict[str, Any]:
    """TextEncoderTCN (ref: Helper_models.py:371-449) state dict ->
    partial params for models.tcn.TextEncoderTCN.

    Partial: the reference returns (y, 0) with no decoder-initial
    hidden, so our repaired hidden_proj head has no torch counterpart -
    merge this over initialized params. Reference key names:
    embedding.weight, tcn.network.{i}.{conv1,conv2}.weight_{g,v}/bias,
    tcn.network.0.downsample.*, decoder.*.
    """
    tcn: Dict[str, Any] = {}
    for i in range(n_layers):
        block: Dict[str, Any] = {
            "conv1": _weight_norm_conv(sd, f"tcn.network.{i}.conv1"),
            "conv2": _weight_norm_conv(sd, f"tcn.network.{i}.conv2"),
        }
        down = f"tcn.network.{i}.downsample.weight"
        if down in sd:
            block["downsample"] = {
                "kernel": np.ascontiguousarray(
                    np.asarray(sd[down]).transpose(2, 1, 0)),
                "bias": np.asarray(sd[f"tcn.network.{i}.downsample.bias"]),
            }
        tcn[f"block{i}"] = block
    return {"embedding_table": np.asarray(sd["embedding.weight"]),
            "tcn": tcn,
            "decoder": _dense(sd, "decoder")}


def convert_baseline_state(sd: Dict[str, Any], n_layers: int = 2
                           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Seq2SeqNet baseline (ref: seq2seq_net.py:220-256) state dict ->
    (params, batch_stats) for models.baseline.Seq2SeqNet. Key names:
    encoder.{embedding,gru}.*, decoder.decoder.{pre_linear,attn,gru,out}.*
    (continuous poses: no decoder token embedding)."""
    params: Dict[str, Any] = {
        "encoder": {
            "embedding_table": np.asarray(sd["encoder.embedding.weight"]),
            "gru": _gru_params(sd, "encoder.gru", n_layers,
                               bidirectional=True),
        },
    }
    bn_params, bn_stats = _batchnorm(sd, "decoder.decoder.pre_linear.1")
    params["decoder_step"] = {
        "pre_linear": _dense(sd, "decoder.decoder.pre_linear.0"),
        "pre_bn": bn_params,
        "attn": {"attn": _dense(sd, "decoder.decoder.attn.attn"),
                 "v": np.asarray(sd["decoder.decoder.attn.v"])},
        "gru": _gru_params(sd, "decoder.decoder.gru", n_layers,
                           bidirectional=False),
        "out_layer": _dense(sd, "decoder.decoder.out"),
    }
    return params, {"decoder_step": {"pre_bn": bn_stats}}


def convert_c2g_state(sd: Dict[str, Any], n_layers: int = 1
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """cluster2gesture_model (ref: seq2seq_with_cluster_model.py:8-70)
    state dict -> (params, batch_stats) for models.c2g.Cluster2Gesture.
    Key names: embedding.weight, pre_gru.*, pre_linear.{0,1}.*, gru.*,
    out_layer.*."""
    bn_params, bn_stats = _batchnorm(sd, "pre_linear.1")
    params = {
        "embedding": {"embedding": np.asarray(sd["embedding.weight"])},
        "pre_gru": _gru_params(sd, "pre_gru", n_layers,
                               bidirectional=False),
        "step": {
            "pre_linear": _dense(sd, "pre_linear.0"),
            "pre_bn": bn_params,
            "gru": _gru_params(sd, "gru", n_layers, bidirectional=False),
            "out_layer": _dense(sd, "out_layer"),
        },
    }
    return params, {"step": {"pre_bn": bn_stats}}


def convert_audio_encoder_state(sd: Dict[str, Any], n_layers: int = 2
                                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """EncoderRNN_With_Audio (Audio_Features branch) state dict ->
    (params, batch_stats) for models.audio.AudioContextEncoder.

    Reference key names (ref: Helper_models.py:179-317, WavEncoder2
    :116-172): audio_encoder.encoder.{0,3,6} convs interleaved with
    .{2,5,8} BatchNorm1d, audio_encoder.encoder_fc.{0,1}, gru.*.
    The fc weight's input axis is re-permuted because torch flattens the
    conv output channel-major ((C, T) -> c*T+t) while our channels-last
    layout flattens time-major (t*C+c).
    """
    wav_p: Dict[str, Any] = {}
    wav_s: Dict[str, Any] = {}
    for i, (conv_idx, bn_idx) in enumerate(((0, 2), (3, 5), (6, 8))):
        w = np.asarray(sd[f"audio_encoder.encoder.{conv_idx}.weight"])
        wav_p[f"conv{i}"] = {
            "kernel": np.ascontiguousarray(w.transpose(2, 1, 0)),
            "bias": np.asarray(sd[f"audio_encoder.encoder.{conv_idx}.bias"]),
        }
        bn_p, bn_s = _batchnorm(sd, f"audio_encoder.encoder.{bn_idx}")
        wav_p[f"bn{i}"] = bn_p
        wav_s[f"bn{i}"] = bn_s
    w_fc = np.asarray(sd["audio_encoder.encoder_fc.0.weight"])  # (H, C*T)
    out_dim, flat = w_fc.shape
    n_ch = wav_p["conv2"]["kernel"].shape[-1]
    t_len = flat // n_ch
    w_perm = w_fc.reshape(out_dim, n_ch, t_len).transpose(0, 2, 1) \
        .reshape(out_dim, flat)
    wav_p["fc"] = {"kernel": _t(w_perm),
                   "bias": np.asarray(sd["audio_encoder.encoder_fc.0.bias"])}
    fc_bn_p, fc_bn_s = _batchnorm(sd, "audio_encoder.encoder_fc.1")
    wav_p["fc_bn"] = fc_bn_p
    wav_s["fc_bn"] = fc_bn_s
    params = {"wav_encoder": wav_p,
              "gru": _gru_params(sd, "gru", n_layers, bidirectional=True)}
    return params, {"wav_encoder": wav_s}


def convert_wav_encoder_tri_state(sd: Dict[str, Any], prefix: str = ""
                                  ) -> Tuple[Dict[str, Any],
                                             Dict[str, Any]]:
    """WavEncoder_tri state dict (ref: Helper_models.py:325-368) ->
    (params, batch_stats) for models.audio.WavEncoderTri.

    Reference keys: feat_extractor.{0,3,6,9} convs interleaved with
    .{1,4,7} BatchNorm1d, plus out_layer. The out_layer weight's input
    axis is re-permuted: torch flattens the conv output channel-major
    ((C, T) -> c*T+t) while our channels-last layout flattens
    time-major (t*C+c)."""
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    for i, conv_idx in enumerate((0, 3, 6, 9)):
        w = np.asarray(sd[f"{prefix}feat_extractor.{conv_idx}.weight"])
        p[f"conv{i}"] = {
            "kernel": np.ascontiguousarray(w.transpose(2, 1, 0)),
            "bias": np.asarray(
                sd[f"{prefix}feat_extractor.{conv_idx}.bias"])}
        if i < 3:
            bn_p, bn_s = _batchnorm(sd,
                                    f"{prefix}feat_extractor.{conv_idx + 1}")
            p[f"bn{i}"] = bn_p
            s[f"bn{i}"] = bn_s
    w_out = np.asarray(sd[f"{prefix}out_layer.weight"])   # (H, C*T)
    out_dim, flat = w_out.shape
    n_ch = p["conv3"]["kernel"].shape[-1]
    t_len = flat // n_ch
    w_perm = w_out.reshape(out_dim, n_ch, t_len).transpose(0, 2, 1) \
        .reshape(out_dim, flat)
    p["out_layer"] = {"kernel": _t(w_perm),
                      "bias": np.asarray(sd[f"{prefix}out_layer.bias"])}
    return p, s


def merge_params(base: Dict[str, Any], update: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """Deep-merge a (possibly partial) converted param tree over
    initialized params, keeping leaves that have no torch counterpart."""
    out = dict(base)
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_params(out[k], v)
        else:
            out[k] = v
    return out


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference torch checkpoint file: returns
    {args, epoch, pose_dim, state_dict} with tensors as numpy."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("gen_dict", payload)
    return {
        "args": payload.get("args"),
        "epoch": payload.get("epoch", 0),
        "pose_dim": payload.get("pose_dim", 0),
        "state_dict": {k: v.numpy() if hasattr(v, "numpy") else v
                       for k, v in sd.items()},
    }
