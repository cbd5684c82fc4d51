"""Shared construction for the port's inference entry points.

`build_generator` is the port of the JAX package's
`cli/_common.build_generator`: it loads the three pipeline checkpoints
(text2embedding, DAE, autoencoder_vq) that the JAX trainers write, the
vocabulary (the Part-d checkpoint's `lang_model`, else the store's
words) and, for exemplar mode, the latent bank that `cli/cluster.py`
writes, and assembles the port's GestureGenerator with the checkpoint's
chunk length, window length, frame rate and text context.
`fused_decoder_policy` chooses the chunk rollout's route for the
generation commands, as `cli/reconstruct` does: the kernel where the
tokenizer's decoder admits it, else plain PyTorch, chosen from the stated
reason and logged. `load_bvh_exporter` is the port of its BVH export
half. `parse_mesh` reads a `--mesh dp=4,tp=2` flag, as the JAX
package's does.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple, Union

import torch

from gesture2vec_tpu_torch.cluster.latent_dataset import load_latent_dataset
from gesture2vec_tpu_torch.compat.checkpoint import (
    T2T_CONFIG_DEFAULTS, load_checkpoint_and_model)
from gesture2vec_tpu_torch.device import resolve_device
from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
from gesture2vec_tpu_torch.text.vocab import Vocab, build_vocab

# the JAX package's Config defaults for the generator fields read here
_GEN_DEFAULTS = {**T2T_CONFIG_DEFAULTS, "motion_resampling_framerate": 24,
                 "text_context_s": 0.0}


def parse_mesh_shape(mesh_spec: Optional[str]) -> Optional[Dict[str, int]]:
    """'dp=4,tp=2' -> {"dp": 4, "tp": 2} (None passes through)."""
    if not mesh_spec:
        return None
    return {k.strip(): int(v) for k, v in (kv.split("=")
                                           for kv in mesh_spec.split(","))}


def parse_mesh(mesh_spec: Optional[str], device=None):
    """'dp=4,tp=2' -> a `parallel/mesh.Mesh` on device (None passes
    through); too few cards raise ValueError."""
    from gesture2vec_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(parse_mesh_shape(mesh_spec), device)


def fused_decoder_policy(seq_decoder, policy: Dict[str, Any]
                         ) -> Dict[str, Any]:
    """The generator options with use_fused_decoder False (and the reason
    logged) when the tokenizer's decoder cannot run the chunk-decoder
    kernel (decoder attention, a parity checkpoint's eval step dropout,
    ...) and the caller did not ask for the kernel; a caller who asks for
    it still gets the generator's refusal."""
    reason = seq_decoder.kernel_reason()
    if not reason or "use_fused_decoder" in policy:
        return policy
    logging.info("the chunk rollout runs in plain PyTorch: %s", reason)
    return {**policy, "use_fused_decoder": False}


def build_generator(t2t_checkpoint: str, rep_checkpoint: str,
                    autoencoder_checkpoint: str, store,
                    mode: str = "decode",
                    latent_bank_path: Optional[str] = None,
                    device: Optional[Union[str, torch.device]] = None,
                    **policy) -> Tuple[GestureGenerator, Dict[str, Any]]:
    """(generator, the Part-d checkpoint's config). store is the corpus
    ClipStore (its pose statistics unnormalize the motion). policy holds
    the GestureGenerator's decode options (seed, temperature, top_k,
    stage0_temperature, beam_width, soft_decode, decode_overlap,
    chunk_continuity, exemplar_continuity, window_carry,
    use_fused_decoder: by default the kernel where the tokenizer's decoder
    admits it, else plain PyTorch, `fused_decoder_policy`). Runs on CUDA
    unless device says otherwise."""
    dev = resolve_device(device)
    t2t, t2t_payload = load_checkpoint_and_model(t2t_checkpoint,
                                                 "text2embedding", dev)
    dae, _ = load_checkpoint_and_model(rep_checkpoint, "DAE", dev)
    seq, _ = load_checkpoint_and_model(autoencoder_checkpoint,
                                       "autoencoder_vq", dev)
    cfg = {**_GEN_DEFAULTS, **t2t_payload["config"]}
    if t2t_payload.get("lang_model"):
        vocab = Vocab.from_state_dict(t2t_payload["lang_model"])
    else:
        vocab = build_vocab("corpus", [[w[0] for w in c["words"]]
                                       for c in store.clips])
    bank = (load_latent_dataset(latent_bank_path)
            if latent_bank_path else None)
    gen = GestureGenerator(
        t2t_model=t2t, seq_decoder=seq.decoder, dae_model=dae, vocab=vocab,
        pose_mean=store.pose_mean, pose_std=store.pose_std,
        n_frames=int(cfg["n_poses"]),
        sentence_frame_length=int(cfg["sentence_frame_length"]),
        fps=int(cfg["motion_resampling_framerate"]), mode=mode,
        latent_bank=bank, text_context_s=float(cfg["text_context_s"]),
        device=dev, **fused_decoder_policy(seq.decoder, policy))
    return gen, cfg


def load_bvh_exporter(dataset: str, pipeline_path: str,
                      twh_variant: str = "test1"):
    """Returns to_bvh(frames, path=None) -> BVHData|None for the
    dataset family (Trinity rotmat features or TWH variants), from the
    fitted data_pipe.json that either package's ingest writes."""
    if dataset == "twh":
        from gesture2vec_tpu_torch.infer.exporter import frames_to_bvh_twh
        from gesture2vec_tpu_torch.mocap.features import TWHFeatureExtractor
        fe = TWHFeatureExtractor.load(pipeline_path, twh_variant)

        def to_bvh(frames, path=None):
            return frames_to_bvh_twh(frames, fe, path=path)
    else:
        from gesture2vec_tpu_torch.infer.exporter import frames_to_bvh
        from gesture2vec_tpu_torch.mocap.features import FeatureExtractor
        fe = FeatureExtractor.load(pipeline_path)

        def to_bvh(frames, path=None):
            return frames_to_bvh(frames, fe, path=path)
    return to_bvh
