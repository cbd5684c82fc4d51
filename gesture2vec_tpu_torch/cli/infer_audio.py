"""CLI: end-to-end speech -> gesture BVH (the audio-context Part d).

The port's copy of the JAX package's `cli/infer_audio.py`
(`g2v-infer-audio`), with the same arguments and defaults; `--device`
(default cuda, which raises without a card) takes the place of
`--platform`, and JAX's `--jax-cache` has no counterpart:

    python -m gesture2vec_tpu_torch.cli.infer_audio a2t.bin speech.wav \\
        dae.bin vq.bin --store STORE --pipeline data_pipe.json \\
        [--mode decode|exemplar] [--latent-bank bank.npz] [--device cpu]

A checkpoint trained with `audio_fusion: both` also needs
`--transcript` (Google-STT JSON or GENEA TSV); its vocabulary is the
checkpoint's `lang_model`, else the store's words. It reads the
checkpoint files, clip stores, latent banks and `data_pipe.json` that
either package writes, and writes the BVH through `infer/exporter`. The
chunk rollout runs the chunk-decoder kernel where the tokenizer's decoder
admits it, else plain PyTorch, chosen from the logged reason
(`cli/_common.fused_decoder_policy`).
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Optional, Sequence, Tuple

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("a2t_checkpoint")
    parser.add_argument("wav", help="mono wav file (16 kHz)")
    parser.add_argument("rep_checkpoint")
    parser.add_argument("autoencoder_checkpoint")
    parser.add_argument("--store", required=True,
                        help="train clip store (for pose mean/std)")
    parser.add_argument("--pipeline", required=True,
                        help="fitted data_pipe.json for BVH export")
    parser.add_argument("--mode", choices=["decode", "exemplar"],
                        default="decode")
    parser.add_argument("--latent-bank", default=None,
                        help="org_latent_clustering_data.npz "
                             "(required for exemplar mode)")
    parser.add_argument("--transcript", default=None,
                        help="subtitle JSON/TSV; required when the "
                             "checkpoint was trained with "
                             "audio_fusion='both' (text+audio fusion)")
    parser.add_argument("--out", default="generated_audio.bvh")
    parser.add_argument("--duration", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0 = greedy token decode (reference "
                             "behavior); >0 samples tokens at this "
                             "softmax temperature")
    parser.add_argument("--top-k", type=int, default=0,
                        help="truncate sampling to the k best tokens "
                             "(0 = full distribution)")
    parser.add_argument("--beam-width", type=int, default=0,
                        help="beam-search token decode with this "
                             "many hypotheses (0/1 = greedy; "
                             "exclusive with --temperature)")
    parser.add_argument("--decode-overlap", type=int, default=0,
                        help="decode mode: overlap-blend this many "
                             "frames across chunk boundaries")
    parser.add_argument("--soft-decode", type=float, default=0.0,
                        help="decode mode: rebuild each chunk's "
                             "hidden from the softmax codebook "
                             "mixture at this temperature instead "
                             "of the hard argmax row (0 = reference "
                             "behavior)")
    parser.add_argument("--exemplar-continuity",
                        action="store_true",
                        help="exemplar mode: continuity-aware "
                             "retrieval (motion matching) instead "
                             "of the reference's random pick")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda raises without a card; "
                             "cpu runs the plain PyTorch path)")
    return parser


def run(args: argparse.Namespace) -> Tuple[np.ndarray, np.ndarray, str]:
    """Generates and writes the BVH; returns (frames, tokens, path)."""
    from gesture2vec_tpu_torch.cli._common import (_GEN_DEFAULTS,
                                                   fused_decoder_policy,
                                                   load_bvh_exporter)
    from gesture2vec_tpu_torch.cluster.latent_dataset import \
        load_latent_dataset
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.device import resolve_device
    from gesture2vec_tpu_torch.infer.audio2gesture import \
        AudioGestureGenerator
    from gesture2vec_tpu_torch.io.audio import AUDIO_SR, load_wav

    dev = resolve_device(args.device)
    store = ClipStore(args.store)
    a2t, payload = load_checkpoint_and_model(args.a2t_checkpoint,
                                             "audio2token", dev)
    dae, _ = load_checkpoint_and_model(args.rep_checkpoint, "DAE", dev)
    seq, _ = load_checkpoint_and_model(args.autoencoder_checkpoint,
                                       "autoencoder_vq", dev)
    cfg = {**_GEN_DEFAULTS, **payload["config"]}
    wave = load_wav(args.wav)
    words, vocab = None, None
    if a2t.fusion == "both":
        if not args.transcript:
            raise SystemExit("this checkpoint was trained with "
                             "audio_fusion='both'; pass --transcript")
        from gesture2vec_tpu_torch.io.subtitles import read_subtitles
        from gesture2vec_tpu_torch.text.vocab import Vocab, build_vocab
        words = read_subtitles(args.transcript)
        if payload.get("lang_model"):
            vocab = Vocab.from_state_dict(payload["lang_model"])
        else:
            vocab = build_vocab("corpus", [[w[0] for w in c["words"]]
                                           for c in store.clips])
    gen = AudioGestureGenerator(
        a2t_model=a2t, seq_decoder=seq.decoder, dae_model=dae,
        pose_mean=store.pose_mean, pose_std=store.pose_std,
        n_frames=int(cfg["n_poses"]),
        sentence_frame_length=int(cfg["sentence_frame_length"]),
        fps=int(cfg["motion_resampling_framerate"]), audio_sr=AUDIO_SR,
        mode=args.mode, latent_bank=(load_latent_dataset(args.latent_bank)
                                     if args.latent_bank else None),
        seed=args.seed, vocab=vocab, temperature=args.temperature,
        top_k=args.top_k, beam_width=args.beam_width,
        exemplar_continuity=args.exemplar_continuity,
        decode_overlap=args.decode_overlap, soft_decode=args.soft_decode,
        device=dev, **fused_decoder_policy(seq.decoder, {}))
    t0 = time.time()
    frames, tokens = gen.generate(wave, args.duration, words=words)
    dt = time.time() - t0
    logging.info("generated %d frames (%d tokens) in %.2fs "
                 "(%.0f frames/s)", frames.shape[0], len(tokens), dt,
                 frames.shape[0] / dt)
    load_bvh_exporter("trinity", args.pipeline)(frames, path=args.out)
    print(f"wrote {args.out}")
    return frames, tokens, args.out


def main(argv: Optional[Sequence[str]] = None
         ) -> Tuple[np.ndarray, np.ndarray, str]:
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
