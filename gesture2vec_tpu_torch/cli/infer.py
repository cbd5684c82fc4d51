"""CLI: end-to-end text -> gesture BVH.

Replaces `python inference_text2embedding.py <t2e.ckpt> <transcript>
<DAE.ckpt> <VQVAE.ckpt>` (ref: scripts/inference_text2embedding.py:837+).

The port's copy of the JAX package's `cli/infer.py`, with the same
arguments and defaults; `--device` (default cuda) takes the place of
`--platform`:

    python -m gesture2vec_tpu_torch.cli.infer t2t.bin transcript.json \\
        dae.bin vq.bin --store STORE --pipeline data_pipe.json \\
        [--mode decode] [--latent-bank bank.npz] [--device cpu]

It reads the checkpoint files, clip stores, latent banks and
`data_pipe.json` that either package writes. `--plot-attention PNG`
(one transcript, a Part d with attention; needs matplotlib) saves the
first window's attention heatmap from the Part d's eval forward, as JAX
does. `--mesh dp=N` (the JAX CLI's flag) checks the mesh against the
cards and hands it to `GestureGenerator.generate_batch(mesh=)`, which in
this one process runs the transcripts as one batch (`parallel/mesh`).
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("t2t_checkpoint")
    parser.add_argument("transcript", nargs="+",
                        help="Google-STT JSON or GENEA TSV; several "
                             "files run as ONE batch (one output BVH "
                             "per transcript)")
    parser.add_argument("rep_checkpoint")
    parser.add_argument("autoencoder_checkpoint")
    parser.add_argument("--mesh", default=None,
                        help="shard a multi-transcript batch over a "
                             "device mesh, e.g. 'dp=2'")
    parser.add_argument("--latent-bank", default=None,
                        help="org_latent_clustering_data.npz "
                             "(required for exemplar mode)")
    parser.add_argument("--store", required=True,
                        help="train clip store (for mean/std + vocab)")
    parser.add_argument("--pipeline", required=True,
                        help="fitted data_pipe.json for BVH export")
    parser.add_argument("--mode", choices=["exemplar", "decode"],
                        default="exemplar")
    parser.add_argument("--dataset", choices=["trinity", "twh"],
                        default="trinity",
                        help="skeleton/export variant (ref: "
                             "inference_text2embedding.py DATASET_Type)")
    parser.add_argument("--twh-variant", default="test1")
    parser.add_argument("--out", default="generated.bvh")
    parser.add_argument("--duration", type=float, default=None,
                        help="seconds (default: last word end time)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0 = greedy token decode (reference "
                             "behavior); >0 samples tokens at this "
                             "softmax temperature")
    parser.add_argument("--top-k", type=int, default=0,
                        help="truncate sampling to the k best tokens "
                             "(0 = full distribution)")
    parser.add_argument("--stage0-temperature", type=float, default=-1.0,
                        help="multi-stage Part d: override the PRIMARY "
                             "token's temperature only (0 = greedy "
                             "semantic choice while residual stages "
                             "sample at --temperature); -1 = one "
                             "policy for all stages")
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
    parser.add_argument("--plot-attention", default=None,
                        help="save the first window's attention heatmap "
                             "(needs matplotlib)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda raises without a card; "
                             "cpu runs the plain PyTorch path)")
    return parser


def run(args: argparse.Namespace
        ) -> List[Tuple[np.ndarray, np.ndarray, str]]:
    """Generates and writes one BVH per transcript; returns (frames,
    tokens, written path) per transcript. Several transcripts run as one
    `generate_batch`, each written to `{stem}_{base}{ext}`."""
    from gesture2vec_tpu_torch.cluster.plots import have_matplotlib
    if args.plot_attention and not have_matplotlib():
        raise ValueError("--plot-attention needs matplotlib")
    from gesture2vec_tpu_torch.cli._common import (build_generator,
                                                   load_bvh_exporter,
                                                   parse_mesh)
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.io.subtitles import read_subtitles

    store = ClipStore(args.store)
    gen, cfg = build_generator(args.t2t_checkpoint, args.rep_checkpoint,
                             args.autoencoder_checkpoint, store,
                             mode=args.mode,
                             latent_bank_path=args.latent_bank,
                             device=args.device, seed=args.seed,
                             temperature=args.temperature,
                             top_k=args.top_k,
                             beam_width=args.beam_width,
                             exemplar_continuity=args.exemplar_continuity,
                             decode_overlap=args.decode_overlap,
                             soft_decode=args.soft_decode,
                             stage0_temperature=args.stage0_temperature)
    to_bvh = load_bvh_exporter(args.dataset, args.pipeline,
                               args.twh_variant)

    all_words = [read_subtitles(t) for t in args.transcript]
    durs = [args.duration or (w[-1][2] if w else 6.0) for w in all_words]
    t0 = time.time()
    if len(all_words) > 1:
        # a dp mesh: in this one process the batch runs whole
        results = gen.generate_batch(all_words, durs,
                                     mesh=parse_mesh(args.mesh, gen.device))
        stem, ext = os.path.splitext(args.out)
        paths = [f"{stem}_{os.path.splitext(os.path.basename(t))[0]}"
                 f"{ext or '.bvh'}" for t in args.transcript]
    else:
        results = [gen.generate(all_words[0], durs[0])]
        paths = [args.out]
    dt = time.time() - t0
    total = sum(f.shape[0] for f, _ in results)
    logging.info("generated %d transcripts, %d frames in %.2fs "
                 "(%.0f frames/s)", len(results), total, dt, total / dt)
    if args.plot_attention and len(all_words) == 1 \
            and gen.t2t_model.use_attention:
        plot_first_window_attention(gen, all_words[0], cfg,
                                    args.plot_attention)
    for (frames, _), path in zip(results, paths):
        to_bvh(frames, path=path)
        print(f"wrote {path}")
    return [(f, t, p) for (f, t), p in zip(results, paths)]


@torch.inference_mode()
def plot_first_window_attention(gen, words, cfg: dict, path: str) -> None:
    """The first window's attention heatmap (`cluster/plots.plot_attention`):
    the transcript's first max_words words (the config's extras, 48 by
    default) as ids bracketed by SOS / EOS in a 48-wide row, through the
    Part d's eval forward; the rows are its decode steps, the columns the
    ids, labelled by the vocabulary."""
    from gesture2vec_tpu_torch.cluster.plots import plot_attention

    model, vocab = gen.t2t_model, gen.vocab
    window_words = [w[0] for w in words][:int(cfg.get("max_words", 48))]
    wid = vocab.words_to_ids(window_words)[:48]
    ids = torch.zeros((1, 48), dtype=torch.long, device=gen.device)
    ids[0, :len(wid)] = torch.as_tensor(wid, dtype=torch.long)
    lengths = torch.tensor([max(len(wid), 1)], device=gen.device)
    res = model(ids, lengths, torch.zeros((1, model.n_steps),
                                          dtype=torch.long,
                                          device=gen.device))
    attn = res["attentions"][:, 0, :len(wid)].float().cpu().numpy()
    labels = [vocab.index2word.get(int(i), "?") for i in wid]
    plot_attention(attn, path, words=labels)
    logging.info("attention heatmap -> %s", path)


def main(argv: Optional[Sequence[str]] = None
         ) -> List[Tuple[np.ndarray, np.ndarray, str]]:
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
