"""Serve text -> gesture generation over HTTP with micro-batching.

The port's copy of the JAX package's `cli/serve.py`, with the same
arguments and defaults but two: `--device` (default cuda) takes the
place of `--platform`, and `--stream-batch` is a cap that defaults to 16
(decode-mode streams always share the stream-step batcher, which runs a
lone session's step at once; on an H100 it served 16 and 64 concurrent
sessions several times faster than a step a session):

    python -m gesture2vec_tpu_torch.cli.serve t2t.bin dae.bin vq.bin \\
        --store STORE --pipeline data_pipe.json [--port 8008] \\
        [--max-batch 32] [--batch-window-ms 50] [--mode decode|exemplar] \\
        [--latent-bank bank.npz] [--stream-batch 16] [--device cpu]

POST /generate with {"words": [[w, start, end], ...]} returns BVH text,
POST /stream the chunked NDJSON windows, GET /healthz the batching
stats (serve/server.py). Ctrl-C (SIGINT) stops the server and exits 0.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("t2t_checkpoint")
    parser.add_argument("rep_checkpoint")
    parser.add_argument("autoencoder_checkpoint")
    parser.add_argument("--store", required=True)
    parser.add_argument("--pipeline", required=True,
                        help="fitted pipeline json for BVH export")
    parser.add_argument("--mode", choices=["exemplar", "decode"],
                        default="decode")
    parser.add_argument("--latent-bank", default=None)
    parser.add_argument("--dataset", choices=["trinity", "twh"],
                        default="trinity")
    parser.add_argument("--twh-variant", default="test1")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--max-batch", type=int, default=32,
                        help="most concurrent /generate requests fused "
                             "into one generate_batch")
    parser.add_argument("--batch-window-ms", type=float, default=50.0)
    parser.add_argument("--stream-batch", type=int, default=16,
                        help="decode mode: the most due /stream window "
                             "steps of concurrent sessions run as one "
                             "batched step (a lone session's step runs "
                             "at once; 1 = every step alone)")
    parser.add_argument("--stream-batch-window-ms", type=float,
                        default=10.0,
                        help="how long a due stream step waits for "
                             "peers before it runs")
    parser.add_argument("--request-timeout", type=float, default=120.0,
                        help="seconds a request may wait for generation")
    parser.add_argument("--mesh", default=None,
                        help="e.g. dp=2, the JAX CLI's flag: checked "
                             "against the cards; one process runs each "
                             "fused /generate batch whole")
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
                             "frames across chunk boundaries "
                             "(reference-style sliding-window "
                             "blending applied to the token decode)")
    parser.add_argument("--soft-decode", type=float, default=0.0,
                        help="decode mode: rebuild each chunk's "
                             "hidden from the softmax codebook "
                             "mixture at this temperature instead "
                             "of the hard argmax row (0 = reference "
                             "behavior; the GS-Soft decoder is "
                             "trained on soft mixtures)")
    parser.add_argument("--exemplar-continuity",
                        action="store_true",
                        help="exemplar mode: continuity-aware "
                             "retrieval (motion matching) instead "
                             "of the reference's random pick")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda raises without a card; "
                             "cpu runs the plain PyTorch path)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from gesture2vec_tpu_torch.cli._common import (build_generator,
                                                   load_bvh_exporter,
                                                   parse_mesh)
    from gesture2vec_tpu_torch.device import resolve_device

    # before any file is read: no card and no --device cpu raises here,
    # and so does a mesh the cards cannot hold
    device = resolve_device(args.device)
    mesh = parse_mesh(args.mesh, device)

    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.io.bvh import write_bvh
    from gesture2vec_tpu_torch.serve.server import serve

    logging.basicConfig(level=logging.INFO)
    store = ClipStore(args.store)
    gen, _ = build_generator(args.t2t_checkpoint, args.rep_checkpoint,
                             args.autoencoder_checkpoint, store,
                             mode=args.mode,
                             latent_bank_path=args.latent_bank,
                             device=device, seed=args.seed,
                             temperature=args.temperature,
                             top_k=args.top_k,
                             beam_width=args.beam_width,
                             exemplar_continuity=args.exemplar_continuity,
                             decode_overlap=args.decode_overlap,
                             soft_decode=args.soft_decode)
    to_bvh = load_bvh_exporter(args.dataset, args.pipeline,
                               args.twh_variant)

    def export_bvh(frames):
        return write_bvh(to_bvh(frames, path=None))

    httpd = serve(gen, host=args.host, port=args.port,
                  export_bvh=export_bvh, max_batch=args.max_batch,
                  batch_window_s=args.batch_window_ms / 1000.0,
                  mesh=mesh, request_timeout_s=args.request_timeout,
                  stream_batch=args.stream_batch,
                  stream_batch_window_s=args.stream_batch_window_ms
                  / 1000.0)
    logging.info("serving on http://%s:%d (mode=%s, device=%s, "
                 "max_batch=%d, window=%.0fms)", args.host,
                 httpd.server_address[1], args.mode, device,
                 args.max_batch, args.batch_window_ms)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
