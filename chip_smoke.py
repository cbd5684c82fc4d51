#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

It drives sixteen paths of the port, each with every kernel launch
counter set to 0 just before and read just after. Phases, each printing one
JSON line:
  device   the card's name and power limit (nvidia-smi);
  build    nvcc builds every kernel from the sources in the checkout (one
           process per source, all at once), with the ptxas register /
           shared-memory / spill lines;
The decode path (text -> gesture generation):
  kernel   the chunk decoder against its plain PyTorch version on the
           card, at the path's shapes (and at the training path's Part-b
           validation, B=128 over 19 steps), with times from CUDA events
           (n and 2n steps), and its launch shape (16-block clusters, rows per tile) as the
           kernel reports it, held against the wrapper's mirror;
  main     decode-mode generation at the bench widths (hidden 200,
           2 layers, 512 codes, DAE latent 40, pose 135, 20-frame
           chunks, 120-frame windows, 48 words, 5000-word table of
           300-dim embeddings), weights random from a seed and carried
           in through the JAX-layout weight bridge; three requests
           (6 s, 60 s and 1800 s transcripts);
  check    the frames' shape and finiteness, the fused path against the
           module rollout on the card, and the card against the CPU
           path on the 6 s request;
  timing   frames/s of each request and its stages;
The Part-c path (corpus tokenizer sweep and K-Means):
  kernel   the GRU-sequence kernel (T=20, H=200, B 300 and 512, forward
           and reverse) and the VQ-argmin kernel (D=400, (N, K) = (128,
           512) and (5,120, 512) of the training path, (300, 300), (58,488,
           300), (2^20, 512); D=40, the Part-a VQFrame's (128, 80) and its
           K-Means re-fit's (52,000, 80)) against their plain versions,
           with cuDNN's GRU as the GRU's yardstick, and each launch shape
           as the kernel reports it, held against the wrapper's mirror;
  kernel_edges  the chunk decoder at every edge of its tiles (B 1 to
           1824), at unaligned rows and at widths staged by plain loads;
           both Part-c kernels at the ragged edges of their tiles, at widths
           and addresses that take their 4-byte staging copies, and on
           exact ties between codes in two code tiles;
  main     a synthetic store the size of the Trinity/GENEA 2020 corpus
           (24 clips x 12,200 frames x 135, 244 minutes at 20 fps) and a
           2-clip validation store, random checkpoints in the JAX
           package's file format (configs/DAE.yml, configs/VQ-VAE.yml),
           then `python -m gesture2vec_tpu_torch.cli.cluster dae.bin
           vq.bin --store ... --val-store ... --kmeans 300` (run
           in-process through its main()), then the residual-VQ sweep of
           configs/VQ-VAE_rvq.yml with all stage tokens;
  timing   windows/s of the sweep and its stages, K-Means, metrics, and
           the device's idle share;
  check    kernel path against plain path on the card (tokens, latents,
           K-Means from the same initial centers), and the card against
           the CPU path on the first 2,048 windows;
Exemplar mode (in the Part-c phase's directory):
  main     `cli/_common.build_generator` from the Part-c DAE and tokenizer
           checkpoints, a text2embedding checkpoint written in the JAX
           package's format at the bench widths (TCN encoder) and the
           cluster CLI's 58,488-window bank; the 6 s, 60 s and 1800 s
           requests with and without exemplar_continuity (no kernel runs:
           the launch counts must stay 0); the bank's device bytes;
  check    shapes and finiteness; tokens, picks and frames of the card
           against the CPU on the 60 s request;
  timing   request seconds, stages (tokens, picks, gather + DAE decode)
           and the device's idle share;
The two commands (in the same directory, after exemplar mode):
  main     `python -m gesture2vec_tpu_torch.cli.make_dataset` (its
           main()) over a Trinity-layout corpus of 4 BVH files of 60 s
           at 60 fps with transcripts and audio (tests/corpus.py): the
           stores open, the features are 135 wide, data_pipe.json loads
           and a clip's features -> to_bvh -> write_bvh -> parse ->
           transform round trip agrees within 1e-4; seconds and source
           frames/s. Then `g2v-infer` (`cli/infer.main`) from exemplar
           mode's text2embedding checkpoint, the Part-c checkpoints and
           train store and the ingest's data_pipe.json, on Google-STT
           transcripts: decode mode at 6 s, 60 s and 1800 s, three 60 s
           transcripts in one call (generate_batch) and exemplar mode at
           60 s over the cluster CLI's bank; one `chunk_decoder` launch a
           decode call, none in exemplar mode; frames and BVH files
           checked for shape and finiteness;
  check    the same 60 s decode call with --device cpu: tokens identical
           or a counted near-tie, frames within 1e-4, identical BVH
           headers and frame counts, the largest BVH motion difference
           printed;
  timing   the 1800 s decode call stage by stage, each function it
           calls wrapped in a timer: checkpoint and vocab load, pipeline
           load, generate, savgol, features_to_euler, smoothing_spline,
           inverse_transform, write_bvh;
g2v-serve (in the same directory, after the commands):
  main     `serve()` in process on port 0 with the decode path's
           generator, 60 s requests: /generate from 8 sequential clients,
           then 16 and 32 at once (fused up to 32), one 6 s BVH answer
           through the ingest's data_pipe.json; /stream from 1, 16 and 64
           sessions through the stream-step batcher capped at 1 (every
           step alone) and 16 and 64 capped at 16; one stream each with
           chunk_continuity, the recipe's Part d and exemplar continuity
           over the cluster CLI's bank; the GRU text encoder's Part d:
           8 /stream sessions through the batcher and 4 concurrent
           /generate requests; launches, every rollout's chunk batch
           (each among KERNEL_BATCHES) and every GRU recurrence's batch
           (each among GRU_T48_BATCHES) per run; then
           `python -m gesture2vec_tpu_torch.cli.serve` as a subprocess:
           /healthz, /generate, /stream, SIGINT, exit code 0;
  check    every answer against the card's `generate` on its words,
           batched streams against unbatched ones, one /generate and one
           /stream answer against the CPU (tokens identical or a counted
           near-tie, frames within 1e-4); no answer but 200;
  timing   /generate frames/s, worker and client p50/p99, batches; /stream
           time to the first window, per-window p50/p99, windows/s and
           the batcher's stats; idle share over the 32-client /generate
           and the 64-session batched /stream;
The decode policies at the bench widths:
  kernel   the chunk decoder at 24 steps (decode_overlap 4) and at B=1
           (chunk_continuity), the GRU sequence at T=48 (the text
           encoder's word window) for each of GRU_T48_BATCHES windows
           (the serve path's among them), against their plain versions,
           with cuDNN's layer beside the GRU;
  policy   one line per policy (sampled at top_k 0 and 50, stage0 greedy
           on a 4-stage model, beam 4, soft 1.0, overlap 4,
           chunk_continuity, 4-stage stage_conditional, the GRU encoder)
           on the 60 s request: launches per request, the
           kernel path against the module path on the card and the card
           against the CPU at 60 s (tokens identical, frames within 1e-4,
           a first differing window counted only as a near-tie of the
           reference's decision scores), request seconds and stages;
The Part-c sweep with `seq_arch: transformer` tokenizers (in the Part-c
phase's directory):
  main     GS-Soft and 4-stage residual-VQ tokenizers with the transformer
           chunk encoder (random, written as the JAX package's
           checkpoints) over the 244-minute store, K-Means (K=300) on the
           GS-Soft latents: launches (no `gru_sequence`), distinct codes;
  timing   windows/s of each sweep and its tokenize stage, idle share;
  check    the residual tokens of the kernel path against the plain path
           on the card, both sweeps against the CPU on the first windows;
The recommended recipe (configs/seq2seqtxt_recommended.yml: the
transformer Part d, 4 heads, 4 chained stages, teacher prefix 1, over
configs/VQ-VAE_rvq.yml's 4-stage tokenizer), weights through the bridge:
  recipe   one line per policy (greedy; temperature 0 with
           stage0_temperature 1, the recipe's; beam 4) on the 60 s
           request: launches per request, the kernel path
           against the module path on the card and the card against the
           CPU at 60 s (tokens identical or a counted near-tie, frames
           within 1e-4), request seconds and stages, idle share at 60 s;
           then exemplar mode at 60 s over Part c's residual-VQ bank;
The audio-context family (configs/audio.yml's Audio2Token, random, written
as an audio2token checkpoint and loaded through compat/from_jax, over
Part c's DAE and GS-Soft tokenizer, in the Part-c phase's directory;
synthetic speech from seeds):
  kernel   the GRU sequence at T=6 (a step a second of a 6 s window) for
           B 1, 10, 128 and 300 and at T=48 (the fusion encoder's word
           window) for B=10, and the chunk decoder at B 60 and 1800 (20
           steps; 24 at B=60, decode_overlap 4), against their plain
           versions, with cuDNN's layer beside the GRU;
  audio    one line a run: decode mode at 6 s, 60 s and 1800 s (4
           `gru_sequence` and 1 `chunk_decoder` launches a request, the
           kernel path against the module path on the card, the card
           against the CPU at 60 s, request seconds and stages - the mel
           frontend on the host, the encode, the tokens, the decode and
           DAE - and the idle share at 1800 s); exemplar mode over the
           cluster CLI's bank with and without continuity at 60 s (4 and
           0); at 60 s sampled (temperature 1, top_k 50), beam 4, soft
           1.0, overlap 4 and `audio_fusion: both` with words, each
           against the module path and the CPU; 8
           AudioStreamingGestureSessions sharing one step over 60 s of
           speech each, every stream's windows against `generate`;
           `cli/infer_audio.main` at 60 s to a BVH through the ingest's
           data_pipe.json; every kernel shape among those compared;
The analysis and reconstruction paths (in the Part-c phase's directory,
over its DAE and GS-Soft tokenizer, train and validation stores and
bank, and the cli path's ingest):
  analysis one line a run: `decode_codebook` (the 512 codes from zero
           seeds: one chunk-decoder launch at B=512, 19 steps, against
           the plain rollout on the card); `silhouette_sweep` over the
           bank's first 2,000 sequence latents, K=2..11 (VQ-argmin
           launches only; the torch silhouette on the card against the
           CPU within 1e-5); `export_cluster_samples` from the bank, 2 a
           token (the file count); `cli/cluster` over the validation
           store with --kmeans 8 --export-samples 2 --pipeline (its
           launches); `cli/reconstruct` on a corpus BVH, Part a, Part a+b
           with --overlap 5 (4 `gru_sequence` and 1 `chunk_decoder`
           launches), with --warmup-steps 5 (the same) and over an
           `autoencoder_att` tokenizer at VQ-VAE.yml's widths written in
           the JAX file format (4 and 0: its decode is plain PyTorch),
           each with --html-player and against its --device cpu run
           within 1e-4; a parity checkpoint (eval step dropout): refused
           on the card with the kernel on, reproducible with it off;
  kernel   the three kernels at every shape the runs launched them at,
           against their plain versions, with cuDNN's layer beside the
           GRU;
  check    every launch's shape compared, and the line of what the path
           leaves to the CPU tests and why;
Training, `g2v-train` parts a, b, d and audio (`cli/train.main()`):
  kernel   at T=20 with B=128 and 512, T=48 with B=128, a ragged B=117
           and the similarity step's pairs, B=3 (H=200, both directions;
           each output's error relative to
           the reference's largest magnitude): the GRU forward's training
           variant (which saves the gates) against the inference launch,
           outputs bitwise equal and the two timed in turns, its gates
           against the gates recomputed from its outputs; the backward
           kernel against its plain version on the same gates and
           GRUSequenceFn's gradients against autograd through the plain
           forward; CUDA-event means of 20 launches after 3 warm-ups, the
           bounds (the backward's also as the recomputing design had it),
           cuDNN's backward of one GRU layer with the same weights
           (torch.autograd.grad) as the yardstick of the Function's whole
           backward, and cuDNN's forward + backward against gru_layer's
           (the VQ-argmin kernel at the VQFrame's D=40 runs in the Part-c
           phase's kernel rows);
  train    a synthetic store 135 wide (4 clips x 13,000 frames, a word
           every 0.4 s; one 4,500-frame validation clip) and configs
           written from configs/DAE.yml (the DAE; the VQFrame, 80 codes;
           the VAEFrame; the VQFrame with VAE heads through
           `train_dae(vq_tricks=True)`, its first epoch the delayed-VQ
           warmup and a K-Means re-fit over the 52,000 frames before its
           second), VQ-VAE.yml (GS-Soft; the VAE tokenizer over the
           VQFrame's latents, the plain autoencoder and the
           similarity-supervised step over a 400-line label file the
           script writes), VQ-VAE_rvq.yml
           (rvq_reestimate_every 1; then seq_arch: transformer, the
           transformer chunk encoder), seq2seqtxt.yml (text_encoder tcn,
           then gru), audio.yml (the audio Part d: mel chunks of each
           clip's synthetic 16 kHz speech; its checkpoint through an
           AudioGestureGenerator to 6 s of motion) and
           seq2seqtxt_recommended.yml (the recipe's
           transformer Part d over the 4-stage residual VQ, its second
           epoch on the feedback-matched finetune step) at their widths,
           epochs cut to 1 (2 for the residual VQ, the VQFrame,
           vq_tricks, the VAE tokenizer and the recipe); one
           line a run: the command's launches against those its train
           steps, validation batches, K-Means re-fits and teacher sweeps
           must make (vq_tricks' by phase: the warmup epoch, the re-fit,
           the epoch after), and its seconds; then, from a separate loop
           over the command's own arrays on a fresh model, launches per
           train step and per validation batch, steps/s and samples/s
           (10 steps in parts b and d), the forward / backward /
           optimizer split, the device's idle share and device ops per
           step over a few profiled steps (for the recipe, of the
           teacher-forced and of the feedback step; for vq_tricks, of the
           VQ and of the warmup step); the first step's loss and each
           epoch's;
  check    the command's launches, every kernel launch's shape (each
           held against the plain version in a kernel phase), finite
           losses, the last epoch's mean below the first step's,
           the launches per step (GRU 4 forward and 4 backward in the
           BiGRU's Part b and the GRU encoder's Part d, 12 and 12 in the
           similarity step, 4 argmins under residual VQ, 1 in the
           VQFrame's step and validation batch, no chunk decoder, none in
           the recipe's steps), one launch of the GRU forward's training
           variant for each backward launch, >= 1 chunk-decoder launch
           per Part-b validation batch, one train step per run (and the
           recipe's feedback step, vq_tricks' warmup step) on the card
           against the CPU from the same weights (loss, every gradient
           and every buffer the step updates - BatchNorm statistics, the
           EMA state - within 1e-4; a feedback step whose choices, or a
           VQFrame step whose codes, differ only at a near-tie is counted
           as one, and so are gradients where a ReLU's or an |x|'s input
           lies on another side of 0 on the card only within 1e-5 of its
           call's largest magnitude), and each Part-d checkpoint through
           `cli/_common.build_generator` (over its own tokenizer, and
           d_tcn's over the VQFrame DAE and the VAE tokenizer) to finite
           frames of a 6 s transcript with one chunk-decoder launch;
compute_dtype: bfloat16 (over the train path's store and checkpoints):
  kernel   the four bf16 instantiations (GRU sequence, its gate-saving
           variant, GRU backward at T=20, 48 and 6, B=128, both
           directions; chunk decoder at B=128, 19 steps) against their
           bf16 plain versions within 2^-6 of the largest magnitude, with
           the fp32 kernel's time on the same values in turns, the bound
           (bf16 bytes against the operations at the bf16 tensor-core
           peak; beside it the fp32 CUDA-core figure) and cuDNN's bf16
           GRU;
  train_bf16  `cli/train.main()` with compute_dtype: bfloat16 over
           configs/VQ-VAE.yml, seq2seqtxt.yml (GRU encoder),
           seq2seqtxt_recommended.yml (feedback epoch, over the residual
           VQ) and audio.yml: the command's launches and losses, and as
           for the fp32 runs steps/s, the split, the idle share, beside
           the fp32 run's; bf16 steps on the card against the CPU's
           bf16 steps on two batches (the loss, each gradient and their
           median within BF16_CARD_LOSS_TOL, _TOL, _MEDIAN_TOL), each
           one's distance from the CPU's fp32 step printed beside them;
  check    a bf16 step launches only the bf16 instantiations (4 + 4 a
           BiGRU step, 4 forward a validation batch and 1 chunk decode
           a Part-b one), no fp32 kernel; losses fall; a bf16 Part d and
           tokenizer through `build_generator` give fp32 models and
           finite frames of a 6 s transcript;
The streaming source:
  stream   Part a from StreamingFrames and Part b from StreamingWindows
           with the frozen DAE as the prefetch worker's transform, one
           epoch each beside the in-RAM arrays: steps/s, the host's peak
           RSS, the launches (equal), both losses falling;
The baseline, c2g and the unrolled GAN (over the train path's store, its
DAE and GS-Soft tokenizer):
  misc_train  `cli/train.main()` with --part baseline (configs/seq2seq.yml),
           c2g (configs/c2g.yml, over 512 codes) and gan (configs/gan.yml,
           10 unrolled D updates) at their widths (hidden 200, 2 layers,
           batch 128, 20 frames, 300-dim word vectors, noise 400), one
           epoch each: the command's launches against those its steps,
           validation batches and c2g's tokenizer sweep must make; from a
           separate loop on fresh models, launches per step (MISC_STEP_
           LAUNCHES: 4 + 4 for the baseline, 2 + 2 for c2g, 146 + 138 for
           the GAN, derived beside it) and per validation batch, steps/s,
           the split (forward / backward / optimizer; the GAN's fake batch
           / 11 D updates / generator step), idle share and device ops;
           one step card against CPU (the GAN's: the fake batch, the first
           D update's gradients, the whole step's losses, generator
           gradients and BatchNorm statistics) within 1e-4; losses finite
           and falling (the GAN's D loss);
  kernel   the GRU sequence at T 32, 20 and 1 (B=128), 32 (B=1) and 1
           (B=512), its training kernels at the first three, and the chunk
           decoder with the trained c2g's step at B 128 and 512 (19
           steps), each against its plain version, cuDNN beside the GRU;
  check    `generate_baseline` over the trained baseline and a 60 s
           transcript, card against CPU within 1e-4 (4 `gru_sequence`
           launches a window); c2g over all 512 ids through one chunk
           decoder launch against its plain loop, and the
           parity_frozen_hidden model plain with none; every launch's
           shape compared;
Scale-out (parallel/: the mesh, its ranks, the pipeline), at the widths
of configs/VQ-VAE.yml (hidden 200, 2 layers, 512 codes, latent 40, 20
frames, batch 128; 512 random windows, one epoch of 4 steps and one
validation batch). The card is one, so NCCL runs at world size 1 and
the multi-rank checks are gloo ranks sharing it (their collectives
staged through pinned host memory):
  scale_out  `make_mesh({"dp": 2})` on the card raises; `train_seq_ae`
           with mesh_shape {dp: 1} in one spawned NCCL rank against the
           run without a mesh (losses within 1e-6); in two gloo ranks:
           dp=2 against the single run of the same global batch (losses
           within 1e-4), configs/VQ-VAE_rvq.yml over dp=1 x tp=2 (losses
           within 1e-4 of its single run; vq_argmin on 256-row shards)
           and its tokenizer's stage tokens over tp=2 against the
           unsharded tokens (identical), `pipelined_gru_stack` over pp=2
           (H=200, T=20, B=128, 4 microbatches) against the sequential
           stack (forward and gradients within 1e-4); then
           `generate_batch(mesh=make_mesh({"dp": 1}))` at the bench widths
           against the call without a mesh (identical tokens). Each
           training run is made three times in its rank: a warm-up, a
           timed run (its launches counted against those derived from
           the code: `train_want_launches`, 2 + 4 for the tp tokens,
           4 + 4 a pp stage) and a run under the collective clock
           (collectives' and pipeline hops' host time); steps/s of the
           timed runs beside the single run's; the kernels at the
           ranks' shapes (GRU at B=64 and 128, also against cuDNN, VQ
           argmin on (128, 256) and (64, 512), the chunk decoder at
           B=64) against their plain versions;
The tools path (`python -m gesture2vec_tpu_torch.cli.tools`, over the train
path's and the misc path's checkpoints, each stage timed by
utils/profiling.StageTimer):
  main     the train path's DAE, GS-Soft tokenizer and GRU-encoder Part d
           written as reference .pt payloads ({args, epoch, pose_dim,
           gen_dict}, tests/torch_reference_layout.py) and brought back by
           `import-checkpoint` (every tree and header bit for bit); then
           `g2v-infer --mode decode` at 60 s over the imported files and
           over the originals (the same tokens and frames, 1 chunk-decoder
           and 4 gru_sequence launches each) and over the imported files
           with --device cpu (tokens identical or a counted near-tie,
           frames within 1e-4); the validation store's windows through
           the imported DAE and tokenizer, card against CPU (differing
           tokens only at near-ties of the plain log-assignment; 2
           gru_sequence launches per 512 windows, no vq_argmin: GS-Soft
           tokens are the soft assignment's argmax); `baseline-infer` on
           a 12 s transcript (4 gru_sequence launches a window) and
           `c2g-samples` over 32 clusters x 4 samples (1 chunk-decoder
           launch at B=128, 19 steps; 2 gru_sequence for pre_gru), each
           card against --device cpu within 1e-4; one torch.profiler trace
           (utils/profiling.trace) of a 6 s decode request, which must
           name the chunk-decoder kernel (launched through ctypes) and
           the annotated stage; `unityfy` and `human-study` on the host
           over the phase's own 2-file corpus;
  mfu      the train path's steps/s of a, b_gssoft, d_tcn, d_gru and
           d_recipe as model FLOPs utilization: 3x the analytic forward a
           step (utils/flops), against the card's bf16 tensor-core and
           fp32 CUDA-core peaks;
  timing   the StageTimer's report;
  check    every launch count as derived, every kernel shape compared in
           an earlier phase;
then the kernels line (each kernel's launches on its first path, on the
later paths and its times at the new shapes), the nvidia-smi line, and as
the last line {"ok": true, "device": {...}}. Any failed phase exits non-zero; without
a CUDA device, or without the package beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from gesture2vec_tpu_torch.utils.flops import (H100_PEAK_BF16,
                                               H100_PEAK_BYTES_S,
                                               H100_PEAK_FP32)

# kernel vs plain and fused vs module rollout: fp32 sums in another
# order, carried through 20 recurrent steps
TOL = 1e-4
HID, L, K, REP, DIM = 200, 2, 512, 40, 135
N_FRAMES, SENT_LEN, FPS, N_WORDS, MAXW, WORDEMBED = 20, 120, 20, 5000, 48, 300
VOCAB_WORDS = 300
REQUESTS_S = (6.0, 60.0, 1800.0)
# the cli path's corpus: 4 Trinity-layout files of 60 s at 60 fps
CLI_CORPUS = (4, 3600)
# every chunk batch the paths send: a continuity chunk (1); 6 s, 60 s,
# three 60 s transcripts in one g2v-infer call, ragged, 1800 s; the serve
# path's stream-step buckets 2-16 (12-96) and fused /generate buckets 2-32
# of 60 s requests (192-3072); the audio path's unbucketed 60 s and 1800 s
# requests (60, 1800)
KERNEL_BATCHES = (1, 6, 12, 24, 48, 60, 96, 192, 288, 293, 384, 768, 1536,
                  1800, 1824, 3072)
# chunk-decoder batches at the edges of its tiles: a single row, one
# round of 1-row tiles (the card holds 7 clusters), 2-row tiles, several
# rounds of 8-row tiles, and every batch the paths send
DECODER_EDGE_BATCHES = tuple(sorted({7, 8, 9, 128, *KERNEL_BATCHES}))
# the training path's Part-b validation: batches of 128 rolled out from
# the seed frame over n_poses - 1 steps (held against the plain version
# beside KERNEL_BATCHES, which run N_FRAMES steps)
TRAIN_VAL_DECODE = (128, N_FRAMES - 1)
DECODER_SHAPES = tuple((B, N_FRAMES) for B in KERNEL_BATCHES) + (
    TRAIN_VAL_DECODE,)
# published H100 SXM peaks (utils/flops): fp32 outside the tensor cores,
# HBM3; bf16 on the tensor cores (dense), the card's rate for bf16
# operands
PEAK_FP32_FLOPS, PEAK_BYTES_S = H100_PEAK_FP32, H100_PEAK_BYTES_S
PEAK_BF16_FLOPS = H100_PEAK_BF16

# Part c: the Trinity Speech-Gesture corpus as GENEA 2020 used it, 244
# minutes at 20 fps, as 24 clips; 2 more clips validate
PC_CLIPS, PC_FRAMES, PC_VAL_CLIPS, PC_KMEANS = 24, 12200, 2, 300
GRU_T, GRU_BATCHES = 20, (300, 512)
# batches that fill one row of a 20-row cluster, part of one, and many
GRU_EDGE_BATCHES = (1, 17, 300, 512)
# the training path: 4 clips of 13,000 frames (43 minutes at 20 fps), which
# give Part d 2,580 sentence windows (20 full batches of 128; the recipe's
# stride 1,720), and one 4,500-frame validation clip (a full validation
# batch at the recipe's stride)
TRAIN_CLIPS, TRAIN_FRAMES, TRAIN_VAL_FRAMES = 4, 13000, 4500
# the audio Part d's stores hold the first 2 train clips (1,290 sentence
# windows, 10 full batches) and the validation clip: its data step runs
# one STFT a second of speech on the host, which took ~45 s for all 4
# clips on a slow host (PERF.md section 5)
TRAIN_AUDIO_CLIPS = 2
# (run, part, shipped config, what is cut or set beside the paths): the
# epochs cut to 1 (Part a: 406 steps) or, for the residual VQ, 2 with the
# re-fit every epoch so its K-Means runs once; Part a's VQ frame model
# over 2 epochs (its EMA codebook starts from ema_w ~ N(0, 1) over a zero
# cluster size, so the first epoch's loss climbs before it falls), its
# VAE, and both with the vq_tricks loop over 2 epochs (the first the
# delayed-VQ warmup, the K-Means re-fit before the second); the two text
# encoders; the residual-VQ tokenizer with the transformer chunk encoder;
# the VAE tokenizer over 2 epochs (its loss falls slowly over the VQ
# frame model's wider latents), the plain and the similarity-supervised
# tokenizers over every other window (stride 10); the recommended
# recipe's Part d over 2 epochs, the second on the feedback-matched
# finetune step
TRAIN_RUNS = (
    ("a", "a", "DAE.yml", {"epochs": 1}),
    ("a_vq", "a", "DAE.yml", {"epochs": 2, "autoencoder_vq": True}),
    ("a_vae", "a", "DAE.yml", {"epochs": 1, "autoencoder_vae": True}),
    ("a_vqvae_tricks", "a", "DAE.yml", {"epochs": 2, "autoencoder_vq": True,
                                        "autoencoder_vae": True}),
    ("b_gssoft", "b", "VQ-VAE.yml", {"epochs": 1}),
    ("b_rvq", "b", "VQ-VAE_rvq.yml", {"epochs": 2,
                                      "rvq_reestimate_every": 1}),
    ("b_tf", "b", "VQ-VAE_rvq.yml", {"epochs": 1,
                                     "seq_arch": "transformer"}),
    ("b_vae", "b", "VQ-VAE.yml", {"epochs": 2, "autoencoder_vae": True}),
    ("b_plain", "b", "VQ-VAE.yml", {"epochs": 1, "autoencoder_vq": False,
                                    "subdivision_stride": 10}),
    ("b_ssl", "b", "VQ-VAE.yml", {"epochs": 1, "use_similarity": True,
                                  "loss_label_weight": 0.1,
                                  "subdivision_stride": 10}),
    ("d_tcn", "d", "seq2seqtxt.yml", {"epochs": 1, "text_encoder": "tcn"}),
    ("d_gru", "d", "seq2seqtxt.yml", {"epochs": 1, "text_encoder": "gru"}),
    ("d_recipe", "d", "seq2seqtxt_recommended.yml",
     {"epochs": 2, "feedback_finetune_epochs": 1}),
    ("d_audio", "audio", "audio.yml", {"epochs": 1}))
# the runs that call the trainer itself (the command has no vq_tricks
# flag) with these arguments
TRAIN_TRICKS = {"a_vqvae_tricks": {"vq_tricks": True, "vq_start_epoch": 1,
                                   "vq_reestimate_every": 1}}
# each Part-b or Part-d run's frozen Part-a model (--rep-checkpoint):
# a_vq's VQFrame for the VAE tokenizer, else the DAE
TRAIN_REPS = {"b_vae": "a_vq"}
# each Part-d run's tokenizer (--autoencoder-checkpoint): the recipe's
# 4 stages need the 4-stage residual VQ
TRAIN_TEACHERS = {"d_tcn": "b_gssoft", "d_gru": "b_gssoft",
                  "d_recipe": "b_rvq", "d_audio": "b_gssoft"}
# the generators the train path builds from its checkpoints: (name, Part
# d, Part a, Part b); each Part-d run over its tokenizer, and d_tcn's
# Part d over a VQFrame DAE and the VAE tokenizer
TRAIN_GENERATORS = tuple((run, run, "a", tok)
                         for run, tok in TRAIN_TEACHERS.items()
                         if run != "d_audio") + (
    ("d_tcn_a_vq_b_vae", "d_tcn", "a_vq", "b_vae"),)
# the similarity labels b_ssl writes in the reference's format
# (annotator,left,middle,right,label,time): lines over its windows
SSL_LABEL_LINES = 400
# steps timed for steps/s, and steps under torch.profiler for the idle
# share, per part
TRAIN_TIMED_STEPS = {"a": 200, "b": 10, "d": 10, "audio": 10,
                     "baseline": 10, "c2g": 10, "gan": 3}
TRAIN_PROFILED_STEPS = {"a": 50, "b": 1, "d": 3, "audio": 3,
                        "baseline": 2, "c2g": 3, "gan": 1}
# kernel launches a train step (the others 0): the BiGRUs' 2 layers x 2
# directions forward and backward, the 4 residual stages' argmins
TRAIN_STEP_LAUNCHES = {
    "a": {}, "a_vq": {"vq_argmin": 1}, "a_vae": {},
    "a_vqvae_tricks": {"vq_argmin": 1}, "a_vqvae_tricks_warmup": {},
    "b_gssoft": {"gru_sequence": 4, "gru_sequence_backward": 4},
    "b_vae": {"gru_sequence": 4, "gru_sequence_backward": 4},
    "b_plain": {"gru_sequence": 4, "gru_sequence_backward": 4},
    # the main batch and the two pair forwards, each through the BiGRU
    "b_ssl": {"gru_sequence": 12, "gru_sequence_backward": 12},
    "b_rvq": {"gru_sequence": 4, "gru_sequence_backward": 4,
              "vq_argmin": 4},
    "b_tf": {"vq_argmin": 4},
    "d_tcn": {}, "d_gru": {"gru_sequence": 4, "gru_sequence_backward": 4},
    "d_recipe": {}, "d_recipe_feedback": {},
    # the audio encoder's BiGRU
    "d_audio": {"gru_sequence": 4, "gru_sequence_backward": 4}}
# the GRU backward's (T, B): the tokenizer's steps at the training batch
# (128) and at 512, the text encoder's word window, a ragged batch, the
# similarity step's pair forwards (3 windows), and the audio encoder's 6
# one-second steps
GRU_BWD_SHAPES = ((20, 128), (20, 512), (48, 128), (20, 117), (20, 3),
                  (6, 128))
# compute_dtype: bfloat16 (the bf16 instantiations of the GRU-sequence,
# GRU-backward and chunk-decoder kernels): the kernel rows' (T, B), the
# tokenizer's BiGRU, the GRU text encoder's word window and the audio
# encoder's 6 seconds at the training batch (and TRAIN_VAL_DECODE for the
# chunk decoder); bf16 kernel vs bf16 plain version: the tests' bf16
# tolerance (2^-6 of the largest magnitude;
# tests/test_torch_port_train_bf16.py)
BF16_GRU_SHAPES = ((N_FRAMES, 128), (MAXW, 128), (6, 128))
BF16_TOL = 2.0 ** -6
# the card's bf16 train step against the CPU's (bf16_card_vs_cpu), on
# each of the first BF16_CARD_BATCHES batches: the loss (relative), each
# gradient (relative to its norm) and the median of those over the
# tensors. Set from a first run's readings at these widths (NVIDIA H100
# 80GB HBM3, 700.00 W; ten steps): losses within 6.0e-5, the worst
# tensor 0.116 (bf16 roundings that flip between the two devices move a
# step's gradients nearly as far as bf16 moves them from fp32: 0.04 to
# 0.18 on the same tensors), the median 0.032
BF16_CARD_LOSS_TOL, BF16_CARD_TOL, BF16_CARD_MEDIAN_TOL = (
    2.0 ** -10, 2.0 ** -2, 2.0 ** -4)
BF16_CARD_BATCHES = 2
# the bf16 runs: (run, part, shipped config, cuts, the fp32 run of
# TRAIN_RUNS read beside it, whose Part-a checkpoint and tokenizer it uses)
TRAIN_BF16_RUNS = (
    ("b_gssoft_bf16", "b", "VQ-VAE.yml", {"epochs": 1}, "b_gssoft"),
    ("d_gru_bf16", "d", "seq2seqtxt.yml",
     {"epochs": 1, "text_encoder": "gru"}, "d_gru"),
    ("d_recipe_bf16", "d", "seq2seqtxt_recommended.yml",
     {"epochs": 2, "feedback_finetune_epochs": 1}, "d_recipe"),
    ("d_audio_bf16", "audio", "audio.yml", {"epochs": 1}, "d_audio"))
# the bf16 instantiations' launches a train step and a validation batch
# (every other count, each fp32 kernel's included, 0): the BiGRU's 2
# layers x 2 directions, the Part-b validation's chunk decode; the
# recipe's transformer none
_BIGRU_BF16 = ({"gru_sequence_gates_bf16": 4,
                "gru_sequence_backward_bf16": 4}, {"gru_sequence_bf16": 4})
BF16_LAUNCHES = {"b_gssoft_bf16": (_BIGRU_BF16[0], {**_BIGRU_BF16[1],
                                                    "chunk_decoder_bf16": 1}),
                 "d_gru_bf16": _BIGRU_BF16, "d_audio_bf16": _BIGRU_BF16,
                 "d_recipe_bf16": ({}, {})}
# the residual VQ's K-Means re-fit in the training path: 10 full batches
# of 512 of its 5,196 windows
TRAIN_REFIT_ROWS = 5120
# (N, K) at D=400: a training batch's residual stages, the recipe's
# Part-d teacher sweep (512 chunks a batch), the re-fit, the Part-c shapes
VQ_D, VQ_SHAPES = 400, ((128, 512), (300, 300), (512, 512),
                        (TRAIN_REFIT_ROWS, 512), (58488, 300),
                        (1 << 20, 512))
# (N, K) at D=40, the Part-a VQFrame's (configs/DAE.yml: 80 codes): a
# train step or validation batch, and vq_tricks' K-Means re-fit over
# every training frame
FRAME_CODES = 80
VQ_FRAME_D, VQ_FRAME_SHAPES = REP, ((128, FRAME_CODES),
                                    (TRAIN_CLIPS * TRAIN_FRAMES,
                                     FRAME_CODES))
# near-ties: kernel and plain may pick different codes only where the
# plain distances of the two differ by at most NEAR_TIE (GS-Soft: where
# the plain log-assignments differ by at most GSSOFT_TIE); dmin and the
# VQ distances carry fp32 sums over 400 terms in another order
NEAR_TIE, GSSOFT_TIE, DMIN_TOL = 1e-3, 1e-4, 1e-3
# card against CPU on a train step: a ReLU's or an |x|'s input on the
# other side of 0 on the card (a kink of the subgradient) moves the
# gradients by that element's share. Such an input may flip only where
# its CPU value lies within KINK_TIE of the largest magnitude of its
# call; the CPU step is then run again on the card's sides of 0
KINK_TIE = 1e-5
CPU_WINDOWS = 2048
# card against CPU and kernel against module path on the decode policies:
# a token may differ only where the reference's two best decision scores
# (logits, logits / temperature + noise, or beam scores) lie within this
LOGIT_TIE = 1e-4
# the Part-d checkpoint the exemplar path writes (the decode path's widths,
# TCN encoder), as the JAX trainer saves its config
T2T_ARGS = {"name": "seq2seqtxt", "model": "seq2seq", "hidden_size": HID,
            "n_layers": L, "sentence_frame_length": SENT_LEN,
            "n_poses": N_FRAMES, "n_pre_poses": 2, "autoencoder_att": True,
            "autoencoder_vq": True, "autoencoder_vq_components": K,
            "wordembed_dim": WORDEMBED, "motion_resampling_framerate": FPS,
            "token_stages": 1, "stage_conditional": False,
            "text_context_s": 0.0, "extras": {"text_encoder": "tcn"}}
# (name, model variant of policy_trees, GestureGenerator options)
POLICIES = (
    ("sampled_t1_top_k0", "tcn", {"temperature": 1.0, "top_k": 0}),
    ("sampled_t1_top_k50", "tcn", {"temperature": 1.0, "top_k": 50}),
    ("stage0_greedy_t1_4stage", "stage4",
     {"temperature": 1.0, "stage0_temperature": 0.0}),
    ("beam4", "tcn", {"beam_width": 4}),
    ("soft1", "tcn", {"soft_decode": 1.0}),
    ("overlap4", "tcn", {"decode_overlap": 4}),
    ("chunk_continuity", "tcn", {"chunk_continuity": True}),
    ("stage_conditional_4stage", "stage4_cond", {}),
    ("gru_encoder", "gru", {}))
# 60 s only since the audio path came in: the 1800 s batches stay in the
# kernel phases (policy_kernel_rows), held against the plain versions
POLICY_REQUESTS_S = (60.0,)
# the checkpoints' configs, as the JAX trainer saves them (the fields of
# configs/DAE.yml, configs/VQ-VAE.yml and configs/VQ-VAE_rvq.yml that
# the loaders read)
DAE_ARGS = {"name": "Frame_Level", "model": "DAE", "hidden_size": REP,
            "n_layers": 2, "input_motion_dim": DIM, "autoencoder_vq": False,
            "autoencoder_vae": False, "n_poses": 20, "subdivision_stride": 5,
            "extras": {}}
VQ_ARGS = {"name": "VQVAE", "model": "seq2seq", "hidden_size": HID,
           "n_layers": L, "input_motion_dim": DIM, "rep_learning_dim": REP,
           "autoencoder_att": False, "autoencoder_conditioned": True,
           "autoencoder_vae": False, "autoencoder_vq": True,
           "autoencoder_vq_components": K,
           "autoencoder_vq_commitment_cost": 0.25, "use_derivative": False,
           "autoencoder_vq_variant": "gssoft", "rvq_stages": 2,
           "n_poses": 20, "n_pre_poses": 1, "subdivision_stride": 5,
           "extras": {}}
RVQ_ARGS = {**VQ_ARGS, "name": "VQVAE_rvq", "autoencoder_vq_variant": "rvq",
            "rvq_stages": 4, "subdivision_stride": 10}
# the recommended recipe (configs/seq2seqtxt_recommended.yml over
# configs/VQ-VAE_rvq.yml): the transformer Part d with t2t_heads 4, 4
# chained stages and a 1-token teacher prefix, under three policies
RECIPE_HEADS, RECIPE_N_PRE = 4, 1
RECIPE_POLICIES = (
    ("greedy", {}),
    ("recipe_t0_stage0_t1", {"temperature": 0.0, "stage0_temperature": 1.0}),
    ("beam4", {"beam_width": 4}))
# the exemplar request's policy: the recipe's
RECIPE_POLICY = dict(RECIPE_POLICIES)["recipe_t0_stage0_t1"]
# the recipe's requests: 60 s only since the audio path came in
RECIPE_REQUESTS_S = (60.0,)
# the serve path: 60 s requests; /generate from 8 sequential clients, then
# 16 and 32 at once (fused up to 32); one 6 s BVH answer; /stream from
# (sessions, stream_batch); the served command's start-up limit
SERVE_REQUEST_S, SERVE_BVH_S, SERVE_MAX_BATCH = 60.0, 6.0, 32
SERVE_SEQUENTIAL, SERVE_CLIENTS = 8, (16, 32)
SERVE_STREAMS = ((1, 1), (16, 1), (64, 1), (16, 16), (64, 16))
# the GRU text encoder's Part d on the serve path: /stream sessions
# through the batcher, concurrent /generate requests
SERVE_GRU_STREAMS, SERVE_GRU_CLIENTS = 8, 4
# the GRU sequence's batches at T=48 (the text encoder's word window):
# a window a step, the serve path's stream buckets 2-8 and fused 60 s
# /generate buckets of 16 windows a request (16-64), and the policies'
# 1800 s request (303 windows, 304 in the bucket)
GRU_T48_BATCHES = (1, 2, 4, 8, 16, 32, 64, 303, 304)
SERVE_CLI_START_S = 120.0
# the audio path (configs/audio.yml: hidden 200, 2 layers, 512 codes,
# n_pre_poses 2, attention; 120-frame windows at 20 fps of 6 one-second
# mel chunks): decode requests of 6 s, 60 s and 1800 s (1, 10 and 300
# windows: chunk batches 6, 60, 1800, no bucketing, as in JAX); at 60 s
# the policies, exemplar mode and 8 streams
AUDIO_SR = 16000
AUDIO_REQUESTS_S = (6.0, 60.0, 1800.0)
AUDIO_POLICY_S = 60.0
AUDIO_POLICIES = (
    ("sampled_t1_top_k50", "audio", {"temperature": 1.0, "top_k": 50}),
    ("beam4", "audio", {"beam_width": 4}),
    ("soft1", "audio", {"soft_decode": 1.0}),
    ("overlap4", "audio", {"decode_overlap": 4}),
    ("fusion_both", "both", {}))
AUDIO_STREAMS = 8
# the GRU sequence's (T, B) there: T = 6 (a second a step) at B = 1 (a
# window: 6 s requests, streams), 10 (60 s), 128 (a training batch), 300
# (1800 s); T = 48, the fusion encoder's word window, at B = 10
AUDIO_GRU_SHAPES = ((6, 1), (6, 10), (6, 128), (6, 300), (48, 10))
# the chunk decoder's (B, steps): 60 s and 1800 s, and 60 s with
# decode_overlap 4
AUDIO_DECODER_SHAPES = ((60, N_FRAMES), (1800, N_FRAMES), (60, N_FRAMES + 4))
# the audio Part d's checkpoint config, as the JAX trainer saves it
# the analysis path: the silhouette sweep's rows and cluster counts, the
# cluster CLI's K over the validation store; what it leaves to the CPU
# tests, and why
ANALYSIS_SWEEP_ROWS, ANALYSIS_K_RANGE, ANALYSIS_KMEANS = 2000, range(2, 12), 8
ANALYSIS_NOT_DRIVEN = (
    "host code, held against the JAX package by the CPU tests "
    "(tests/test_torch_port_analysis.py): cluster/plots (t-SNE, the "
    "codebook and latent plots, the attention heatmap), --plots, "
    "--plot-kernels, --plot-every and g2v-train's loss_curves.png "
    "(matplotlib and scikit-learn), --algo dbscan|agglomerative "
    "(scikit-learn), --algo mapdp (numpy / scipy: a d x d Cholesky a "
    "point and cluster each sweep, which at D=400 does not fit the time "
    "limit)")
AUDIO_ARGS = {"name": "audio2token", "model": "seq2seq", "hidden_size": HID,
              "n_layers": L, "sentence_frame_length": SENT_LEN,
              "n_poses": N_FRAMES, "n_pre_poses": 2, "autoencoder_att": True,
              "autoencoder_vq": True, "autoencoder_vq_components": K,
              "wordembed_dim": WORDEMBED, "motion_resampling_framerate": FPS,
              "token_stages": 1, "stage_conditional": False,
              "audio_fusion": "audio", "dropout_prob": 0.2,
              "batch_size": 128, "extras": {}}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since the
    script started ("t_s"), so a run shows where its time limit went."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def words(duration_s: float, seed: int = 0):
    """Synthetic transcript at ~150 words/min (the bench workload)."""
    rng = np.random.default_rng(seed)
    n = int(2.5 * duration_s)
    starts = np.linspace(0.1, duration_s - 0.5, n)
    return [[f"word{rng.integers(200)}", float(s), float(s + 0.3)]
            for s in starts]


def jax_layout_trees(rng: np.random.Generator):
    """Random bench-width variables in the JAX package's layout (numpy),
    so the weight bridge runs here too."""
    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, size=shape).astype(np.float32)

    def dense(i, o):
        return {"kernel": u((i, o), i), "bias": u((o,), i)}

    def gru(in_dim):
        out = {}
        for layer in range(L):
            d = in_dim if layer == 0 else HID
            out.update({f"l{layer}_w_ih": u((3 * HID, d), HID),
                        f"l{layer}_w_hh": u((3 * HID, HID), HID),
                        f"l{layer}_b_ih": u((3 * HID,), HID),
                        f"l{layer}_b_hh": u((3 * HID,), HID)})
        return out

    def bn():
        p = {"scale": (1 + 0.1 * rng.normal(size=HID)).astype(np.float32),
             "bias": (0.1 * rng.normal(size=HID)).astype(np.float32)}
        s = {"mean": (0.1 * rng.normal(size=HID)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, size=HID).astype(np.float32)}
        return p, s

    def conv(i, o):
        return {"Conv_0": {"kernel": rng.normal(0, 0.01, size=(2, i, o))
                           .astype(np.float32), "bias": u((o,), i)},
                "wn": {"Conv_0/kernel/scale":
                       (1 + 0.1 * rng.normal(size=o)).astype(np.float32)}}

    tcn = {}
    for b in range(L):
        i = WORDEMBED if b == 0 else HID
        tcn[f"block{b}"] = {"conv1": conv(i, HID), "conv2": conv(HID, HID)}
        if i != HID:
            tcn[f"block{b}"]["downsample"] = {
                "kernel": rng.normal(0, 0.01, size=(1, i, HID))
                .astype(np.float32), "bias": u((HID,), i)}
    t2t_bn, t2t_stats = bn()
    t2t = {"params": {
        "encoder": {"embedding_table": rng.normal(
            size=(N_WORDS, WORDEMBED)).astype(np.float32),
            "tcn": tcn, "decoder": dense(HID, HID),
            "hidden_proj": dense(HID, L * HID)},
        "decoder_step": {
            "token_embedding": {"embedding": rng.normal(
                size=(K, HID)).astype(np.float32)},
            "attn": {"attn": dense(2 * HID, HID), "v": u((HID,), HID)},
            "pre_linear": dense(2 * HID, HID), "pre_bn": t2t_bn,
            "gru": gru(HID), "out_layer": dense(HID, K)}},
        "batch_stats": {"decoder_step": {"pre_bn": t2t_stats}}}
    seq_bn, seq_stats = bn()
    seq = {"params": {
        "vq_layer": {"codebook": (0.5 * rng.normal(size=(K, L * HID)))
                     .astype(np.float32)},
        "decoder_step": {"pre_linear": dense(REP, HID), "pre_bn": seq_bn,
                         "gru": gru(HID), "out_layer": dense(HID, REP)}},
        "batch_stats": {"decoder_step": {"pre_bn": seq_stats}}}
    dae = {"params": {"encoder": dense(DIM, REP), "decoder": dense(REP, DIM)}}
    return t2t, seq, dae


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_busy(fn, wall_s: float) -> dict:
    """Kernel and copy time on the card during one call of fn
    (torch.profiler), against the unprofiled wall time of the same call.
    The profiler records the device's activity only: with the host's
    too, each operator's row in key_averages carries the device time of
    the kernels it launched beside the kernels' own rows, so a sum over
    the rows counted every kernel twice (and "device_ops" counted the
    launching operators too), and its post-processing took ~3x as
    long."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
    kernels = sum(e.count for e in rows
                  if getattr(e, "self_device_time_total", 0.0) > 0)
    return {"busy_s": busy_us / 1e6, "device_ops": kernels,
            "idle_share": 1.0 - busy_us / 1e6 / wall_s}


def chunk_decoder_bound_ms(B: int, D: int, H: int, T: int) -> dict:
    """Least time for the rollout: its operations at the fp32 peak vs its
    bytes (inputs and weights read once, outputs written once) at the
    memory rate."""
    flops = 2.0 * B * T * (D * H + 2 * 2 * H * 3 * H + H * D)
    weights = D * H + 2 * H + 2 * (2 * H * 3 * H + 2 * 3 * H) + H * D + D
    nbytes = 4.0 * (B * D + 2 * B * H + weights + T * B * D)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def best_s(fn, reps=3):
    """Best host time of reps synchronised calls."""
    import torch

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    return best


def launch_counters() -> dict:
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk
    from gesture2vec_tpu_torch.ops import vq_kernel as vk

    return {"chunk_decoder": dk.fused_chunk_decode,
            "gru_sequence": gk.gru_sequence,
            "gru_sequence_backward": gk.gru_sequence_backward,
            "vq_argmin": vk.vq_argmin}


def reset_launches() -> None:
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    for fn in (*launch_counters().values(), gk.gru_sequence_gates):
        fn.launches = fn.launches_bf16 = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def bf16_launches() -> dict:
    """The bf16 instantiations' launches: the GRU source's inference
    variant (its bf16 count less the gate-saving variant's), the
    gate-saving variant, the GRU backward, the chunk decoder."""
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    return {"gru_sequence_bf16": gk.gru_sequence.launches_bf16
            - gk.gru_sequence_gates.launches_bf16,
            "gru_sequence_gates_bf16": gk.gru_sequence_gates.launches_bf16,
            "gru_sequence_backward_bf16":
                gk.gru_sequence_backward.launches_bf16,
            "chunk_decoder_bf16": dk.fused_chunk_decode.launches_bf16}


def all_launches() -> dict:
    """Every counter: the fp32 kernels' (read_launches) and the bf16
    instantiations' (bf16_launches)."""
    return {**read_launches(), **bf16_launches()}


def bound(flops: float, nbytes: float) -> dict:
    """Least time for the work: operations at the fp32 peak against bytes
    (inputs read once, outputs written once) at the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def gru_bound_ms(T: int, B: int, H: int) -> dict:
    """The recurrent products 2*T*B*H*3H; x_proj, h0, w_hh, b_hh in,
    outputs and last hidden out."""
    return bound(2.0 * T * B * H * 3 * H,
                 4.0 * (T * B * 3 * H + B * H + 3 * H * H + 3 * H
                        + T * B * H + B * H))


def vq_bound_ms(N: int, K: int, D: int) -> dict:
    """The dot products 2*N*K*D; x, codebook in, int64 indices and fp32
    minima out."""
    return bound(2.0 * N * K * D, 4.0 * (N * D + K * D) + 12.0 * N)


def random_folded(H: int, D: int, g):
    """Random folded chunk-decoder weights on the card (torch layout),
    drawn uniformly in +-1/sqrt(H) as the decoder's layers initialise;
    BN scale near 1."""
    import torch

    from gesture2vec_tpu_torch.ops import decoder_kernel as dk

    def u(*shape):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1) \
            / H ** 0.5

    scale = 1 + 0.1 * torch.randn(H, device="cuda", generator=g)
    gru = [t for _ in range(2) for t in (u(3 * H, H), u(3 * H, H),
                                         u(3 * H), u(3 * H))]
    return dk.FoldedDecoder(u(H, D), scale, u(H), *gru, u(D, H), u(D))


def gru_launch(B: int, H: int) -> dict:
    """The GRU kernel's launch shape as the kernel reports it
    (g2v_gru_sequence_shape), held against the wrapper's mirror."""
    import ctypes

    from gesture2vec_tpu_torch.ops import gru_kernel as gk
    from gesture2vec_tpu_torch.ops.build import load

    fn = load("gru_sequence").g2v_gru_sequence_shape
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_longlong * 6)()
    rc = fn(B, H, out)
    got = dict(zip(("rows", "cluster", "threads", "smem_bytes", "clusters",
                    "max_active_clusters"), list(out)))
    want = gk.launch_shape(B, H, max_clusters=max(got["max_active_clusters"],
                                                  1))
    if rc or any(want[k] != got[k] for k in got if k in want):
        raise AssertionError(f"GRU launch shape: kernel {got} (rc {rc}), "
                             f"wrapper {want}")
    return {**want, "max_active_clusters": got["max_active_clusters"]}


def decoder_launch(B: int, H: int, D: int) -> dict:
    """The chunk decoder's launch shape as the kernel reports it
    (g2v_chunk_decode_shape), held against the wrapper's mirror."""
    import ctypes

    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops.build import load

    fn = load("chunk_decoder").g2v_chunk_decode_shape
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 7)()
    rc = fn(B, H, D, out)
    got = dict(zip(("rows", "cluster", "threads", "smem_bytes", "tiles",
                    "clusters", "max_active_clusters"), list(out)))
    want = dk.launch_shape(B, H, D, max_clusters=max(
        got["max_active_clusters"], 1))
    if rc or got["max_active_clusters"] < 1 or any(
            want[k] != got[k] for k in got if k in want):
        raise AssertionError(f"chunk decoder launch shape: kernel {got} "
                             f"(rc {rc}), wrapper {want}")
    return {**want, "max_active_clusters": got["max_active_clusters"]}


def vq_launch(N: int, D: int) -> dict:
    """The VQ kernel's launch shape for the block height the wrapper
    picks, as the kernel reports it (g2v_vq_argmin_shape), with the
    blocks an SM holds at once and the waves that makes."""
    import ctypes

    import torch

    from gesture2vec_tpu_torch.ops import vq_kernel as vk
    from gesture2vec_tpu_torch.ops.build import load

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    want = vk.launch_shape(N, D, n_sm)
    fn = load("vq_argmin").g2v_vq_argmin_shape
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 4)()
    rc = fn(N, D, want["block_rows"], out)
    got = dict(zip(("threads", "smem_bytes", "blocks", "blocks_per_sm"),
                   list(out)))
    if rc or any(want[k] != got[k] for k in ("threads", "smem_bytes",
                                              "blocks")):
        raise AssertionError(f"VQ launch shape: kernel {got} (rc {rc}), "
                             f"wrapper {want}")
    return {**want, "blocks_per_sm": got["blocks_per_sm"], "sms": n_sm,
            "waves": got["blocks"] / (n_sm * max(got["blocks_per_sm"], 1))}


# -- the decode path ----------------------------------------------------
def decode_path(smi: str) -> dict:
    import torch

    from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.text.vocab import Vocab

    # -- the bench-width generator (weights through the bridge) ---------
    vocab = Vocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    trees = jax_layout_trees(np.random.default_rng(0))
    pose_mean = np.zeros(DIM, np.float32)
    pose_std = np.ones(DIM, np.float32)

    def make(device, fused):
        return generator_from_jax(
            *trees, vocab, pose_mean, pose_std, n_frames=N_FRAMES,
            sentence_frame_length=SENT_LEN, fps=FPS, max_words=MAXW,
            device=device, mode="decode", use_fused_decoder=fused)

    gen = make("cuda", True)
    folded = gen._folded

    # -- kernel vs plain ----------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(0)
    kernel_rows = {}
    for B, n in DECODER_SHAPES:
        x0 = torch.randn(B, REP, device="cuda", generator=g)
        h0 = torch.randn(2, B, HID, device="cuda", generator=g)
        ys = dk.fused_chunk_decode(x0, h0, folded, n)
        ref = dk.fused_chunk_decode_plain(x0, h0, folded, n)
        torch.cuda.synchronize()
        err = (ys - ref).abs().max().item()
        ms = cuda_ms(lambda: dk.fused_chunk_decode(x0, h0, folded, n), 20)
        plain_ms = cuda_ms(lambda: dk.fused_chunk_decode_plain(
            x0, h0, folded, n), 10)
        # twice the steps: the difference is n steps without the
        # weights' staging and the launch
        ms_2n = cuda_ms(lambda: dk.fused_chunk_decode(x0, h0, folded,
                                                      2 * n), 20)
        row = {"phase": "kernel", "kernel": "chunk_decoder", "B": B,
               "H": HID, "D": REP, "n_steps": n,
               "launch": decoder_launch(B, HID, REP),
               "max_abs_err": err, "tol": TOL, "ms": ms,
               "ms_twice_the_steps": ms_2n,
               "us_per_step": (ms_2n - ms) / n * 1e3,
               "plain_ms": plain_ms,
               **chunk_decoder_bound_ms(B, REP, HID, n)}
        emit(row)
        kernel_rows[B, n] = row
        if not np.isfinite(err) or err > TOL:
            raise AssertionError(f"chunk_decoder B={B}, {n} steps: max "
                                 f"abs error {err} > {TOL}")

    # -- main path ----------------------------------------------------
    reset_launches()
    outs, per_request = {}, []
    for d in REQUESTS_S:
        outs[d] = gen.generate(words(d), d)
        per_request.append(dk.fused_chunk_decode.launches)
    counts = read_launches()
    launches = counts["chunk_decoder"]
    emit({"phase": "main", "path": "decode", "requests_s": list(REQUESTS_S),
          "launches": counts, "launches_after_each_request": per_request})
    if per_request != list(range(1, len(REQUESTS_S) + 1)):
        raise AssertionError(f"chunk_decoder launches after each request: "
                             f"{per_request}, want one per request")

    # -- check --------------------------------------------------------
    unit = SENT_LEN / FPS
    plain_gen = make("cuda", False)
    worst = 0.0
    for d, (frames, toks) in outs.items():
        n_windows = int(np.ceil(d / unit))
        if frames.shape != (n_windows * SENT_LEN, DIM):
            raise AssertionError(f"{d} s: frames {frames.shape}")
        if not np.isfinite(frames).all():
            raise AssertionError(f"{d} s: non-finite frames")
        frames_p, toks_p = plain_gen.generate(words(d), d)
        if not np.array_equal(toks, toks_p):
            raise AssertionError(f"{d} s: tokens differ from the rollout")
        err = float(np.abs(frames - frames_p).max())
        worst = max(worst, err)
        if err > TOL:
            raise AssertionError(f"{d} s: frames differ from the module "
                                 f"rollout by {err}")
    cpu_frames, cpu_toks = make("cpu", True).generate(words(6.0), 6.0)
    cpu_err = float(np.abs(outs[6.0][0] - cpu_frames).max())
    if not np.array_equal(outs[6.0][1], cpu_toks) or cpu_err > TOL:
        raise AssertionError(f"6 s: card vs CPU path: tokens equal "
                             f"{np.array_equal(outs[6.0][1], cpu_toks)}, "
                             f"frames {cpu_err}")
    emit({"phase": "check", "fused_vs_rollout_max_abs_err": worst,
          "card_vs_cpu_6s_max_abs_err": cpu_err, "tol": TOL,
          "tokens_identical": True,
          "distinct_tokens_1800s": int(len(np.unique(outs[1800.0][1])))})

    # -- timing -------------------------------------------------------
    for d in REQUESTS_S:
        w = words(d)
        n_frames = outs[d][0].shape[0]
        fused_s = best_s(lambda: gen.generate(w, d))
        plain_s = best_s(lambda: plain_gen.generate(w, d))
        emit({"phase": "timing", "request_s": d, "frames": n_frames,
              "fused_s": fused_s, "fused_frames_per_s": n_frames / fused_s,
              "rollout_s": plain_s,
              "rollout_frames_per_s": n_frames / plain_s,
              "stages_s": stage_split(gen, d, reps=3),
              "device_busy": device_busy(lambda: gen.generate(w, d),
                                         fused_s),
              "card": smi})

    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    k = kernel_rows[KERNEL_BATCHES[-1], N_FRAMES]
    by_batch = {B: {key: kernel_rows[B, N_FRAMES][key] for key in keys}
                for B in (6, 288, 1824, 3072)}
    return {"name": "chunk_decoder", "route": "cuda",
            "source": "gesture2vec_tpu_torch/csrc/chunk_decoder.cu",
            "replaces": "gesture2vec_tpu/ops/decoder_pallas.py:144",
            "launches": launches, "max_abs_err": max(
                r["max_abs_err"] for r in kernel_rows.values()),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "B": k["B"], "by_batch": by_batch,
            "train_validation": {"B": TRAIN_VAL_DECODE[0],
                                 "n_steps": TRAIN_VAL_DECODE[1], **{
                key: kernel_rows[TRAIN_VAL_DECODE][key] for key in keys}},
            "launch": k["launch"]}


# -- Part c: corpus tokenizer sweep and K-Means -------------------------
def part_c_trees(rng: np.random.Generator):
    """Random variables in the JAX package's layout: the Part-a DAE, a
    GS-Soft tokenizer and a 4-stage residual-VQ tokenizer (numpy)."""
    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, size=shape).astype(np.float32)

    def dense(i, o):
        return {"kernel": u((i, o), i), "bias": u((o,), i)}

    def bigru():
        out = {}
        for layer in range(L):
            d = HID if layer == 0 else 2 * HID
            for sfx in ("", "_reverse"):
                out.update({f"l{layer}_w_ih{sfx}": u((3 * HID, d), HID),
                            f"l{layer}_w_hh{sfx}": u((3 * HID, HID), HID),
                            f"l{layer}_b_ih{sfx}": u((3 * HID,), HID),
                            f"l{layer}_b_hh{sfx}": u((3 * HID,), HID)})
        return out

    def seq(vq_layer):
        gru = {}
        for layer in range(L):
            gru.update({f"l{layer}_w_ih": u((3 * HID, HID), HID),
                        f"l{layer}_w_hh": u((3 * HID, HID), HID),
                        f"l{layer}_b_ih": u((3 * HID,), HID),
                        f"l{layer}_b_hh": u((3 * HID,), HID)})
        params = {"encoder": {"in_layer": dense(REP, HID), "gru": bigru()},
                  "vq_layer": vq_layer,
                  "decoder_step": {
                      "pre_linear": dense(REP, HID),
                      "pre_bn": {"scale": np.ones(HID, np.float32),
                                 "bias": np.zeros(HID, np.float32)},
                      "gru": gru, "out_layer": dense(HID, REP)}}
        stats = {"decoder_step": {"pre_bn": {
            "mean": np.zeros(HID, np.float32),
            "var": np.ones(HID, np.float32)}}}
        return params, stats

    D = L * HID
    dae = {"encoder": dense(DIM, REP), "decoder": dense(REP, DIM)}
    gssoft = seq({"codebook": rng.normal(size=(K, D)).astype(np.float32),
                  "mean_layer": dense(D, D), "logvar_layer": dense(D, K)})
    # residual codebooks at the scale of the tanh-bounded hidden, so the
    # hard argmin does not pick the shortest code every time
    rvq = seq({("codebook" if s == 0 else f"codebook_r{s}"):
               (0.1 * rng.normal(size=(K, D))).astype(np.float32)
               for s in range(RVQ_ARGS["rvq_stages"])})
    return dae, gssoft, rvq


def write_checkpoint(path: str, args: dict, params, stats, kind: str,
                     pose_dim: int, lang_model=None, **extra) -> None:
    """A checkpoint file as the JAX package's save_checkpoint writes it
    (a flax msgpack tree), through the port's own codec."""
    from gesture2vec_tpu_torch.utils import mpack

    if stats:
        extra = {"batch_stats": stats, "parity": False, **extra}
    payload = {"args": args, "epoch": 1, "pose_dim": pose_dim,
               "lang_model": lang_model, "kind": kind, "params": params,
               "extra": extra}
    with open(path, "wb") as f:
        f.write(mpack.packb(payload))


def write_corpus(root: str, rng: np.random.Generator):
    """The 244-minute train store and the 2-clip validation store."""
    from gesture2vec_tpu_torch.data.store import ClipStoreWriter

    paths = []
    for name, n_clips in (("train", PC_CLIPS), ("val", PC_VAL_CLIPS)):
        w = ClipStoreWriter(os.path.join(root, name))
        clips = [rng.normal(size=(PC_FRAMES, DIM)).astype(np.float32)
                 for _ in range(n_clips)]
        for i, poses in enumerate(clips):
            w.add_clip(f"{name}{i:02d}", poses)
        frames = np.concatenate(clips)
        w.set_stats(frames.mean(0), frames.std(0))
        w.finish()
        paths.append(w.root)
    return paths


def gru_kernel_rows(w_ih, w_hh, b_ih, b_hh) -> list:
    """The GRU-sequence kernel against its plain version and against one
    cuDNN GRU layer, at the sweep's shapes."""
    import torch

    from gesture2vec_tpu_torch.models.gru import gru_layer
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    g = torch.Generator(device="cuda").manual_seed(1)
    cudnn = torch.nn.GRU(HID, HID, 1).cuda()
    with torch.no_grad():
        for p, v in ((cudnn.weight_ih_l0, w_ih), (cudnn.weight_hh_l0, w_hh),
                     (cudnn.bias_ih_l0, b_ih), (cudnn.bias_hh_l0, b_hh)):
            p.copy_(v)
    rows = []
    with torch.inference_mode():
        for B in GRU_BATCHES:
            xs = torch.randn(GRU_T, B, HID, device="cuda", generator=g)
            h0 = 0.5 * torch.randn(B, HID, device="cuda", generator=g)
            x_proj = (xs.reshape(-1, HID) @ w_ih.t() + b_ih).reshape(
                GRU_T, B, -1)
            for reverse in (False, True):
                ys, h = gk.gru_sequence(x_proj, h0, w_hh, b_hh, reverse)
                ys_p, h_p = gk.gru_sequence_plain(x_proj, h0, w_hh, b_hh,
                                                  reverse)
                torch.cuda.synchronize()
                err = max((ys - ys_p).abs().max().item(),
                          (h - h_p).abs().max().item())
                row = {"phase": "kernel", "kernel": "gru_sequence", "B": B,
                       "T": GRU_T, "H": HID, "reverse": reverse,
                       "launch": gru_launch(B, HID),
                       "max_abs_err": err, "tol": TOL,
                       "ms": cuda_ms(lambda: gk.gru_sequence(
                           x_proj, h0, w_hh, b_hh, reverse), 20),
                       "plain_ms": cuda_ms(lambda: gk.gru_sequence_plain(
                           x_proj, h0, w_hh, b_hh, reverse), 10),
                       **gru_bound_ms(GRU_T, B, HID)}
                if not reverse:
                    # cuDNN computes the input product too: its yardstick
                    # is the matmul plus the kernel
                    y_c, h_c = cudnn(xs, h0[None])
                    y_k, h_k = gru_layer(xs, h0, w_ih, w_hh, b_ih, b_hh)
                    row.update({
                        "library_ms": cuda_ms(lambda: cudnn(xs, h0[None]),
                                              20),
                        "matmul_plus_kernel_ms": cuda_ms(
                            lambda: gru_layer(xs, h0, w_ih, w_hh, b_ih,
                                              b_hh), 20),
                        "cudnn_max_abs_err": max(
                            (y_c - y_k).abs().max().item(),
                            (h_c[0] - h_k).abs().max().item())})
                emit(row)
                rows.append(row)
                if not np.isfinite(err) or err > TOL:
                    raise AssertionError(f"gru_sequence B={B} reverse="
                                         f"{reverse}: max abs error {err}")
    return rows


def gru_backward_bound_ms(T: int, B: int, H: int) -> dict:
    """The backward's one product a step, dgh @ w_hh, 2*T*B*3H*H; the
    saved gates, h0, w_hh, ys, dys and dh_last in, d x_proj, dgh and d h0
    out."""
    return bound(2.0 * T * B * 3 * H * H,
                 4.0 * (T * B * 4 * H + 2 * B * H + 3 * H * H
                        + 2 * T * B * H + 2 * T * B * 3 * H + B * H))


def gru_backward_recompute_bound_ms(T: int, B: int, H: int) -> dict:
    """The bound of the backward that recomputes the gates from x_proj:
    the recomputed gh and dgh @ w_hh, 4*T*B*H*3H; x_proj, h0, w_hh, b_hh,
    ys, dys and dh_last in, d x_proj, dgh and d h0 out. Kept so that times
    of that design can be read against the bound they had."""
    return bound(4.0 * T * B * H * 3 * H,
                 4.0 * (3 * T * B * 3 * H + 2 * B * H + 3 * H * H + 3 * H
                        + 2 * T * B * H + B * H))


def gru_gates_bound_ms(T: int, B: int, H: int) -> dict:
    """The forward's training variant: `gru_bound_ms`'s work, with the
    gates (T, B, 4H) among the bytes written."""
    fwd = gru_bound_ms(T, B, H)
    return bound(fwd["flops"], fwd["bytes"] + 4.0 * T * B * 4 * H)


def rel_err(got, ref) -> float:
    """Largest difference relative to the reference's largest magnitude."""
    return (got - ref).abs().max().item() / max(ref.abs().max().item(),
                                                1e-30)


def gru_backward_rows(shapes=GRU_BWD_SHAPES) -> list:
    """The GRU-sequence training kernels at the training path's shapes
    (T=20 at B=128 and 512, T=48 at B=128, and a ragged B=117, H=200,
    both directions): the forward's training variant against the
    inference launch (outputs bitwise equal, times side by side) and its
    gates against the gates recomputed from its outputs; the backward
    kernel against its plain version on the same gates and the
    Function's gradients against autograd through the plain forward; and
    cuDNN's backward of one GRU layer with the same weights
    (torch.autograd.grad) and its forward + backward round trip as the
    yardsticks of the Function's. shapes: the (T, B) to run (the
    training path's by default)."""
    import torch

    from gesture2vec_tpu_torch.models.gru import gru_layer
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    g = torch.Generator(device="cuda").manual_seed(7)
    H = HID
    bnd = 1.0 / H ** 0.5
    w_ih, w_hh = ((torch.rand(3 * H, H, device="cuda", generator=g) * 2 - 1)
                  * bnd for _ in range(2))
    b_ih, b_hh = ((torch.rand(3 * H, device="cuda", generator=g) * 2 - 1)
                  * bnd for _ in range(2))
    cudnn = torch.nn.GRU(H, H, 1).cuda()
    with torch.no_grad():
        for p, v in ((cudnn.weight_ih_l0, w_ih), (cudnn.weight_hh_l0, w_hh),
                     (cudnn.bias_ih_l0, b_ih), (cudnn.bias_hh_l0, b_hh)):
            p.copy_(v)
    rows = []
    for T, B in shapes:
        xs = torch.randn(T, B, H, device="cuda", generator=g)
        h0 = 0.5 * torch.randn(B, H, device="cuda", generator=g)
        x_proj = (xs.reshape(-1, H) @ w_ih.t() + b_ih).reshape(T, B, -1)
        dys = torch.randn(T, B, H, device="cuda", generator=g)
        dhl = torch.randn(B, H, device="cuda", generator=g)
        for reverse in (False, True):
            fwd = (x_proj, h0, w_hh, b_hh, reverse)
            with torch.no_grad():
                ys_i, h_i = gk.gru_sequence(*fwd)
                ys, h_l, gates = gk.gru_sequence_gates(*fwd)
                gates_ref = gk.gates_from_ys(*fwd[:4], ys, reverse)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(ys, ys_i) and torch.equal(h_l, h_i))
            args = (gates, h0, w_hh, ys, dys, dhl, reverse)
            got = gk.gru_sequence_backward(*args)
            ref = gk.gru_sequence_backward_plain(*args)
            # the Function's gradients against autograd of the plain loop
            leaves = [t.clone().requires_grad_() for t in (x_proj, h0, w_hh,
                                                           b_hh)]
            ys_f, h_f = gk.GRUSequenceFn.apply(*leaves, reverse)
            fn_grads = torch.autograd.grad((ys_f, h_f), leaves, (dys, dhl))
            ys_p, h_p = gk.gru_sequence_plain(*leaves, reverse)
            auto = torch.autograd.grad((ys_p, h_p), leaves, (dys, dhl))
            torch.cuda.synchronize()
            # the Function's forward (the training variant) against the
            # plain recurrence, the saved gates, and the gradients
            errs = {"ys": rel_err(ys_f, ys_p), "h_last": rel_err(h_f, h_p),
                    "gates": rel_err(gates, gates_ref),
                    "dx_proj": rel_err(got[0], ref[0]),
                    "dgh": rel_err(got[1], ref[1]),
                    "dh0": rel_err(got[2], ref[2])}
            auto_errs = {n: rel_err(a, b) for n, a, b in zip(
                ("dx_proj", "dh0", "dw_hh", "db_hh"), fn_grads, auto)}
            # the two forwards in turns: inference, variant, variant,
            # inference
            with torch.no_grad():
                f_ms = [cuda_ms(lambda: fn(*fwd), 20) for fn in (
                    gk.gru_sequence, gk.gru_sequence_gates,
                    gk.gru_sequence_gates, gk.gru_sequence)]
            row = {"phase": "kernel", "kernel": "gru_sequence_backward",
                   "T": T, "B": B, "H": H, "reverse": reverse,
                   "launch": gru_backward_launch(B, H),
                   "ys_bitwise_equal_to_inference": bitwise,
                   "rel_err_vs_plain": errs,
                   "rel_err_vs_autograd": auto_errs,
                   "max_abs_err": max((a - b).abs().max().item()
                                      for a, b in zip(got, ref)),
                   "tol": TOL,
                   "forward_ms": (f_ms[0] + f_ms[3]) / 2,
                   "forward_gates_ms": (f_ms[1] + f_ms[2]) / 2,
                   "forward_ms_in_turns": f_ms,
                   "gates_max_abs_err": (gates - gates_ref).abs().max()
                   .item(),
                   "forward_gates_plain_ms": cuda_ms(
                       lambda: gk.gru_sequence_gates_plain(*fwd), 5),
                   "forward_bound_ms": gru_bound_ms(T, B, H)["bound_ms"],
                   "forward_gates_bound": gru_gates_bound_ms(T, B, H),
                   "ms": cuda_ms(lambda: gk.gru_sequence_backward(*args),
                                 20),
                   "plain_ms": cuda_ms(
                       lambda: gk.gru_sequence_backward_plain(*args), 5),
                   **gru_backward_bound_ms(T, B, H),
                   "recompute_bound_ms": gru_backward_recompute_bound_ms(
                       T, B, H)["bound_ms"]}
            if not reverse:
                # the Function's whole backward (kernel + dW_hh, db_hh)
                # and cuDNN's backward of one layer on the same weights
                ys_f, h_f = gk.GRUSequenceFn.apply(*leaves, reverse)
                row["function_backward_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(
                        (ys_f, h_f), leaves, (dys, dhl), retain_graph=True),
                    20)
                xs_l = xs.clone().requires_grad_()
                h0_l = h0[None].clone().requires_grad_()
                y_c, h_c = cudnn(xs_l, h0_l)
                params = [xs_l, h0_l, *cudnn.parameters()]
                row["library_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(
                        (y_c, h_c), params, (dys, dhl[None]),
                        retain_graph=True), 20)
                # forward + backward of one layer, input product included:
                # gru_layer (matmul, the training variant, the backward
                # kernel, dW_hh, db_hh, autograd of the matmul) against
                # cuDNN's
                layer = [t.clone().requires_grad_() for t in (
                    xs, h0, w_ih, w_hh, b_ih, b_hh)]

                def port_round():
                    out = gru_layer(*layer, reverse)
                    return torch.autograd.grad(out, layer, (dys, dhl))

                def cudnn_round():
                    out = cudnn(xs_l, h0_l)
                    return torch.autograd.grad(out, params,
                                               (dys, dhl[None]))
                # cuDNN's forward with grad (it keeps its own gates for
                # the backward), input product included
                row["library_forward_ms"] = cuda_ms(
                    lambda: cudnn(xs_l, h0_l), 20)
                row["function_round_trip_ms"] = cuda_ms(port_round, 20)
                row["library_round_trip_ms"] = cuda_ms(cudnn_round, 20)
            emit(row)
            rows.append(row)
            worst = max(*errs.values(), *auto_errs.values())
            if not np.isfinite(worst) or worst > TOL or not bitwise:
                raise AssertionError(f"gru_sequence_backward T={T} B={B} "
                                     f"reverse={reverse}: {errs} "
                                     f"{auto_errs}, ys bitwise equal to "
                                     f"the inference launch: {bitwise}")
    return rows


def gru_backward_launch(B: int, H: int) -> dict:
    """The backward kernel's launch shape as the kernel reports it
    (g2v_gru_sequence_backward_shape), held against the wrapper's
    mirror."""
    import ctypes

    from gesture2vec_tpu_torch.ops import gru_kernel as gk
    from gesture2vec_tpu_torch.ops.build import load

    fn = load("gru_sequence_backward").g2v_gru_sequence_backward_shape
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_longlong * 6)()
    rc = fn(B, H, out)
    got = dict(zip(("rows", "cluster", "threads", "smem_bytes", "clusters",
                    "max_active_clusters"), list(out)))
    want = gk.backward_launch_shape(
        B, H, max_clusters=max(got["max_active_clusters"], 1))
    if rc or any(want[k] != got[k] for k in got if k in want):
        raise AssertionError(f"GRU backward launch shape: kernel {got} "
                             f"(rc {rc}), wrapper {want}")
    return {**want, "max_active_clusters": got["max_active_clusters"]}


def near_ties(d: "torch.Tensor", a: "torch.Tensor", b: "torch.Tensor"):
    """(rows where a and b differ, how many of them are near-ties):
    d (N, K) holds the plain version's distances."""
    diff = (a != b).nonzero()[:, 0]
    rows = diff.numel()
    if rows == 0:
        return 0, 0
    gap = (d[diff, a[diff]] - d[diff, b[diff]]).abs()
    return rows, int((gap <= NEAR_TIE).sum().item())


def vq_kernel_rows() -> list:
    import torch

    from gesture2vec_tpu_torch.ops import vq_kernel as vk

    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for N, Kc, D in ([(N, Kc, VQ_D) for N, Kc in VQ_SHAPES]
                     + [(N, Kc, VQ_FRAME_D) for N, Kc in VQ_FRAME_SHAPES]):
        x = torch.randn(N, D, device="cuda", generator=g)
        cb = torch.randn(Kc, D, device="cuda", generator=g)
        idx, dmin = vk.vq_argmin(x, cb)
        d = vk.codebook_distances(x, cb)
        dmin_p, idx_p = d.min(dim=1)
        torch.cuda.synchronize()
        differ, ties = near_ties(d, idx, idx_p)
        err = (dmin - dmin_p).abs().max().item()
        del d
        row = {"phase": "kernel", "kernel": "vq_argmin", "N": N, "K": Kc,
               "D": D, "launch": vq_launch(N, D),
               "rows_differing": differ, "near_ties": ties,
               "near_tie_gap": NEAR_TIE, "max_abs_err": err,
               "tol": DMIN_TOL,
               "ms": cuda_ms(lambda: vk.vq_argmin(x, cb), 20),
               "plain_ms": cuda_ms(lambda: vk.vq_argmin_plain(x, cb), 10),
               "library_ms": None, **vq_bound_ms(N, Kc, D)}
        emit(row)
        rows.append(row)
        if differ != ties or not np.isfinite(err) or err > DMIN_TOL:
            raise AssertionError(f"vq_argmin N={N} K={Kc} D={D}: {differ} "
                                 f"rows "
                                 f"differ, {ties} near-ties; dmin error "
                                 f"{err}")
    return rows


def kernel_edges() -> dict:
    """Both kernels against their plain versions at the ragged edges of
    their tiles: GRU batches that fill no cluster or part of one, both
    directions, at H=200 and at H=201 (staged by 4-byte copies); VQ row
    counts that are no multiple of any block height, code counts below,
    at and past a 64-code tile, three widths (D=401 staged by 4-byte
    copies), rows at an address that is not 16-byte aligned; and exact
    ties between identical codes in two code tiles, where the lower index
    must win."""
    import torch

    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk
    from gesture2vec_tpu_torch.ops import vq_kernel as vk

    g = torch.Generator(device="cuda").manual_seed(4)
    # the chunk decoder: every tile edge at the path's width, rows at an
    # address that is not 16-byte aligned, and widths (H=198, D=38) whose
    # weights are staged by plain loads instead of bulk copies
    dec = []
    for H, D in ((HID, REP), (198, 38)):
        w = random_folded(H, D, g)
        for B in DECODER_EDGE_BATCHES:
            for offset in ((0, 1) if H == HID and B in (7, 293) else (0,)):
                x0 = torch.randn(B * D + offset, device="cuda",
                                 generator=g)[offset:].view(B, D)
                h0 = torch.randn(2 * B * H + offset, device="cuda",
                                 generator=g)[offset:].view(2, B, H)
                ys = dk.fused_chunk_decode(x0, h0, w, N_FRAMES)
                ref = dk.fused_chunk_decode_plain(x0, h0, w, N_FRAMES)
                torch.cuda.synchronize()
                dec.append({"B": B, "H": H, "D": D, "offset": offset,
                            "rows": decoder_launch(B, H, D)["rows"],
                            "max_abs_err": (ys - ref).abs().max().item()})
    gru_err = 0.0
    for H in (HID, HID + 1):
        bnd = 1.0 / H ** 0.5
        w = (torch.rand(3 * H, H, device="cuda", generator=g) * 2 - 1) * bnd
        b = (torch.rand(3 * H, device="cuda", generator=g) * 2 - 1) * bnd
        for B in GRU_EDGE_BATCHES:
            xp = torch.randn(GRU_T, B, 3 * H, device="cuda", generator=g)
            h0 = torch.randn(B, H, device="cuda", generator=g)
            for reverse in (False, True):
                ys, h = gk.gru_sequence(xp, h0, w, b, reverse)
                ys_p, h_p = gk.gru_sequence_plain(xp, h0, w, b, reverse)
                torch.cuda.synchronize()
                gru_err = max(gru_err, (ys - ys_p).abs().max().item(),
                              (h - h_p).abs().max().item())
    vq = []
    cases = [(N, Kc, D, 0) for D in (40, 400, 401) for Kc in (7, 300, 513)
             for N in (1, 4099)] + [(4099, 300, 400, 1)]
    for N, Kc, D, offset in cases:
        # offset 1: the rows start 4 bytes past an aligned address
        x = torch.randn(N * D + offset, device="cuda",
                        generator=g)[offset:].view(N, D)
        cb = torch.randn(Kc, D, device="cuda", generator=g)
        idx, dmin = vk.vq_argmin(x, cb)
        d = vk.codebook_distances(x, cb)
        dmin_p, idx_p = d.min(dim=1)
        torch.cuda.synchronize()
        differ, ties = near_ties(d, idx, idx_p)
        vq.append({"N": N, "K": Kc, "D": D, "offset": offset,
                   "rows_differing": differ, "near_ties": ties,
                   "max_abs_err": (dmin - dmin_p).abs().max().item()})
    # exact ties: code 64 repeats code 63 (two code tiles), code 200
    # repeats code 130; rows near them must take 63 and 130
    cb = torch.randn(300, VQ_D, device="cuda", generator=g)
    cb[64], cb[200] = cb[63], cb[130]
    near = torch.tensor([63] * 300 + [130] * 300, device="cuda")
    x = cb[near] + 0.01 * torch.randn(600, VQ_D, device="cuda", generator=g)
    idx, _ = vk.vq_argmin(x, cb)
    ties_lower = bool(torch.equal(idx, near))
    out = {"phase": "kernel_edges", "chunk_decoder": dec,
           "gru_batches": list(GRU_EDGE_BATCHES),
           "gru_widths": [HID, HID + 1], "gru_max_abs_err": gru_err, "tol": TOL, "vq": vq,
           "vq_exact_ties_take_lower_index": ties_lower}
    emit(out)
    if any(not r["max_abs_err"] <= TOL for r in dec) or gru_err > TOL \
            or not ties_lower or any(
            r["rows_differing"] != r["near_ties"]
            or r["max_abs_err"] > DMIN_TOL for r in vq):
        raise AssertionError(f"kernel edges: {out}")
    return out


def gssoft_near_ties(seq, hidden_plain, tok_a, tok_b) -> tuple:
    """(rows whose GS-Soft tokens differ, how many of them are near-ties
    of the plain log-assignment)."""
    import torch

    from gesture2vec_tpu_torch.models.seq_ae import _flatten_hidden

    diff = np.nonzero(tok_a != tok_b)[0]
    if diff.size == 0:
        return 0, 0
    with torch.inference_mode():
        flat = _flatten_hidden(hidden_plain, seq.vq_flatten)[diff]
        logp = seq.vq_layer.logp(flat).cpu().numpy()
    r = np.arange(diff.size)
    gap = np.abs(logp[r, tok_a[diff]] - logp[r, tok_b[diff]])
    return int(diff.size), int((gap <= GSSOFT_TIE).sum())


def rvq_near_ties(rvq, latents: np.ndarray, toks_a: np.ndarray,
                  toks_b: np.ndarray) -> tuple:
    """(windows whose residual-VQ stage tokens (N, S) differ, how many of
    them first differ at a near-tie): the residual follows toks_b, the
    reference, through the stages, and a stage's two codes are a near-tie
    where their distances to it differ by at most NEAR_TIE."""
    import torch

    from gesture2vec_tpu_torch.models.seq_ae import _flatten_hidden
    from gesture2vec_tpu_torch.ops import vq_kernel as vk

    rows = np.nonzero((toks_a != toks_b).any(axis=1))[0]
    ties = 0
    if rows.size:
        with torch.inference_mode():
            h = rvq.encode_hidden(torch.from_numpy(latents[rows]).cuda())
            resid = _flatten_hidden(h, rvq.vq_flatten)
            for s, cb in enumerate(rvq.vq_layer.codebooks()):
                a = torch.from_numpy(toks_a[rows, s]).cuda()
                b = torch.from_numpy(toks_b[rows, s]).cuda()
                d = vk.codebook_distances(resid, cb)
                gap = (d.gather(1, a[:, None].long())
                       - d.gather(1, b[:, None].long())).abs()[:, 0]
                first = (a != b) & (torch.as_tensor(
                    (toks_a[rows, :s] == toks_b[rows, :s])
                    .all(axis=1)).cuda())
                ties += int(((gap <= NEAR_TIE) & first).sum().item())
                resid = resid - cb[b.long()]
    return int(rows.size), ties


def part_c_path(smi: str, tmp: str) -> tuple:
    import torch

    from gesture2vec_tpu_torch.cli import cluster as cli
    from gesture2vec_tpu_torch.cluster import kmeans as km
    from gesture2vec_tpu_torch.cluster.latent_dataset import \
        build_latent_dataset
    from gesture2vec_tpu_torch.cluster.metrics import (
        frechet_distance, hellinger, representation_neighbor_distance,
        token_histogram, token_perplexity, wasserstein_distance)
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.datasets import pose_windows
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.data.teacher import (encode_windows_with_dae,
                                                    tokenize_windows)
    from gesture2vec_tpu_torch.ops import vq_kernel as vk

    rng = np.random.default_rng(0)
    dae_p, (vq_p, vq_s), (rvq_p, rvq_s) = part_c_trees(rng)
    enc = vq_p["encoder"]["gru"]
    gru_rows = gru_kernel_rows(*(
        torch.from_numpy(enc[f"l0_{n}"]).cuda()
        for n in ("w_ih", "w_hh", "b_ih", "b_hh")))
    vq_rows = vq_kernel_rows()
    kernel_edges()

    # -- main: the cluster CLI over the 244-minute corpus ------------
    t0 = time.perf_counter()
    train, val = write_corpus(tmp, rng)
    ckpt = {n: os.path.join(tmp, f"{n}.bin")
            for n in ("dae", "vq", "rvq")}
    write_checkpoint(ckpt["dae"], DAE_ARGS, dae_p, None, "DAE", DIM)
    write_checkpoint(ckpt["vq"], VQ_ARGS, vq_p, vq_s, "autoencoder_vq",
                     REP)
    write_checkpoint(ckpt["rvq"], RVQ_ARGS, rvq_p, rvq_s,
                     "autoencoder_vq", REP)
    setup_s = time.perf_counter() - t0
    out = os.path.join(tmp, "clusters")
    argv = [ckpt["dae"], ckpt["vq"], "--store", train, "--val-store",
            val, "--kmeans", str(PC_KMEANS), "--out", out]
    reset_launches()
    t0 = time.perf_counter()
    summary = cli.main(argv)
    cli_s = time.perf_counter() - t0
    counts = cli_counts = read_launches()
    n_win, n_val = summary["windows"], summary["val_windows"]
    want_gru = 2 * (math.ceil(n_win / 512) + math.ceil(n_val / 512))
    want_vq = sum(summary["kmeans_n_iter"]) + len(summary["kmeans_n_iter"])
    emit({"phase": "main", "path": "part_c",
          "command": "python -m gesture2vec_tpu_torch.cli.cluster "
                     + " ".join(os.path.basename(a) if a.startswith(tmp)
                                else a for a in argv),
          "launches": counts, "want": {"gru_sequence": want_gru,
                                       "vq_argmin": want_vq},
          "windows": n_win, "val_windows": n_val,
          "kmeans_lloyd_steps": summary["kmeans_n_iter"],
          "kmeans_inertia": summary["kmeans_inertia"],
          "seconds": cli_s, "setup_s": setup_s})
    if n_win != PC_CLIPS * ((PC_FRAMES - 20) // 5 + 1):
        raise AssertionError(f"{n_win} windows")
    if counts["gru_sequence"] != want_gru or \
            counts["vq_argmin"] != want_vq or counts["chunk_decoder"]:
        raise AssertionError(f"Part-c launches {counts}, want "
                             f"gru {want_gru}, vq {want_vq}")
    files = {f: os.path.getsize(os.path.join(out, f)) for f in (
        "org_latent_clustering_data.npz", "kmeans_model.npz",
        "Metrics.txt", "Metrics.tex", "Rep_distance.txt")}
    with np.load(os.path.join(out, "org_latent_clustering_data.npz")) \
            as z:
        cli_tokens, cli_lat = z["tokens"], z["seq_latents"]
    with np.load(os.path.join(out, "kmeans_model.npz")) as z:
        centers = z["centers"]
    metrics = open(os.path.join(out, "Metrics.txt")).read().split("\n")
    if cli_tokens.shape != (n_win,) or cli_lat.shape != (n_win, L * HID) \
            or not np.isfinite(cli_lat).all() \
            or centers.shape != (PC_KMEANS, L * HID) \
            or not np.isfinite(centers).all():
        raise AssertionError("Part-c outputs: bad shapes or values")
    n_codes = int(len(np.unique(cli_tokens)))
    if n_codes < 2:
        raise AssertionError("the sweep's tokens cover one code")

    # -- main: the residual-VQ sweep with all stage tokens -----------
    dae, _ = load_checkpoint_and_model(ckpt["dae"], "DAE")
    rvq, rvq_payload = load_checkpoint_and_model(ckpt["rvq"],
                                                 "autoencoder_vq")
    store = ClipStore(train)
    stride = int(rvq_payload["config"]["subdivision_stride"])
    reset_launches()
    t0 = time.perf_counter()
    rdata = build_latent_dataset(store, dae_model=dae, seq_model=rvq,
                                 n_poses=20, stride=stride,
                                 all_stages=True)
    rvq_s = time.perf_counter() - t0
    counts = read_launches()
    n_r = rdata["tokens"].shape[0]
    stages = RVQ_ARGS["rvq_stages"]
    want = {"gru_sequence": 2 * math.ceil(n_r / 512),
            "vq_argmin": stages * math.ceil(n_r / 512)}
    emit({"phase": "main", "path": "part_c_rvq_all_stages",
          "launches": counts, "want": want, "windows": n_r,
          "tokens_shape": list(rdata["tokens"].shape),
          "distinct_codes_per_stage": [
              int(len(np.unique(rdata["tokens"][:, s])))
              for s in range(stages)], "seconds": rvq_s})
    if rdata["tokens"].shape != (n_r, stages) or any(
            counts[k] != v for k, v in want.items()):
        raise AssertionError(f"RVQ sweep launches {counts}, want {want}")
    emit({"phase": "check", "path": "part_c", "files": files,
          "distinct_tokens": n_codes, "metrics": metrics[:-1],
          "note": "outputs present, finite, of the expected shapes"})

    # -- timing: the sweep stage by stage ----------------------------
    seq, _ = load_checkpoint_and_model(ckpt["vq"], "autoencoder_vq")
    stage = {}
    stage["store_read_and_windows"] = best_s(
        lambda: pose_windows(ClipStore(train), 20, 5))
    wins = pose_windows(store, 20, 5)
    stage["dae_encode"] = best_s(lambda: encode_windows_with_dae(dae,
                                                                 wins))
    lat_w = encode_windows_with_dae(dae, wins)
    stage["tokenize"] = best_s(lambda: tokenize_windows(seq, lat_w))
    toks, lats = tokenize_windows(seq, lat_w)
    sweep_s = best_s(lambda: build_latent_dataset(
        ClipStore(train), dae_model=dae, seq_model=seq, n_poses=20,
        stride=5))
    t0 = time.perf_counter()
    res = km.kmeans_fit(lats, PC_KMEANS, seed=0)
    stage["kmeans"] = time.perf_counter() - t0
    vdata = build_latent_dataset(ClipStore(val), dae_model=dae,
                                 seq_model=seq, n_poses=20, stride=5,
                                 mean=store.pose_mean,
                                 std=store.pose_std)
    t0 = time.perf_counter()
    hellinger(token_histogram(toks, K),
              token_histogram(vdata["tokens"], K))
    frechet_distance(lats, vdata["seq_latents"])
    token_perplexity(toks, K)
    wasserstein_distance(toks, vdata["tokens"])
    representation_neighbor_distance(lats)
    stage["metrics"] = time.perf_counter() - t0
    emit({"phase": "timing", "path": "part_c", "windows": len(toks),
          "sweep_s": sweep_s, "sweep_windows_per_s": len(toks) / sweep_s,
          "stages_s": stage, "kmeans_lloyd_steps": res.n_iter,
          "kmeans_s_per_lloyd_step": stage["kmeans"] / sum(res.n_iter),
          "cluster_cli_s": cli_s,
          "device_busy": device_busy(lambda: build_latent_dataset(
              ClipStore(train), dae_model=dae, seq_model=seq,
              n_poses=20, stride=5), sweep_s),
          "card": smi})

    # -- check: kernel path against plain path, card against CPU ----
    if not np.array_equal(toks, cli_tokens) or \
            np.abs(lats - cli_lat).max() > 0:
        raise AssertionError("the sweep is not deterministic")
    x = torch.from_numpy(lat_w).cuda()
    with torch.inference_mode():
        seq.set_use_kernels(False)
        toks_p, lats_p = tokenize_windows(seq, lat_w)
        hid_p = torch.cat([seq.encode_hidden(x[s:s + 4096])
                           for s in range(0, len(x), 4096)], dim=1)
        seq.set_use_kernels(True)
    differ, ties = gssoft_near_ties(seq, hid_p, toks, toks_p)
    lat_err = float(np.abs(lats - lats_p).max())
    # RVQ stage tokens, kernel against plain
    rvq.set_use_kernels(False)
    rt_p, _ = tokenize_windows(rvq, rdata["dae_latents"],
                               all_stages=True)
    rvq.set_use_kernels(True)
    r_rows, r_ties = rvq_near_ties(rvq, rdata["dae_latents"],
                                   rdata["tokens"], rt_p)
    # K-Means from the same initial centers: at every Lloyd step of
    # the kernel run, the kernel's assignment against the plain one
    # on the same centers; then the two whole runs, kernel and plain
    # (deterministic center sums keep them together until a near-tie
    # flips a label, which K-Means would amplify)
    xl = torch.from_numpy(lats).cuda()
    c0 = km.plusplus_init(xl, PC_KMEANS,
                          torch.Generator(device="cuda").manual_seed(3))
    c, steps, shift = c0, 0, float("inf")
    km_differ = km_ties = 0
    inertia_rel = 0.0
    while True:
        lk, dmin_k = vk.vq_argmin(xl, c)
        d = vk.codebook_distances(xl, c)
        dmin_p, lp = d.min(dim=1)
        differ_i, ties_i = near_ties(d, lk, lp)
        km_differ, km_ties = km_differ + differ_i, km_ties + ties_i
        inertia_rel = max(inertia_rel, abs(
            dmin_k.sum().item() - dmin_p.sum().item())
            / dmin_p.sum().item())
        if steps == 300 or not shift > 1e-4:   # lloyd's defaults
            break
        new = km.lloyd_step(xl, c)
        shift = torch.sum((new - c) ** 2).item()
        c, steps = new, steps + 1
    del d
    ck, lk, ik, nk = km.lloyd(xl, c0, use_kernel=True)
    km_deterministic = nk == steps and torch.equal(ck, c)
    cp, lp, ip, np_ = km.lloyd(xl, c0, use_kernel=False)
    run_differ, run_ties = near_ties(vk.codebook_distances(xl, cp),
                                     lk, lp)
    runs = {"lloyd_steps": [nk, np_], "labels_differing": run_differ,
            "near_ties": run_ties,
            "inertia_rel_err": abs(ik.item() - ip.item()) / ip.item()}
    # the card against the CPU path on the first windows
    dae_c, _ = load_checkpoint_and_model(ckpt["dae"], "DAE", "cpu")
    seq_c, _ = load_checkpoint_and_model(ckpt["vq"], "autoencoder_vq",
                                         "cpu")
    lat_c = encode_windows_with_dae(dae_c, wins[:CPU_WINDOWS])
    toks_c, lats_c = tokenize_windows(seq_c, lat_c)
    with torch.inference_mode():
        hid_c = seq_c.encode_hidden(torch.from_numpy(lat_c))
    c_differ, c_ties = gssoft_near_ties(seq_c, hid_c,
                                        toks[:CPU_WINDOWS], toks_c)
    cpu_err = max(float(np.abs(lat_w[:CPU_WINDOWS] - lat_c).max()),
                  float(np.abs(lats[:CPU_WINDOWS] - lats_c).max()))
    result = {
        "phase": "check", "path": "part_c_kernels_vs_plain",
        "gssoft_tokens_differing": differ, "gssoft_near_ties": ties,
        "gssoft_tie_margin": GSSOFT_TIE, "seq_latents_max_abs_err":
            lat_err, "tol": TOL,
        "rvq_rows_differing": r_rows, "rvq_near_ties": r_ties,
        "kmeans_lloyd_steps": steps,
        "kmeans_labels_differing": km_differ,
        "kmeans_near_ties": km_ties, "kmeans_inertia_rel_err":
            inertia_rel, "kmeans_deterministic": km_deterministic,
        "kmeans_same_seed_fits": [summary["kmeans_n_iter"], res.n_iter],
        "kmeans_kernel_vs_plain_runs": runs,
        "card_vs_cpu_windows": CPU_WINDOWS,
        "card_vs_cpu_tokens_differing": c_differ,
        "card_vs_cpu_near_ties": c_ties,
        "card_vs_cpu_max_abs_err": cpu_err}
    emit(result)
    if differ != ties or lat_err > TOL or r_rows != r_ties \
            or km_differ != km_ties or inertia_rel > 1e-5 \
            or not km_deterministic or run_differ != run_ties \
            or runs["inertia_rel_err"] > 1e-5 \
            or summary["kmeans_n_iter"] != res.n_iter \
            or c_differ != c_ties or cpu_err > TOL:
        raise AssertionError(f"Part-c check failed: {result}")

    def entry(name, rows, main_row, launches, library_ms):
        return {"name": name, "route": "cuda",
                "source": f"gesture2vec_tpu_torch/csrc/{name}.cu",
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"], "library_ms": library_ms}

    g512 = next(r for r in gru_rows if r["B"] == 512 and not r["reverse"])
    v_main = next(r for r in vq_rows if r["N"] == 58488 and r["D"] == VQ_D)
    files = {"dae": ckpt["dae"], "vq": ckpt["vq"], "train": train,
             "val": val,
             "bank": os.path.join(out, "org_latent_clustering_data.npz"),
             # the residual-VQ sweep's windows: the recipe's exemplar bank
             "rvq_bank": {"tokens": rdata["tokens"][:, 0],
                          "dae_latents": rdata["dae_latents"]}}
    return files, [
        {**entry("gru_sequence", gru_rows, g512,
                 cli_counts["gru_sequence"], g512["library_ms"]),
         "replaces": "gesture2vec_tpu/ops/gru_pallas.py:60", "B": 512,
         "T": GRU_T,
         # cuDNN's library_ms includes the input product: its like for
         # like is the matmul plus this kernel
         "matmul_plus_kernel_ms": g512["matmul_plus_kernel_ms"],
         "launch": g512["launch"]},
        {**entry("vq_argmin", vq_rows, v_main, cli_counts["vq_argmin"],
                 None),
         "replaces": "gesture2vec_tpu/ops/vq_pallas.py:54", "N": 58488,
         "K": PC_KMEANS, "launch": v_main["launch"],
         # the training path's shapes: a residual-VQ batch, the re-fit;
         # the VQFrame's step and its vq_tricks re-fit (D=40)
         "train_shapes": {f"N{r['N']}_K{r['K']}_D{r['D']}": {
             key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "max_abs_err",
                                     "rows_differing", "near_ties")}
             for r in vq_rows if r["N"] in (128, TRAIN_REFIT_ROWS)
             or r["D"] == VQ_FRAME_D}}]


# -- exemplar mode and the decode policies --------------------------------
def stage_split(gen, d: float, reps: int = 2) -> dict:
    """Host seconds of each stage of one request (best of reps, each
    timed alone on synchronised work): window ids, token decode (text
    encoder and decoder, noise included), then the chunk rollout and the
    DAE decode, or in exemplar mode the picks (host) and the bank gather
    with the DAE decode."""
    import torch

    w = words(d)
    out = {"windows": best_s(lambda: gen.window_inputs(w, d), reps)}
    ids, lens, n_windows = gen.window_inputs(w, d)
    n_tok = n_windows * gen.n_steps
    with torch.inference_mode():
        def tokens():
            return gen._predict_windows(
                ids[None], lens[None],
                gen._noise(gen._next_generator(), (1, ids.shape[0])))

        out["tokens"] = best_s(tokens, reps)
        pred = tokens()
        if gen.mode == "exemplar":
            toks = [pred["tokens"][0, :n_tok].to(torch.int32).cpu().numpy()]
            out["picks"] = best_s(lambda: gen._picks(toks), reps)
            picks = gen._picks(toks)
            out["gather_and_dae_decode"] = best_s(
                lambda: gen._exemplar_decode(picks).cpu(), reps)
            return out
        if gen.chunk_continuity:
            pred = {k: v[:, :n_tok] for k, v in pred.items()}
        out["chunk_decode"] = best_s(lambda: gen._decode_chunks(pred), reps)
        lat = gen._decode_chunks(pred).flatten(0, 1)
        out["dae_decode"] = best_s(lambda: gen.dae_model.decode(lat), reps)
    return out


def token_margins(gen, requests, seed: int = 0) -> dict:
    """For a fresh generator serving `requests` in this order: each
    request's decision margins (windows, n_steps - 1), at each step the
    smallest gap between the best and the second-best score of any choice
    made. The windows decode as `generate` decodes one transcript
    (window_carry), on the request's own noise: greedy and sampled scores
    come from the returned logits through `decision_scores`, beam's from
    its step scores (the K-th against the (K+1)-th, and at the last step
    also the best hypothesis' lead). Each request's words are
    words(d, seed)."""
    import torch

    from gesture2vec_tpu_torch.models.text2token import decision_scores

    def gap(scores):
        top = torch.topk(scores, 2, dim=-1).values
        return top[..., 0] - top[..., 1]

    if not gen.window_carry:
        raise ValueError("token_margins replays window_carry decodes")
    t2t, K = gen.t2t_model, gen._beam
    t0 = gen.temperature if gen.stage0_temperature < 0.0 \
        else gen.stage0_temperature
    out = {}
    with torch.inference_mode():
        for d in requests:
            ids, lens, _ = gen.window_inputs(words(d, seed), d)
            noise = gen._noise(gen._next_generator(), (1, ids.shape[0]))
            enc, hid = t2t.encode_text(ids, lens)
            positions = torch.arange(ids.shape[1], device=ids.device)
            seed = torch.zeros((1, gen.n_steps), dtype=torch.long,
                               device=ids.device)
            per = []
            for w in range(ids.shape[0]):
                args = (enc[:, w:w + 1], hid[:, w:w + 1], seed)
                mask = positions < lens[w]
                if K:
                    res = t2t.beam_decode(*args, K, mask)
                    s = res["step_scores"][0]
                    m = s[:, K - 1] - s[:, K]
                    if K > 1:
                        m[-1] = torch.minimum(m[-1], s[-1, 0] - s[-1, 1])
                else:
                    g = None if noise is None else noise[:, w]
                    res = t2t.decode_tokens(
                        *args, mask, temperature=gen.temperature,
                        top_k=gen.top_k,
                        stage0_temperature=gen.stage0_temperature, gumbel=g)
                    m = gap(decision_scores(res["logits"][:, 1:], t0,
                                            gen.top_k, None if g is None
                                            else g[:, :, 0]))[0]
                    if "stage_logits" in res:
                        m = torch.minimum(m, gap(decision_scores(
                            res["stage_logits"], gen.temperature, gen.top_k,
                            None if g is None else g[:, :, 1:]))[0]
                            .min(dim=-1).values)
                per.append(m)
                seed = torch.zeros_like(seed)
                if t2t.n_pre:
                    seed[:, :t2t.n_pre] = res["tokens"][:, -t2t.n_pre:]
            out[d] = torch.stack(per).cpu().numpy()
    return out


def compare_runs(got, ref, margins) -> dict:
    """got and ref are (frames, tokens) of one request. A window differs
    where a token differs or a frame by more than TOL. Every window before
    the first token difference has the same tokens and carried seed, so
    its frames must agree within TOL. At the first token difference the
    reference's smallest decision margin of that window (margins(),
    (windows, n_steps - 1)) must be at most LOGIT_TIE: a near-tie. The
    windows after it may differ through the carried seed."""
    (fg, tg), (fr, tr) = got, ref
    steps = SENT_LEN // N_FRAMES
    W = len(tr) // steps
    tok_bad = (tg != tr).reshape(W, steps).any(axis=1)
    err = np.abs(fg - fr).reshape(W, -1).max(axis=1)
    frame_bad = ~(err <= TOL)
    w_tok = int(np.argmax(tok_bad)) if tok_bad.any() else W
    res = {"windows": W, "windows_differing": int((tok_bad | frame_bad)
                                                  .sum()),
           "tokens_identical": bool(not tok_bad.any()),
           "max_abs_err": float(err.max()),
           "frames_ok_before_first_token_difference":
               bool(not frame_bad[:w_tok].any())}
    ok = res["frames_ok_before_first_token_difference"]
    if w_tok < W:
        m = float(margins()[w_tok].min())
        res.update({"first_token_differing_window": w_tok,
                    "its_margin": m, "near_tie": m <= LOGIT_TIE})
        ok = ok and res["near_tie"]
    res["ok"] = bool(ok)
    return res


def write_t2t_checkpoint(path: str, t2t_tree, vocab) -> None:
    """The decode path's Part-d weights as a text2embedding checkpoint in
    the JAX package's file format, with its vocabulary."""
    write_checkpoint(path, T2T_ARGS, t2t_tree["params"],
                     t2t_tree["batch_stats"], "text2embedding", K,
                     lang_model=vocab.state_dict(), n_words=N_WORDS)


def exemplar_path(smi: str, tmp: str, files: dict) -> dict:
    """Exemplar mode through `cli/_common.build_generator` from the Part-c
    DAE and tokenizer checkpoints, a text2embedding checkpoint at the bench
    widths (TCN encoder) and the 58,488-window bank the cluster CLI wrote."""
    import dataclasses

    from gesture2vec_tpu_torch.cli._common import build_generator
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.text.vocab import Vocab

    vocab = Vocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    t2t_path = os.path.join(tmp, "t2t.bin")
    write_t2t_checkpoint(t2t_path, jax_layout_trees(
        np.random.default_rng(0))[0], vocab)
    store = ClipStore(files["train"])

    def make(device, **policy):
        return build_generator(t2t_path, files["dae"], files["vq"], store,
                               mode="exemplar",
                               latent_bank_path=files["bank"], device=device,
                               seed=0, **policy)[0]

    t0 = time.perf_counter()
    gens = {False: make("cuda")}
    load_s = time.perf_counter() - t0
    gens[True] = dataclasses.replace(gens[False], exemplar_continuity=True)
    bank = gens[False]._exemplar_decode.bank
    reset_launches()
    outs = {c: {d: g.generate(words(d), d) for d in REQUESTS_S}
            for c, g in gens.items()}
    counts = read_launches()
    emit({"phase": "main", "path": "exemplar",
          "requests_s": list(REQUESTS_S), "launches": counts,
          "want": "no kernel: TCN encoder, bank gather and DAE decode",
          "bank_windows": int(bank.shape[0]),
          "bank_device_bytes": bank.numel() * bank.element_size(),
          "build_generator_s": load_s})
    if any(counts.values()):
        raise AssertionError(f"exemplar path launched kernels: {counts}")

    # -- check --------------------------------------------------------
    unit = SENT_LEN / FPS
    checks, base = {}, {"cuda": gens[False]}
    for c, per in outs.items():
        for d, (frames, toks) in per.items():
            n_windows = int(np.ceil(d / unit))
            if frames.shape != (n_windows * SENT_LEN, DIM) \
                    or not np.isfinite(frames).all() \
                    or toks.shape != (n_windows * SENT_LEN // N_FRAMES,):
                raise AssertionError(f"exemplar {d} s: frames {frames.shape}")
        # the card against the CPU path at 60 s, fresh generators (a
        # replace starts a new numpy stream from the seed and loads no
        # file), with each side's picks recorded
        runs = {}
        for dev in ("cuda", "cpu"):
            if dev not in base:
                base[dev] = make(dev)
            g = dataclasses.replace(base[dev], exemplar_continuity=c)
            picks, pick = [], g._picks
            g._picks = lambda toks, pick=pick, picks=picks: \
                picks.append(pick(toks)) or picks[-1]
            runs[dev] = (g.generate(words(60.0), 60.0), picks[0])
        cmp = compare_runs(runs["cuda"][0], runs["cpu"][0],
                           lambda: token_margins(dataclasses.replace(
                               base["cpu"]), [60.0])[60.0])
        cmp["picks_identical"] = bool(np.array_equal(runs["cuda"][1],
                                                     runs["cpu"][1]))
        checks["continuity" if c else "uniform"] = cmp
        if not cmp["ok"] or (cmp["tokens_identical"]
                             and not cmp["picks_identical"]):
            raise AssertionError(f"exemplar card vs CPU: {cmp}")
    emit({"phase": "check", "path": "exemplar", "card_vs_cpu_60s": checks,
          "tol": TOL, "near_tie_margin": LOGIT_TIE,
          "distinct_tokens_1800s": int(len(np.unique(
              outs[False][REQUESTS_S[-1]][1])))})

    # -- timing -------------------------------------------------------
    # (the profiler takes ~45 s over an 1800 s request's ~140k device
    # ops: the continuity mode's is not profiled)
    for c, g in gens.items():
        for d in REQUESTS_S:
            w = words(d)
            # one repeat of the long request keeps the run in its budget
            reps = 1 if d == REQUESTS_S[-1] else 2
            req_s = best_s(lambda: g.generate(w, d), reps=reps)
            busy = None if c and d == REQUESTS_S[-1] else device_busy(
                lambda: g.generate(w, d), req_s)
            emit({"phase": "timing", "path": "exemplar",
                  "exemplar_continuity": c, "request_s": d,
                  "frames": outs[c][d][0].shape[0], "seconds": req_s,
                  "frames_per_s": outs[c][d][0].shape[0] / req_s,
                  "stages_s": stage_split(g, d, reps), "device_busy": busy,
                  "card": smi})
    return counts


def repo_test_module(name: str):
    """tests/<name>.py of this checkout as `tests.<name>`, loaded from its
    file: the checkout's tests/ is a namespace package, which a `tests`
    package installed in site-packages would shadow."""
    import importlib.util

    full = f"tests.{name}"
    spec = importlib.util.spec_from_file_location(full, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def stage_clock(targets: dict):
    """Host seconds of named calls while the block runs: each target
    (owner, attribute), a module's function or a class's method, is
    wrapped in a timer and restored after. Yields {name: seconds}."""
    secs, saved = {}, []
    for name, (owner, attr) in targets.items():
        fn = getattr(owner, attr)

        def timed(*args, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                secs[_name] = secs.get(_name, 0.0) + \
                    time.perf_counter() - t0
        saved.append((owner, attr, fn))
        setattr(owner, attr, timed)
    try:
        yield secs
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def write_transcript(path: str, d: float, seed: int = 0) -> str:
    """words(d, seed) as a Google speech-to-text JSON transcript."""
    with open(path, "w") as f:
        json.dump({"results": [{"alternatives": [{"words": [
            {"word": w, "startTime": f"{s!r}s", "endTime": f"{e!r}s"}
            for w, s, e in words(d, seed)]}]}]}, f)
    return path


def bvh_parts(text: str) -> tuple:
    """(header through the Frame Time line, motion (frames, channels))."""
    head, motion = text.split("Frame Time:", 1)
    lines = motion.splitlines()
    return (head + "Frame Time:" + lines[0],
            np.array([ln.split() for ln in lines[1:]], np.float64))


def cli_path(smi: str, tmp: str, files: dict) -> dict:
    """The port's two commands as a user runs them: `make_dataset` over a
    Trinity-layout BVH corpus, then `g2v-infer` (the `cli/infer` entry
    function) from exemplar_path's text2embedding checkpoint, the Part-c
    checkpoints, store and bank, and the ingest's data_pipe.json, to BVH
    files."""
    import glob

    from gesture2vec_tpu_torch.cli import _common, infer, make_dataset
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.infer import exporter
    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu_torch.io.bvh import parse_bvh, write_bvh
    from gesture2vec_tpu_torch.io.subtitles import read_subtitles
    from gesture2vec_tpu_torch.mocap.features import FeatureExtractor
    from gesture2vec_tpu_torch.mocap.pipeline import MotionPipeline

    # -- ingest --------------------------------------------------------
    repo_test_module("fixtures")
    n_files, n_src = CLI_CORPUS
    corpus = repo_test_module("corpus").make_corpus(os.path.join(tmp, "corpus"), n_files=n_files,
                         n_frames=n_src, fps=60)
    out = os.path.join(tmp, "ingested")
    t0 = time.perf_counter()
    train_dir, val_dir = make_dataset.main([corpus, "--out", out])
    ingest_s = time.perf_counter() - t0
    stores = [ClipStore(train_dir), ClipStore(val_dir)]
    pipe = os.path.join(out, "data_pipe.json")
    fe = FeatureExtractor.load(pipe)
    widths = {s.meta["feature_dim"] for s in stores} | {
        s[i]["poses"].shape[1] for s in stores for i in range(len(s))}
    feats = fe.transform(parse_bvh(sorted(glob.glob(os.path.join(
        corpus, "Motion", "*.bvh")))[-1]))
    back = fe.transform(parse_bvh(write_bvh(fe.to_bvh(feats)),
                                  from_text=True))
    n = min(len(feats), len(back))
    rt_err = float(np.abs(feats[:n] - back[:n]).max())
    emit({"phase": "main", "path": "cli", "command":
          "python -m gesture2vec_tpu_torch.cli.make_dataset corpus",
          "corpus": {"files": n_files, "frames": n_src, "fps": 60},
          "clips": [len(s) for s in stores], "feature_widths":
          sorted(widths), "seconds": ingest_s,
          "source_frames_per_s": n_files * n_src / ingest_s,
          "round_trip_frames": n, "round_trip_max_abs_err": rt_err,
          "tol": TOL, "card": smi})
    if widths != {DIM} or [len(s) for s in stores] != \
            [2 * (n_files - 1), 2] or not rt_err <= TOL:
        raise AssertionError(f"ingest check failed: widths {widths}, "
                             f"round trip {rt_err}")

    # -- g2v-infer -----------------------------------------------------
    t2t = os.path.join(tmp, "t2t.bin")
    tdir = os.path.join(tmp, "transcripts")
    os.makedirs(tdir, exist_ok=True)

    def transcript(d, seed=0):
        return write_transcript(os.path.join(tdir, f"t{d:g}_{seed}.json"),
                                d, seed)

    def run(name, transcripts, *flags, dev="cuda"):
        argv = [t2t, *transcripts, files["dae"], files["vq"], "--store",
                files["train"], "--pipeline", pipe, "--device", dev,
                "--out", os.path.join(tdir, name + ".bvh"), *flags]
        reset_launches()
        t0 = time.perf_counter()
        res = infer.main(argv)
        secs = time.perf_counter() - t0
        return res, read_launches(), secs

    mid = REQUESTS_S[1]
    batch = f"decode_batch_3x{mid:g}s"
    plan = [(f"decode_{d:g}s", [transcript(d)], ("--mode", "decode"), 1)
            for d in REQUESTS_S]
    plan += [(batch, [transcript(mid, s) for s in (1, 2, 3)],
              ("--mode", "decode"), 1),
             (f"exemplar_{mid:g}s", [transcript(mid)],
              ("--latent-bank", files["bank"]), 0)]
    # the longest decode call is timed stage by stage, through the
    # functions the CLI calls
    timed_run = f"decode_{REQUESTS_S[-1]:g}s"
    export = ("savgol", "features_to_euler", "smoothing_spline",
              "inverse_transform", "write_bvh")
    targets = {"checkpoint_and_vocab_load": (_common, "build_generator"),
               "pipeline_load": (_common, "load_bvh_exporter"),
               "generate": (GestureGenerator, "generate"),
               "savgol": (exporter, "savgol"),
               "features_to_euler": (exporter, "features_to_euler"),
               "smoothing_spline": (exporter, "smoothing_spline"),
               "inverse_transform": (MotionPipeline, "inverse_transform"),
               "write_bvh": (exporter, "write_bvh")}
    unit = SENT_LEN / FPS
    # the chunk batches each call hands the decoder: the kernel phase held
    # the kernel against its plain version at each of KERNEL_BATCHES
    rollout, batches = GestureGenerator._rollout, []

    def recording(self, seed, hidden, n_steps):
        batches.append(int(seed.shape[0]))
        return rollout(self, seed, hidden, n_steps)

    counts, results = {}, {}
    for name, transcripts, flags, want in plan:
        batches.clear()
        GestureGenerator._rollout = recording
        try:
            with stage_clock(targets if name == timed_run else {}) \
                    as stages:
                res, c, secs = run(name, transcripts, *flags)
        finally:
            GestureGenerator._rollout = rollout
        counts[name], results[name] = c, res
        for (frames, toks, path), t in zip(res, transcripts):
            n_win = int(np.ceil(read_subtitles(t)[-1][2] / unit))
            with open(path) as f:
                _, motion = bvh_parts(f.read())
            if frames.shape != (n_win * SENT_LEN, DIM) \
                    or toks.shape != (n_win * SENT_LEN // N_FRAMES,) \
                    or not np.isfinite(frames).all() \
                    or motion.shape[0] != frames.shape[0] \
                    or not np.isfinite(motion).all():
                raise AssertionError(f"cli {name}: frames {frames.shape}, "
                                     f"BVH motion {motion.shape}")
        emit({"phase": "main", "path": "cli", "run": name,
              "transcripts": len(transcripts), "flags": list(flags),
              "launches": c, "want_chunk_decoder": want,
              "chunk_batches": list(batches),
              "frames": [r[0].shape[0] for r in res],
              "bvh_bytes": [os.path.getsize(r[2]) for r in res],
              "seconds": secs, "card": smi})
        if c != {"chunk_decoder": want, "gru_sequence": 0,
                 "gru_sequence_backward": 0, "vq_argmin": 0}:
            raise AssertionError(f"cli {name} launches {c}, want "
                                 f"chunk_decoder {want}")
        if want and not set(batches) <= set(KERNEL_BATCHES):
            raise AssertionError(f"cli {name}: chunk batches {batches} "
                                 f"not all among {KERNEL_BATCHES}")
        if name == timed_run:
            emit({"phase": "timing", "path": "cli", "run": name,
                  "frames": res[0][0].shape[0], "seconds": secs,
                  "stages_s": stages,
                  "export_s": sum(stages[k] for k in export),
                  "largest_stage": max(stages, key=stages.get),
                  "card": smi})

    # -- check: the card against the CPU, the middle request alone and
    # the batch of three, transcript by transcript --------------------
    def margins(seed):
        return lambda: token_margins(_common.build_generator(
            t2t, files["dae"], files["vq"], ClipStore(files["train"]),
            mode="decode", device="cpu", seed=0)[0], [mid], seed)[mid]

    checks = {}
    for name, seeds in ((f"decode_{mid:g}s", (0,)), (batch, (1, 2, 3))):
        cpu, _, cpu_s = run("cpu_" + name, [transcript(mid, s)
                                            for s in seeds],
                            "--mode", "decode", dev="cpu")
        for seed, card, ref in zip(seeds, results[name], cpu):
            cmp = compare_runs(card[:2], ref[:2], margins(seed))
            with open(card[2]) as f:
                head, motion = bvh_parts(f.read())
            with open(ref[2]) as f:
                c_head, c_motion = bvh_parts(f.read())
            cmp.update({
                "bvh_headers_identical": head == c_head,
                "bvh_frames": [motion.shape[0], c_motion.shape[0]],
                # printed, not held: the export's euler extraction of an
                # untrained model's non-orthonormal matrices amplifies
                # frame differences near its poles
                "bvh_motion_max_abs_diff": float(np.abs(
                    motion - c_motion).max()) if motion.shape ==
                c_motion.shape else None,
                "cpu_seconds": cpu_s})
            checks[f"{name}/words_seed{seed}"] = cmp
    emit({"phase": "check", "path": "cli", "card_vs_cpu": checks,
          "tol": TOL, "near_tie_margin": LOGIT_TIE})
    bad = {k: c for k, c in checks.items() if not c["ok"]
           or not c["bvh_headers_identical"]
           or c["bvh_frames"][0] != c["bvh_frames"][1]}
    if bad:
        raise AssertionError(f"cli card vs CPU: {bad}")
    return counts


# -- the serve path: g2v-serve's /generate and /stream under load ---------
def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(port: int, method: str, path: str, obj=None,
              timeout: float = 300.0):
    """(status, body bytes, seconds) of one request to 127.0.0.1:port."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=None if obj is None else
                     json.dumps(obj), headers={"Content-Type":
                                               "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, body, time.perf_counter() - t0
    finally:
        conn.close()


def http_generate(port: int, d: float, seed: int, fmt: str = "json"):
    """POST /generate of words(d, seed): ((frames, tokens) or the BVH
    text, seconds). A status other than 200 fails."""
    import base64

    code, body, secs = http_call(port, "POST", "/generate", {
        "words": words(d, seed), "duration_s": d, "format": fmt})
    if code != 200:
        raise AssertionError(f"/generate answered {code}: {body[:300]}")
    if fmt == "bvh":
        return body.decode(), secs
    out = json.loads(body)
    frames = np.frombuffer(base64.b64decode(out["frames_b64"]),
                           np.float32).reshape(out["frames_shape"])
    return (frames, np.asarray(out["tokens"], np.int32)), secs


def http_stream(port: int, d: float, seed: int, timeout: float = 300.0):
    """POST /stream of words(d, seed), read line by line: ((frames,
    tokens) of the windows concatenated, the seconds from the request to
    each window's line). A status other than 200, an error line or a
    wrong done line fails."""
    import base64
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/stream", body=json.dumps(
            {"words": words(d, seed), "duration_s": d}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"/stream answered {resp.status}: "
                                 f"{resp.read()[:300]}")
        lines, stamps = [], []
        while True:
            ln = resp.readline()
            if not ln:
                break
            lines.append(json.loads(ln))
            stamps.append(time.perf_counter() - t0)
    finally:
        conn.close()
    n_windows = int(np.ceil(d / (SENT_LEN / FPS)))
    if lines[-1] != {"done": True, "windows": n_windows} or any(
            "error" in ln for ln in lines):
        raise AssertionError(f"/stream ended with {lines[-1]}")
    windows = lines[:-1]
    frames = np.concatenate([np.frombuffer(base64.b64decode(
        w["frames_b64"]), np.float32).reshape(w["frames_shape"])
        for w in windows])
    tokens = np.concatenate([w["tokens"] for w in windows]).astype(np.int32)
    return (frames, tokens), stamps[:-1]


def concurrently(fn, n: int) -> list:
    """fn(i) for i < n, each on its own thread; the results in order (a
    failure in any thread fails the call)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(fn, range(n)))


@contextlib.contextmanager
def serving(gen, **kw):
    """The in-process server (serve() on port 0), shut down after."""
    import threading

    from gesture2vec_tpu_torch.serve.server import serve

    httpd = serve(gen, port=0, **kw)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


def percentiles(values) -> dict:
    from gesture2vec_tpu_torch.serve.server import nearest_rank

    values = list(values)
    return {"p50": nearest_rank(values, 0.5),
            "p99": nearest_rank(values, 0.99)}


def serve_path(smi: str, tmp: str, files: dict) -> dict:
    """`g2v-serve` in process (serve() on port 0) with the decode generator
    at the bench widths (weights through the bridge): /generate from 1, 16
    and 32 clients and one BVH request through the ingest's data_pipe.json;
    /stream from 1, 16 and 64 sessions, per-session steps and through the
    stream-step batcher capped at 1 and at 16; a chunk_continuity stream,
    a recipe stream and an exemplar-continuity stream over the cluster
    CLI's bank; the GRU text encoder's Part d from 8 streams and 4
    concurrent /generate requests. Every answer
    is held against the card's own `generate` (near-tie rule), launches
    and chunk batches against what each endpoint sends. Then `python -m
    gesture2vec_tpu_torch.cli.serve` as a subprocess, stopped by SIGINT."""
    import dataclasses
    import signal

    from gesture2vec_tpu_torch.cli import _common
    from gesture2vec_tpu_torch.models import gru as gru_module
    from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu_torch.io.bvh import write_bvh
    from gesture2vec_tpu_torch.text.vocab import Vocab

    vocab = Vocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    pose_mean = np.zeros(DIM, np.float32)
    pose_std = np.ones(DIM, np.float32)

    def make(trees, device, **kw):
        return generator_from_jax(
            *trees, vocab, pose_mean, pose_std, n_frames=N_FRAMES,
            sentence_frame_length=SENT_LEN, fps=FPS, max_words=MAXW,
            device=device, mode="decode", seed=0, **kw)

    trees = jax_layout_trees(np.random.default_rng(0))
    gen = make(trees, "cuda")
    pipe = os.path.join(tmp, "ingested", "data_pipe.json")
    to_bvh = _common.load_bvh_exporter("trinity", pipe)

    def export_bvh(frames):
        return write_bvh(to_bvh(frames, path=None))

    d = SERVE_REQUEST_S
    n_win = int(np.ceil(d / (SENT_LEN / FPS)))
    steps = SENT_LEN // N_FRAMES
    # the chunk batch of every rollout while the path runs (each phase
    # reads its own before it compares with the card's `generate`), and
    # the (T, B) of every GRU recurrence (the GRU text encoder's)
    rollout, batches = GestureGenerator._rollout, []
    recurrence, gru_batches = gru_module.gru_sequence, []

    def recording(self, seed, hidden, n_steps):
        batches.append(int(seed.shape[0]))
        return rollout(self, seed, hidden, n_steps)

    def recording_gru(x_proj, *args):
        gru_batches.append(tuple(x_proj.shape[:2]))
        return recurrence(x_proj, *args)

    solo = {}

    def solo_of(s):
        if s not in solo:
            solo[s] = gen.generate(words(d, s), d)
        return solo[s]

    def vs_solo(got, s, ref=None, margin_gen=None):
        """compare_runs of an answer for words(d, s) against the card's
        `generate` (near-tie margins from a fresh generator)."""
        return compare_runs(got, ref if ref is not None else solo_of(s),
                            lambda: token_margins(
                                margin_gen() if margin_gen else
                                make(trees, "cuda"), [d], s)[d])

    checks, counts = {}, {}

    def record(name, c, want, got_batches, allowed, want_gru=0,
               got_gru=(), allowed_gru=()):
        """Check one run's launches (want chunk-decoder and GRU-sequence
        launches) and batches (among `allowed` and KERNEL_BATCHES, the
        GRU's at T=48 among `allowed_gru` and GRU_T48_BATCHES)."""
        counts[name] = c
        gru_bs = sorted({b for t, b in got_gru})
        row = {"phase": "main", "path": "serve", "run": name, "launches": c,
               "want_chunk_decoder": want, "want_gru_sequence": want_gru,
               "chunk_batches": sorted(set(got_batches)),
               "chunk_batch_counts": {b: got_batches.count(b)
                                      for b in sorted(set(got_batches))},
               "gru_t48_batches": gru_bs}
        emit(row)
        if c["chunk_decoder"] != want or c["gru_sequence"] != want_gru \
                or c["vq_argmin"]:
            raise AssertionError(f"serve {name}: launches {c}, want "
                                 f"chunk_decoder {want}, gru_sequence "
                                 f"{want_gru}")
        if not set(got_batches) <= set(allowed) \
                or not set(got_batches) <= set(KERNEL_BATCHES):
            raise AssertionError(f"serve {name}: chunk batches "
                                 f"{sorted(set(got_batches))} not among "
                                 f"{allowed} and {KERNEL_BATCHES}")
        if any(t != MAXW for t, _ in got_gru) \
                or not set(gru_bs) <= set(allowed_gru) \
                or not set(gru_bs) <= set(GRU_T48_BATCHES):
            raise AssertionError(f"serve {name}: GRU batches {got_gru} "
                                 f"not at T={MAXW} among {allowed_gru} "
                                 f"and {GRU_T48_BATCHES}")

    GestureGenerator._rollout = recording
    gru_module.gru_sequence = recording_gru
    try:
        # -- /generate: 8 sequential clients, then 16 and 32 at once ----
        gen_buckets = [96 * b for b in (1, 2, 4, 8, 16, 32)]
        for clients, concurrent in ((SERVE_SEQUENTIAL, False),
                                    *((n, True) for n in SERVE_CLIENTS)):
            name = f"generate_{clients}_{'concurrent' if concurrent else 'sequential'}"
            with serving(gen, max_batch=SERVE_MAX_BATCH,
                         export_bvh=export_bvh) as httpd:
                batches.clear()
                reset_launches()
                t0 = time.perf_counter()
                if concurrent:
                    res = concurrently(lambda i: http_generate(
                        httpd.server_address[1], d, i), clients)
                else:
                    res = [http_generate(httpd.server_address[1], d, i)
                           for i in range(clients)]
                wall = time.perf_counter() - t0
                c, got_batches = read_launches(), list(batches)
                stats = dict(httpd.worker.stats)
                lat = httpd.worker.latency_stats()
                busy = None
                if clients == SERVE_CLIENTS[-1]:
                    busy = device_busy(lambda: concurrently(
                        lambda i: http_generate(httpd.server_address[1], d,
                                                i), clients), wall)
            record(name, c, stats["batches"], got_batches,
                   gen_buckets if concurrent else [96])
            if stats["requests"] != clients or (
                    not concurrent and stats["batched_requests"]) or (
                    concurrent and stats["batches"] >= clients):
                raise AssertionError(f"serve {name}: worker stats {stats}")
            cmp = [vs_solo(r, i) for i, (r, _) in enumerate(res)]
            checks[name] = {"windows_differing": sum(
                x["windows_differing"] for x in cmp), "max_abs_err": max(
                x["max_abs_err"] for x in cmp), "ok": all(x["ok"]
                                                         for x in cmp)}
            frames = sum(r[0].shape[0] for r, _ in res)
            emit({"phase": "timing", "path": "serve",
                          "endpoint": "/generate", "clients": clients,
                          "concurrent": concurrent, "request_s": d,
                          "frames": frames, "seconds": wall,
                          "frames_per_s": frames / wall,
                          "worker_latency": lat,
                          "client_latency_s": percentiles(
                              s for _, s in res),
                          "batches": stats["batches"],
                          "batched_requests": stats["batched_requests"],
                          "device_busy": busy, "card": smi})
            if not checks[name]["ok"]:
                raise AssertionError(f"serve {name}: {cmp}")
            if not concurrent:
                generate_0 = res[0][0]

        # -- one BVH answer at 6 s through the ingest's data_pipe.json ---
        with serving(gen, export_bvh=export_bvh) as httpd:
            batches.clear()
            reset_launches()
            text, secs = http_generate(httpd.server_address[1],
                                       SERVE_BVH_S, 0, fmt="bvh")
            c = read_launches()
        _, motion = bvh_parts(text)
        record("generate_bvh_6s", c, 1, list(batches), [6])
        if motion.shape[0] != SENT_LEN or not np.isfinite(motion).all():
            raise AssertionError(f"serve BVH answer: motion {motion.shape}")
        emit({"phase": "timing", "path": "serve",
                      "endpoint": "/generate", "format": "bvh",
                      "request_s": SERVE_BVH_S, "seconds": secs,
                      "bvh_bytes": len(text), "card": smi})

        # -- /stream through the stream-step batcher, capped at 1 and 16 --
        streams = {}
        for sessions, sb in SERVE_STREAMS:
            name = f"stream_{sessions}_batch{sb}"
            with serving(gen, stream_batch=sb) as httpd:
                batches.clear()
                reset_launches()
                t0 = time.perf_counter()
                res = concurrently(lambda i: http_stream(
                    httpd.server_address[1], d, i), sessions)
                wall = time.perf_counter() - t0
                c, got_batches = read_launches(), list(batches)
                bstats = dict(httpd.stream_programs.batcher.stats)
                stats = dict(httpd.worker.stats)
                busy = None
                if (sessions, sb) == SERVE_STREAMS[-1]:
                    busy = device_busy(lambda: concurrently(
                        lambda i: http_stream(httpd.server_address[1], d,
                                              i), sessions), wall)
            streams[sessions, sb] = [r for r, _ in res]
            record(name, c, bstats["batches"], got_batches,
                   [6 * b for b in (1, 2, 4, 8, 16)] if sb > 1 else [6])
            if stats["streams"] != sessions or \
                    stats["stream_windows"] != sessions * n_win or \
                    bstats["calls"] != sessions * n_win or (
                    sb == 1 and bstats["batches"] != sessions * n_win):
                raise AssertionError(f"serve {name}: stats {stats}, "
                                     f"batcher {bstats}")
            cmp = [vs_solo(r, i) for i, (r, _) in enumerate(res)]
            if sb > 1:
                # the batched sessions against their unbatched run
                cmp += [compare_runs(r, u, lambda i=i: token_margins(
                    make(trees, "cuda"), [d], i)[d]) for i, (r, u) in
                    enumerate(zip(streams[sessions, sb],
                                  streams[sessions, 1]))]
            checks[name] = {"windows_differing": sum(
                x["windows_differing"] for x in cmp), "max_abs_err": max(
                x["max_abs_err"] for x in cmp), "ok": all(x["ok"]
                                                         for x in cmp)}
            first = [st[0] for _, st in res]
            per_window = [b - a for _, st in res
                          for a, b in zip([0.0] + st[:-1], st)]
            emit({"phase": "timing", "path": "serve",
                          "endpoint": "/stream", "sessions": sessions,
                          "stream_batch": sb, "request_s": d,
                          "windows": sessions * n_win, "seconds": wall,
                          "windows_per_s": sessions * n_win / wall,
                          "first_window_s": percentiles(first),
                          "window_latency_s": percentiles(per_window),
                          "batcher": bstats, "device_busy": busy,
                          "card": smi})
            if not checks[name]["ok"]:
                raise AssertionError(f"serve {name}: {cmp}")

        # -- a chunk_continuity stream, a recipe stream, an exemplar one --
        cont = dataclasses.replace(gen, chunk_continuity=True)
        recipe = make(recipe_trees(np.random.default_rng(0)), "cuda",
                      t2t_n_pre_poses=RECIPE_N_PRE, t2t_heads=RECIPE_HEADS)
        t2t = os.path.join(tmp, "t2t.bin")
        exemplar = _common.build_generator(
            t2t, files["dae"], files["vq"], ClipStore(files["train"]),
            mode="exemplar", latent_bank_path=files["bank"], device="cuda",
            seed=0, exemplar_continuity=True)[0]
        one = (("stream_continuity", cont, n_win * steps, [1],
                lambda: dataclasses.replace(gen, chunk_continuity=True)),
               ("stream_recipe_greedy", recipe, n_win, [6],
                lambda: make(recipe_trees(np.random.default_rng(0)), "cuda",
                             t2t_n_pre_poses=RECIPE_N_PRE,
                             t2t_heads=RECIPE_HEADS)),
               ("stream_exemplar_continuity", exemplar, 0, [],
                lambda: dataclasses.replace(exemplar)))
        for name, g, want, allowed, fresh in one:
            with serving(g) as httpd:
                batches.clear()
                reset_launches()
                got, stamps = http_stream(httpd.server_address[1], d, 0)
                c = read_launches()
            record(name, c, want, list(batches), allowed)
            # a fresh generator of the same seed: exemplar picks draw the
            # same numpy stream
            cmp = vs_solo(got, 0, ref=fresh().generate(words(d, 0), d),
                          margin_gen=fresh)
            checks[name] = cmp
            emit({"phase": "timing", "path": "serve",
                          "endpoint": "/stream", "run": name,
                          "request_s": d, "seconds": stamps[-1],
                          "first_window_s": stamps[0], "card": smi})
            if not cmp["ok"]:
                raise AssertionError(f"serve {name}: {cmp}")

        # -- the GRU text encoder: streams through the batcher, a fused
        # /generate; 4 recurrences (2 layers, 2 directions) a text encode
        gru_trees = policy_trees(np.random.default_rng(0))["gru"]
        gru_gen = make(gru_trees, "cuda")
        gru_solo = {}
        for name, n, endpoint in (
                (f"gru_stream_{SERVE_GRU_STREAMS}", SERVE_GRU_STREAMS,
                 http_stream),
                (f"gru_generate_{SERVE_GRU_CLIENTS}_concurrent",
                 SERVE_GRU_CLIENTS, http_generate)):
            with serving(gru_gen, max_batch=SERVE_MAX_BATCH) as httpd:
                batches.clear()
                gru_batches.clear()
                reset_launches()
                t0 = time.perf_counter()
                res = concurrently(lambda i: endpoint(
                    httpd.server_address[1], d, i), n)
                wall = time.perf_counter() - t0
                c, got_batches = read_launches(), list(batches)
                got_gru = list(gru_batches)
                stats = dict(httpd.worker.stats)
                sbat = httpd.stream_programs.batcher
                bstats = None if sbat is None else dict(sbat.stats)
            if endpoint is http_stream:
                record(name, c, bstats["batches"], got_batches,
                       [6 * b for b in (1, 2, 4, 8)], 4 * bstats["batches"],
                       got_gru, (1, 2, 4, 8))
            else:
                record(name, c, stats["batches"], got_batches,
                       [96 * b for b in (1, 2, 4)], 4 * stats["batches"],
                       got_gru, (16, 32, 64))
            for i in range(n):
                if i not in gru_solo:
                    gru_solo[i] = gru_gen.generate(words(d, i), d)
            cmp = [vs_solo(r, i, ref=gru_solo[i],
                           margin_gen=lambda: make(gru_trees, "cuda"))
                   for i, (r, _) in enumerate(res)]
            checks[name] = {"windows_differing": sum(
                x["windows_differing"] for x in cmp), "max_abs_err": max(
                x["max_abs_err"] for x in cmp), "ok": all(x["ok"]
                                                         for x in cmp)}
            emit({"phase": "timing", "path": "serve", "run": name,
                  "request_s": d, "clients": n, "seconds": wall,
                  "batches": stats["batches"], "batcher": bstats,
                  "card": smi})
            if not checks[name]["ok"]:
                raise AssertionError(f"serve {name}: {cmp}")
    finally:
        GestureGenerator._rollout = rollout
        gru_module.gru_sequence = recurrence

    # -- the card against the CPU: one /generate and one /stream answer --
    cpu_ref = make(trees, "cpu").generate(words(d, 0), d)
    cpu_margins = (lambda: token_margins(make(trees, "cpu"), [d], 0)[d])
    checks["card_vs_cpu"] = {
        "generate": compare_runs(generate_0, cpu_ref, cpu_margins),
        "stream": compare_runs(streams[1, 1][0], cpu_ref, cpu_margins)}
    if not all(c["ok"] for c in checks["card_vs_cpu"].values()):
        raise AssertionError(f"serve card vs CPU: {checks['card_vs_cpu']}")

    # -- the command: python -m gesture2vec_tpu_torch.cli.serve -----------
    port = free_port()
    cmd = [sys.executable, "-m", "gesture2vec_tpu_torch.cli.serve", t2t,
           files["dae"], files["vq"], "--store", files["train"],
           "--pipeline", pipe, "--port", str(port), "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        health = None
        while time.perf_counter() - t0 < SERVE_CLI_START_S:
            if proc.poll() is not None:
                break
            try:
                code, body, _ = http_call(port, "GET", "/healthz",
                                          timeout=10)
            except OSError:
                time.sleep(0.25)
                continue
            if code == 200:
                health = json.loads(body)
                break
        up_s = time.perf_counter() - t0
        if health is None:
            raise AssertionError(f"g2v-serve did not come up in "
                                 f"{SERVE_CLI_START_S} s (exit "
                                 f"{proc.poll()})")
        text, gen_s = http_generate(port, d, 0, fmt="bvh")
        (frames, toks), stamps = http_stream(port, SERVE_BVH_S, 0)
        _, motion = bvh_parts(text)
        code, body, _ = http_call(port, "GET", "/healthz", timeout=30)
        health = json.loads(body)
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        rc = proc.returncode
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    cli = {"phase": "main", "path": "serve", "run": "cli_subprocess",
           "command": "python -m gesture2vec_tpu_torch.cli.serve t2t.bin "
           "dae.bin vq.bin --store train --pipeline data_pipe.json "
           "--port P --device cuda", "up_s": up_s, "healthz": health,
           "generate_bvh_frames": int(motion.shape[0]),
           "generate_s": gen_s, "stream_frames": list(frames.shape),
           "stream_s": stamps[-1], "exit_code": rc,
           "log_tail": out.strip().splitlines()[-3:], "card": smi}
    emit(cli)
    if rc != 0 or motion.shape[0] != n_win * SENT_LEN \
            or not np.isfinite(motion).all() \
            or frames.shape != (SENT_LEN, DIM) \
            or not np.isfinite(frames).all() \
            or health["requests"] != 1 or health["streams"] != 1:
        raise AssertionError(f"g2v-serve subprocess: {cli}")

    emit({"phase": "check", "path": "serve", "vs_card_generate": checks,
          "tol": TOL, "near_tie_margin": LOGIT_TIE})
    return counts


def policy_trees(rng: np.random.Generator) -> dict:
    """Bench-width variables for the policies path: the decode path's
    (TCN encoder, one stage), a 4-stage Part d with independent or chained
    stage heads over a 4-stage residual-VQ decoder (configs/VQ-VAE_rvq.yml
    stages), and the GRU text encoder."""
    t2t, seq, dae = jax_layout_trees(rng)

    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, size=shape).astype(np.float32)

    stages = RVQ_ARGS["rvq_stages"]
    heads = {f"out_layer_r{s}": {"kernel": u((HID, K), HID),
                                 "bias": u((K,), HID)}
             for s in range(1, stages)}
    embeds = {f"stage_embed_{s}": {"embedding": (
        rng.normal(size=(K, HID)) / np.sqrt(HID)).astype(np.float32)}
        for s in range(stages - 1)}
    bigru = {}
    for layer in range(L):
        d = WORDEMBED if layer == 0 else 2 * HID
        for sfx in ("", "_reverse"):
            bigru.update({f"l{layer}_w_ih{sfx}": u((3 * HID, d), HID),
                          f"l{layer}_w_hh{sfx}": u((3 * HID, HID), HID),
                          f"l{layer}_b_ih{sfx}": u((3 * HID,), HID),
                          f"l{layer}_b_hh{sfx}": u((3 * HID,), HID)})
    p = t2t["params"]

    def t2t_with(encoder=None, **step):
        return {"params": {"encoder": encoder or p["encoder"],
                           "decoder_step": {**p["decoder_step"], **step}},
                "batch_stats": t2t["batch_stats"]}

    seq4 = {"params": {**seq["params"], "vq_layer": {
        **seq["params"]["vq_layer"],
        **{f"codebook_r{s}": (0.1 * rng.normal(size=(K, L * HID)))
           .astype(np.float32) for s in range(1, stages)}}},
        "batch_stats": seq["batch_stats"]}
    gru_enc = {"embedding_table": p["encoder"]["embedding_table"],
               "gru": bigru}
    return {"tcn": (t2t, seq, dae), "stage4": (t2t_with(**heads), seq4, dae),
            "stage4_cond": (t2t_with(**heads, **embeds), seq4, dae),
            "gru": (t2t_with(gru_enc), seq, dae)}


def policy_kernel_rows(folded, gru_w) -> dict:
    """Both kernels at the shapes the policies give them, against their
    plain versions: the chunk decoder at n_steps 24 (decode_overlap 4) for
    the 60 s and 1800 s chunk batches and at B=1 (chunk_continuity); the
    GRU sequence at T=48 (the text encoder's word window) for each of
    GRU_T48_BATCHES windows (303: no multiple of the 20-row cluster
    tile), both
    directions, with cuDNN's layer and the matmul plus the kernel beside
    it at every B."""
    import torch

    from gesture2vec_tpu_torch.models.gru import gru_layer
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    g = torch.Generator(device="cuda").manual_seed(5)
    rows = {"chunk_decoder": {}, "gru_sequence": {}}
    for B, n in ((96, 24), (1824, 24), (1, 20), (1, 24)):
        x0 = torch.randn(B, REP, device="cuda", generator=g)
        h0 = torch.randn(2, B, HID, device="cuda", generator=g)
        ys = dk.fused_chunk_decode(x0, h0, folded, n)
        ref = dk.fused_chunk_decode_plain(x0, h0, folded, n)
        torch.cuda.synchronize()
        row = {"phase": "kernel", "kernel": "chunk_decoder", "B": B,
               "H": HID, "D": REP, "n_steps": n,
               "launch": decoder_launch(B, HID, REP),
               "max_abs_err": (ys - ref).abs().max().item(), "tol": TOL,
               "ms": cuda_ms(lambda: dk.fused_chunk_decode(x0, h0, folded,
                                                           n), 20),
               "plain_ms": cuda_ms(lambda: dk.fused_chunk_decode_plain(
                   x0, h0, folded, n), 10),
               **chunk_decoder_bound_ms(B, REP, HID, n)}
        emit(row)
        rows["chunk_decoder"][f"B{B}_T{n}"] = row
    w_ih, w_hh, b_ih, b_hh = gru_w
    cudnn = torch.nn.GRU(w_ih.shape[1], HID, 1).cuda()
    with torch.no_grad():
        for prm, v in ((cudnn.weight_ih_l0, w_ih), (cudnn.weight_hh_l0, w_hh),
                       (cudnn.bias_ih_l0, b_ih), (cudnn.bias_hh_l0, b_hh)):
            prm.copy_(v)
    with torch.inference_mode():
        for B in GRU_T48_BATCHES:
            xs = torch.randn(48, B, w_ih.shape[1], device="cuda",
                             generator=g)
            h0 = torch.zeros(B, HID, device="cuda")
            xp = (xs.reshape(-1, xs.shape[2]) @ w_ih.t() + b_ih).reshape(
                48, B, -1)
            err = 0.0
            for reverse in (False, True):
                ys, h = gk.gru_sequence(xp, h0, w_hh, b_hh, reverse)
                ys_p, h_p = gk.gru_sequence_plain(xp, h0, w_hh, b_hh,
                                                  reverse)
                torch.cuda.synchronize()
                err = max(err, (ys - ys_p).abs().max().item(),
                          (h - h_p).abs().max().item())
            row = {"phase": "kernel", "kernel": "gru_sequence", "B": B,
                   "T": 48, "H": HID, "directions": 2,
                   "launch": gru_launch(B, HID), "max_abs_err": err,
                   "tol": TOL,
                   "ms": cuda_ms(lambda: gk.gru_sequence(xp, h0, w_hh,
                                                         b_hh), 20),
                   "plain_ms": cuda_ms(lambda: gk.gru_sequence_plain(
                       xp, h0, w_hh, b_hh), 5),
                   **gru_bound_ms(48, B, HID)}
            # cuDNN computes the input product too: its yardstick is the
            # matmul plus the kernel
            y_c, h_c = cudnn(xs, h0[None])
            y_k, h_k = gru_layer(xs, h0, w_ih, w_hh, b_ih, b_hh)
            row.update({
                "library_ms": cuda_ms(lambda: cudnn(xs, h0[None]), 20),
                "matmul_plus_kernel_ms": cuda_ms(lambda: gru_layer(
                    xs, h0, w_ih, w_hh, b_ih, b_hh), 20),
                "cudnn_max_abs_err": max((y_c - y_k).abs().max().item(),
                                         (h_c[0] - h_k).abs().max().item())})
            emit(row)
            rows["gru_sequence"][f"T48_B{B}"] = row
    bad = [r for k in rows.values() for r in k.values()
           if not r["max_abs_err"] <= TOL]
    if bad:
        raise AssertionError(f"kernels at the policies' shapes: {bad}")
    return rows


def policies_path(smi: str) -> tuple:
    """Decode mode at the bench widths under each policy, on the
    POLICY_REQUESTS_S requests (60 s): launches per request, the kernel path against the
    module path on the card, the card against the CPU at 60 s, request
    seconds and stages."""
    import torch

    from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
    from gesture2vec_tpu_torch.text.vocab import Vocab

    vocab = Vocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    trees = policy_trees(np.random.default_rng(0))
    pose_mean = np.zeros(DIM, np.float32)
    pose_std = np.ones(DIM, np.float32)

    def make(variant, device, kernels, options):
        gen = generator_from_jax(
            *trees[variant], vocab, pose_mean, pose_std, n_frames=N_FRAMES,
            sentence_frame_length=SENT_LEN, fps=FPS, max_words=MAXW,
            device=device, mode="decode", use_fused_decoder=kernels, seed=0,
            **options)
        gen.t2t_model.set_use_kernels(kernels)
        return gen

    enc = trees["gru"][0]["params"]["encoder"]["gru"]
    rows = policy_kernel_rows(
        make("tcn", "cuda", True, {})._folded,
        [torch.from_numpy(enc[f"l0_{n}"]).cuda()
         for n in ("w_ih", "w_hh", "b_ih", "b_hh")])
    launches = {}
    for name, variant, options in POLICIES:
        gen = make(variant, "cuda", True, options)
        reset_launches()
        outs, per_request = {}, {}
        for d in POLICY_REQUESTS_S:
            before = read_launches()
            outs[d] = gen.generate(words(d), d)
            per_request[d] = {k: v - before[k]
                              for k, v in read_launches().items()}
        launches[name] = read_launches()
        want = {d: {"chunk_decoder": len(outs[d][1])
                    if options.get("chunk_continuity") else 1,
                    "gru_sequence": 4 if variant == "gru" else 0,
                    "gru_sequence_backward": 0,
                    "vq_argmin": 0} for d in POLICY_REQUESTS_S}
        for d, (frames, toks) in outs.items():
            n_windows = int(np.ceil(d / (SENT_LEN / FPS)))
            if frames.shape != (n_windows * SENT_LEN, DIM) \
                    or not np.isfinite(frames).all():
                raise AssertionError(f"{name} {d} s: frames {frames.shape}")
        module = make(variant, "cuda", False, options)
        vs_module = {d: compare_runs(
            outs[d], module.generate(words(d), d),
            lambda d=d: token_margins(make(variant, "cuda", False, options),
                                      POLICY_REQUESTS_S)[d])
            for d in POLICY_REQUESTS_S}
        # the first request of a fresh generator on either side
        d = POLICY_REQUESTS_S[0]
        vs_cpu = compare_runs(
            outs[d], make(variant, "cpu", True, options).generate(
                words(d), d),
            lambda: token_margins(make(variant, "cpu", True, options),
                                  [d])[d])
        timing = {}
        for d in POLICY_REQUESTS_S:
            w = words(d)
            # one repeat of a long request and no stage split of it keep
            # the run in its budget
            long = d >= 1800
            req_s = best_s(lambda: gen.generate(w, d), reps=1 if long else 2)
            timing[d] = {"seconds": req_s,
                         "frames_per_s": outs[d][0].shape[0] / req_s,
                         "stages_s": None if long else stage_split(gen, d)}
        # profiled on the short request only (~45 s of profiler on the
        # long one's ~150k device ops)
        d = POLICY_REQUESTS_S[0]
        timing[d]["device_busy"] = device_busy(
            lambda: gen.generate(words(d), d), timing[d]["seconds"])
        emit({"phase": "policy", "policy": name, "model": variant,
              "options": options, "launches_per_request": per_request,
              "want": want, "kernel_vs_module": vs_module,
              "card_vs_cpu_60s": vs_cpu, "tol": TOL,
              "near_tie_margin": LOGIT_TIE, "timing": timing, "card": smi})
        if per_request != want or not vs_cpu["ok"] \
                or not all(c["ok"] for c in vs_module.values()):
            raise AssertionError(f"policy {name} failed its checks")
    return rows, launches


# -- the transformer models: the recipe's Part d, the transformer tokenizer --
def transformer_makers(rng: np.random.Generator):
    """Makers of random transformer variables in the JAX package's layout
    (numpy): dense(i, o), ln() and block(cross) at the bench width, drawn
    as the layers initialise (uniform in +-1/sqrt(fan_in); LayerNorm
    scale near 1)."""
    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, size=shape).astype(np.float32)

    def dense(i, o):
        return {"kernel": u((i, o), i), "bias": u((o,), i)}

    def ln():
        return {"scale": (1 + 0.1 * rng.normal(size=HID)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=HID)).astype(np.float32)}

    def block(cross):
        out = {"ln_self": ln(), "ln_mlp": ln(),
               "self_attn": {p: dense(HID, HID) for p in "qkvo"},
               "mlp_in": dense(HID, 4 * HID), "mlp_out": dense(4 * HID, HID)}
        if cross:
            out.update(ln_cross=ln(),
                       cross_attn={p: dense(HID, HID) for p in "qkvo"})
        return out

    return dense, ln, block


def recipe_trees(rng: np.random.Generator):
    """The recommended recipe's variables (numpy, JAX layout): the
    transformer Part d at the bench widths (2 layers, 5000 x 300 word
    table, 512 codes, 4 stages with the stage chain), and Part c's
    residual-VQ tokenizer and DAE (part_c_trees at seed 0), whose sweep is
    the exemplar bank."""
    dense, ln, block = transformer_makers(rng)
    stages = RVQ_ARGS["rvq_stages"]
    enc = {"embedding_table": rng.normal(size=(N_WORDS, WORDEMBED))
           .astype(np.float32), "embed_proj": dense(WORDEMBED, HID),
           "final_ln": ln(), **{f"layer_{i}": block(False) for i in range(L)}}
    dec = {"token_embedding": {"embedding": (rng.normal(size=(K, HID))
                                             / np.sqrt(HID))
                               .astype(np.float32)},
           "final_ln": ln(), "out_layer": dense(HID, K),
           **{f"layer_{i}": block(True) for i in range(L)},
           **{f"out_layer_r{s}": dense(HID, K) for s in range(1, stages)},
           **{f"stage_embed_{s}": {"embedding": (
               rng.normal(size=(K, HID)) / np.sqrt(HID)).astype(np.float32)}
              for s in range(stages - 1)}}
    dae, _, (rvq, rvq_stats) = part_c_trees(np.random.default_rng(0))
    return ({"params": {"encoder": enc, "decoder": dec}},
            {"params": rvq, "batch_stats": rvq_stats}, {"params": dae})


def recipe_path(smi: str, bank: dict) -> dict:
    """The recommended recipe through the weight bridge: decode mode on the
    RECIPE_REQUESTS_S requests (60 s) under each of RECIPE_POLICIES, and
    exemplar mode on the 60 s request against Part c's residual-VQ bank.
    At 60 s the kernel path is held against the module path on the card
    and the card against the CPU (fresh generators, first request)."""
    from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
    from gesture2vec_tpu_torch.models.transformer import \
        TransformerText2Token
    from gesture2vec_tpu_torch.text.vocab import Vocab

    vocab = Vocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    trees = recipe_trees(np.random.default_rng(0))
    pose_mean = np.zeros(DIM, np.float32)
    pose_std = np.ones(DIM, np.float32)

    def make(device, kernels, mode="decode", **options):
        gen = generator_from_jax(
            *trees, vocab, pose_mean, pose_std, n_frames=N_FRAMES,
            sentence_frame_length=SENT_LEN, fps=FPS, max_words=MAXW,
            t2t_n_pre_poses=RECIPE_N_PRE, t2t_heads=RECIPE_HEADS,
            device=device, mode=mode, use_fused_decoder=kernels, seed=0,
            latent_bank=bank if mode == "exemplar" else None, **options)
        if not isinstance(gen.t2t_model, TransformerText2Token):
            raise AssertionError("the recipe's Part d is not the transformer")
        return gen

    unit = SENT_LEN / FPS
    d60 = REQUESTS_S[1]
    launches = {}
    for name, options in RECIPE_POLICIES:
        gen = make("cuda", True, **options)
        reset_launches()
        outs, per_request = {}, {}
        for d in RECIPE_REQUESTS_S:
            before = read_launches()
            outs[d] = gen.generate(words(d), d)
            per_request[d] = {k: v - before[k]
                              for k, v in read_launches().items()}
        launches[name] = read_launches()
        want = {d: {"chunk_decoder": 1, "gru_sequence": 0,
                    "gru_sequence_backward": 0, "vq_argmin": 0}
                for d in RECIPE_REQUESTS_S}
        for d, (frames, toks) in outs.items():
            n_windows = int(np.ceil(d / unit))
            if frames.shape != (n_windows * SENT_LEN, DIM) \
                    or not np.isfinite(frames).all() \
                    or toks.shape != (n_windows * SENT_LEN // N_FRAMES,):
                raise AssertionError(f"recipe {name} {d} s: frames "
                                     f"{frames.shape}, tokens {toks.shape}")
        # at 60 s, the first request of fresh generators: the kernel path
        # against the module path on the card, and the card against the
        # CPU
        first = make("cuda", True, **options).generate(words(d60), d60)
        vs_module = compare_runs(
            first, make("cuda", False, **options).generate(words(d60), d60),
            lambda: token_margins(make("cuda", False, **options),
                                  [d60])[d60])
        vs_cpu = compare_runs(
            first, make("cpu", True, **options).generate(words(d60), d60),
            lambda: token_margins(make("cpu", True, **options), [d60])[d60])
        timing = {}
        for d in RECIPE_REQUESTS_S:
            w = words(d)
            long = d >= 1800
            req_s = best_s(lambda: gen.generate(w, d), reps=1 if long else 2)
            timing[d] = {"seconds": req_s,
                         "frames_per_s": outs[d][0].shape[0] / req_s,
                         "stages_s": None if long else stage_split(gen, d),
                         "launches": per_request[d]}
        # profiled on the 60 s request only
        timing[d60]["device_busy"] = device_busy(
            lambda: gen.generate(words(d60), d60), timing[d60]["seconds"])
        emit({"phase": "recipe", "policy": name, "options": options,
              "launches_per_request": per_request, "want": want,
              "kernel_vs_module_60s": vs_module, "card_vs_cpu_60s": vs_cpu,
              "tol": TOL, "near_tie_margin": LOGIT_TIE,
              "distinct_tokens_60s": int(len(np.unique(outs[d60][1]))),
              "timing": timing, "card": smi})
        if per_request != want or not vs_module["ok"] or not vs_cpu["ok"]:
            raise AssertionError(f"recipe {name} failed its checks")

    # -- exemplar mode at 60 s, the recipe's policy ---------------------
    gen = make("cuda", True, mode="exemplar", **RECIPE_POLICY)
    reset_launches()
    out = gen.generate(words(d60), d60)
    counts = read_launches()
    if any(counts.values()) or out[0].shape != (
            int(np.ceil(d60 / unit)) * SENT_LEN, DIM) \
            or not np.isfinite(out[0]).all():
        raise AssertionError(f"recipe exemplar: launches {counts}, frames "
                             f"{out[0].shape}")
    runs = {}
    for dev in ("cuda", "cpu"):
        g = make(dev, True, mode="exemplar", **RECIPE_POLICY)
        picks, pick = [], g._picks
        g._picks = lambda toks, pick=pick, picks=picks: \
            picks.append(pick(toks)) or picks[-1]
        runs[dev] = (g.generate(words(d60), d60), picks[0])
    cmp = compare_runs(runs["cuda"][0], runs["cpu"][0], lambda: token_margins(
        make("cpu", True, mode="exemplar", **RECIPE_POLICY), [d60])[d60])
    cmp["picks_identical"] = bool(np.array_equal(runs["cuda"][1],
                                                 runs["cpu"][1]))
    req_s = best_s(lambda: gen.generate(words(d60), d60), reps=2)
    emit({"phase": "recipe", "policy": "exemplar_" + RECIPE_POLICIES[1][0],
          "options": RECIPE_POLICY, "launches": counts,
          "want": "no kernel: transformer Part d, bank gather, DAE decode",
          "bank_windows": int(bank["tokens"].shape[0]),
          "card_vs_cpu_60s": cmp, "tol": TOL,
          "timing": {d60: {"seconds": req_s,
                           "frames_per_s": out[0].shape[0] / req_s,
                           "stages_s": stage_split(gen, d60),
                           "device_busy": device_busy(
                               lambda: gen.generate(words(d60), d60),
                               req_s)}}, "card": smi})
    if not cmp["ok"] or (cmp["tokens_identical"]
                         and not cmp["picks_identical"]):
        raise AssertionError(f"recipe exemplar card vs CPU: {cmp}")
    return {**launches, "exemplar": counts}


def tf_tokenizer_trees(rng: np.random.Generator):
    """Part c's GS-Soft and 4-stage residual-VQ tokenizers (quantizers and
    decoders of part_c_trees at seed 0) with a `seq_arch: transformer`
    chunk encoder in place of the BiGRU: ((params, stats), (params,
    stats))."""
    dense, ln, block = transformer_makers(rng)
    _, (vq, vq_stats), (rvq, rvq_stats) = part_c_trees(
        np.random.default_rng(0))

    def encoder():
        return {"in_layer": dense(REP, HID), "final_ln": ln(),
                "hidden_proj": dense(HID, L * HID),
                **{f"layer_{i}": block(False) for i in range(L)}}

    return (({**vq, "encoder": encoder()}, vq_stats),
            ({**rvq, "encoder": encoder()}, rvq_stats))


# -- training: g2v-train parts a, b and d ---------------------------------
def write_train_store(root: str, rng: np.random.Generator) -> list:
    """The training stores: smooth synthetic motion (sinusoids plus noise)
    135 wide with a word every 0.4 s (150 a minute), as [train, val]; then
    a copy of the first TRAIN_AUDIO_CLIPS train clips and of the
    validation clip with their speech-like audio at 16 kHz
    (synthetic_speech, seeded by the clip), as [train_audio, val_audio],
    which the audio Part d trains on (the other runs read stores without
    audio: a clip's 650 s of audio takes ~0.5 s to decompress)."""
    from gesture2vec_tpu_torch.data.store import ClipStoreWriter

    paths = {}
    for k, (name, n_clips, n_frames) in enumerate((
            ("train", TRAIN_CLIPS, TRAIN_FRAMES),
            ("val", 1, TRAIN_VAL_FRAMES))):
        writers = {sfx: ClipStoreWriter(os.path.join(root, name + sfx))
                   for sfx in ("", "_audio")}
        clips = {"": [], "_audio": []}
        for i in range(n_clips):
            t = np.arange(n_frames)[:, None] / FPS
            poses = (np.sin(t * rng.uniform(0.3, 2.0, DIM)
                            + rng.uniform(0, 2 * np.pi, DIM))
                     + 0.1 * rng.normal(size=(n_frames, DIM))
                     ).astype(np.float32)
            starts = np.arange(0.1, n_frames / FPS - 0.5, 0.4)
            clip_words = [
                [f"word{rng.integers(VOCAB_WORDS)}", float(s), float(s + 0.3)]
                for s in starts]
            writers[""].add_clip(f"{name}{i}", poses, clip_words)
            clips[""].append(poses)
            if name == "val" or i < TRAIN_AUDIO_CLIPS:
                writers["_audio"].add_clip(
                    f"{name}{i}", poses, clip_words, audio=synthetic_speech(
                        n_frames / FPS, 1000 * (k + 1) + i))
                clips["_audio"].append(poses)
        for sfx, w in writers.items():
            frames = np.concatenate(clips[sfx])
            w.set_stats(frames.mean(0), frames.std(0))
            w.set_meta(fps=FPS, feature_dim=DIM)
            w.finish()
            paths[name + sfx] = w.root
    return [paths[n] for n in ("train", "val", "train_audio", "val_audio")]


def write_train_config(path: str, shipped: str, overrides: dict) -> dict:
    """A shipped config (its widths as they are) with the paths and the
    cuts of TRAIN_RUNS, as a YAML file."""
    from gesture2vec_tpu_torch.train.config import parse_yaml

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", shipped)) as f:
        cfg = parse_yaml(f.read())
    cfg.update(overrides)
    with open(path, "w") as f:
        for k, v in cfg.items():
            v = json.dumps(v) if isinstance(v, str) else (
                str(v).lower() if isinstance(v, bool) else v)
            f.write(f"{k}: {v}\n")
    return cfg


def train_step_of(part: str, cfg, model, opt, variant: str = ""):
    """The trainer's own step object for a part: Part a's (variant
    "warmup": vq_tricks' delayed-VQ step), Part b's (the similarity step
    under use_similarity with labels), Part d's (variant "feedback": the
    feedback-matched finetune step), the baseline's and c2g's."""
    from gesture2vec_tpu_torch.train import dae_trainer as dt
    from gesture2vec_tpu_torch.train import seq_ae_trainer as st
    from gesture2vec_tpu_torch.train import text2token_trainer as tt

    if part == "a":
        return dt.TrainStep(model, opt, skip_vq=variant == "warmup")
    if part == "b":
        cls = st.SSLTrainStep if is_ssl(cfg) else st.TrainStep
        return cls(cfg, model, opt)
    if part == "audio":
        from gesture2vec_tpu_torch.train import audio2token_trainer as at
        return at.TrainStep(model, opt, cfg.label_smoothing)
    if part in ("baseline", "c2g"):
        from gesture2vec_tpu_torch.train import misc_trainers as mt
        cls = mt.BaselineStep if part == "baseline" else mt.C2GStep
        return cls(cfg, model, opt)
    if variant == "feedback":
        return tt.FeedbackTrainStep(model, opt, cfg.label_smoothing,
                                    cfg.feedback_temperature)
    return tt.TrainStep(model, opt, cfg.label_smoothing)


def is_ssl(cfg) -> bool:
    """Whether Part b trains the similarity-supervised step."""
    return bool(cfg.use_similarity and cfg.similarity_labels)


def write_labels(path: str, n_windows: int, rng: np.random.Generator) -> str:
    """SSL_LABEL_LINES similarity labels in the reference's format
    (annotator,left,middle,right,label,time) over n_windows windows, with
    every label."""
    with open(path, "w") as f:
        for i in range(SSL_LABEL_LINES):
            left, middle, right = rng.integers(0, n_windows, 3)
            label = ("left", "right", "neither")[i % 3]
            f.write(f"annotator{i % 4},{left},{middle},{right},{label},"
                    f"{rng.uniform(1, 9):.2f}\n")
    return path


def step_inputs(cfg, arrays, rows: np.ndarray, b: int) -> list:
    """A train step's inputs (numpy): the arrays' rows and, for the
    similarity step, 3 labelled pairs drawn as the trainer draws batch b's
    in epoch 0."""
    from gesture2vec_tpu_torch.data.similarity import (read_gesture_labels,
                                                       sample_pairs)

    out = [a[rows] for a in arrays]
    if is_ssl(cfg):
        pa, pb, pl = sample_pairs(
            read_gesture_labels(cfg.similarity_labels), 3,
            np.random.default_rng(max(cfg.random_seed, 0) + b),
            arrays[0].shape[0])
        out += [arrays[0][pa], arrays[0][pb], pl]
    return out


def fresh_model(part: str, cfg, n_words: int, device: str):
    """A part's model as its trainer builds and initialises it (the
    baseline's poses DIM wide, c2g's latents rep_learning_dim)."""
    import torch

    from gesture2vec_tpu_torch.train import dae_trainer as dt
    from gesture2vec_tpu_torch.train import seq_ae_trainer as st
    from gesture2vec_tpu_torch.train import text2token_trainer as tt

    dev = torch.device(device)
    if part == "a":
        return dt.init_model(dt.make_frame_model(cfg), 0, dev)
    if part == "b":
        return dt.init_model(st.make_seq_ae(cfg), 0, dev)
    if part == "audio":
        from gesture2vec_tpu_torch.train import audio2token_trainer as at
        return at.init_audio2token(at.make_audio2token(cfg, n_words), 0, dev)
    if part in ("baseline", "c2g"):
        from gesture2vec_tpu_torch.train import misc_trainers as mt
        model = (mt.make_baseline(cfg, n_words, DIM) if part == "baseline"
                 else mt.make_c2g(cfg, cfg.rep_learning_dim))
        return mt.init_misc(model, 0, dev)
    return tt.init_text2token(tt.make_text2token(cfg, n_words), 0, dev)


@contextlib.contextmanager
def kink_inputs(force: list | None = None):
    """Records, call by call, the inputs of torch.relu and torch.abs made
    inside (the kinks of a train step's subgradient) as (side of 0, |x|)
    on the host. With `force` (another run's records, call by call) each
    call takes that run's side of 0 instead of its own: relu(x) is x
    where the recorded side is positive, else 0, and |x| is x times the
    recorded sign, so values and subgradients follow the other run's
    choices."""
    import torch

    calls = []
    saved = torch.relu, torch.abs

    def recording(fn, side, forced):
        def wrapped(x, *a, **k):
            v = x.detach()
            calls.append((side(v).cpu(), v.abs().float().cpu()))
            if force is None:
                return fn(x, *a, **k)
            if len(calls) > len(force):
                raise AssertionError(f"more kink calls than the "
                                     f"{len(force)} to force")
            given = force[len(calls) - 1][0]
            if given.shape != v.shape:
                raise AssertionError(f"kink call {len(calls)}: shape "
                                     f"{tuple(v.shape)}, forced "
                                     f"{tuple(given.shape)}")
            return forced(x, given.to(x.device))
        return wrapped
    torch.relu = recording(
        saved[0], lambda v: v > 0,
        lambda x, pos: torch.where(pos, x, torch.zeros_like(x)))
    torch.abs = recording(saved[1], torch.sign,
                          lambda x, sign: x * sign.to(x.dtype))
    try:
        yield calls
    finally:
        torch.relu, torch.abs = saved


def kink_flips(cpu_calls: list, card_calls: list) -> dict:
    """Elements whose kink input lies on another side of 0 on the card
    than on the CPU, and the largest of their CPU values relative to the
    largest magnitude of its call."""
    if len(cpu_calls) != len(card_calls):
        raise AssertionError(f"{len(cpu_calls)} kink calls on the CPU, "
                             f"{len(card_calls)} on the card")
    flips, worst = 0, 0.0
    for (side_a, mag), (side_b, _) in zip(cpu_calls, card_calls):
        diff = side_a != side_b
        n = int(diff.sum())
        if n:
            flips += n
            worst = max(worst, float(mag[diff].max())
                        / max(float(mag.max()), 1e-30))
    return {"kink_flips": flips, "kink_max_ratio": worst}


@contextlib.contextmanager
def kernel_shapes():
    """Counts every kernel launch made inside by its shape: chunk_decoder
    (B, steps), gru_sequence, its training variant (gru_sequence_gates,
    also counted in gru_sequence's launches) and its backward (T, B, H),
    vq_argmin (N, K, D). It wraps the wrappers' private launch functions,
    so the wrappers' own launch counts stay as they are."""
    import collections

    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk
    from gesture2vec_tpu_torch.ops import vq_kernel as vk

    def gru_key(x_proj, *_):
        return (*x_proj.shape[:2], x_proj.shape[2] // 3)

    shapes = {name: collections.Counter()
              for name in (*launch_counters(), "gru_sequence_gates")}
    hooks = ((dk, "_launch", "chunk_decoder",
              lambda x0, h0, w, n: (x0.shape[0], n)),
             (gk, "_launch", "gru_sequence", gru_key),
             (gk, "_launch_gates", "gru_sequence_gates", gru_key),
             (gk, "_launch_backward", "gru_sequence_backward",
              lambda gates, *_: (*gates.shape[:2], gates.shape[2] // 4)),
             (vk, "_launch", "vq_argmin",
              lambda x, cb: (x.shape[0], cb.shape[0], x.shape[1])))
    saved = []
    for mod, attr, name, key in hooks:
        def recording(*args, _fn=getattr(mod, attr), _name=name, _key=key):
            shapes[_name][tuple(int(v) for v in _key(*args))] += 1
            return _fn(*args)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, recording)
    try:
        yield shapes
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def compared_shapes() -> dict:
    """Each kernel's shapes that the kernel phases hold against its plain
    version, keyed as kernel_shapes counts them."""
    gru = {(GRU_T, B, H) for B in (*GRU_BATCHES, *GRU_EDGE_BATCHES)
           for H in (HID, HID + 1)}
    gru |= {(MAXW, B, HID) for B in GRU_T48_BATCHES}
    gru |= {(T, B, HID) for T, B in AUDIO_GRU_SHAPES}
    bwd = {(T, B, HID) for T, B in GRU_BWD_SHAPES}
    return {"chunk_decoder": set(DECODER_SHAPES) | set(AUDIO_DECODER_SHAPES),
            "gru_sequence": gru | bwd,
            "gru_sequence_gates": bwd, "gru_sequence_backward": bwd,
            "vq_argmin": {(N, Kc, VQ_D) for N, Kc in VQ_SHAPES}
            | {(N, Kc, VQ_FRAME_D) for N, Kc in VQ_FRAME_SHAPES}}


def train_want_launches(part: str, run: str, cfg, n: int, m: int,
                        lloyd_steps: list) -> dict:
    """The launches a `cli/train` command must make, from its n train and
    m validation samples (full batches only) over its epochs: Part a's
    VQFrame one argmin a train step (none in vq_tricks' warmup epochs)
    and a validation batch, and a re-fit's Lloyd fit its steps + 1; Part
    b's BiGRU (and the audio Part d's encoder BiGRU) 4 forward a train
    step (12 in the similarity step) and a validation batch and 4
    backward a train step (12), the transformer encoder none; one chunk_decoder a
    validation batch, the residual VQ's argmins (one a stage) a step and
    a batch; a re-fit runs the BiGRU's layer 0 (2 launches) per 512
    windows and, per stage, a Lloyd fit (its steps + 1 argmins) and the
    residual's argmin. Part d's data runs the BiGRU tokenizer's layer 0
    (2) per 512 chunks of train and validation windows, and a residual
    one's argmins (one a stage) per 512, as does the audio Part d's; its
    GRU encoder launches as Part b's BiGRU does (the transformer Part d,
    teacher-forced or feedback, none)."""
    bs, epochs = cfg.batch_size, cfg.epochs
    steps, val = n // bs, m // bs
    want = {name: 0 for name in launch_counters()}
    bigru = part == "b" and cfg.extras.get("seq_arch") != "transformer"
    recurrent = bigru or part == "audio" or (
        cfg.extras.get("text_encoder") == "gru"
        and cfg.extras.get("t2t_arch") != "transformer")
    # the similarity step's forwards: the batch and two pairs
    forwards = 3 if part == "b" and is_ssl(cfg) else 1
    if recurrent:
        want["gru_sequence"] = 4 * (forwards * steps + val) * epochs
        want["gru_sequence_backward"] = 4 * forwards * steps * epochs
    if part == "a" and cfg.autoencoder_vq:
        # one argmin a VQ step (not in vq_tricks' warmup epochs) and a
        # validation batch; the re-fit's Lloyd fit its steps + 1
        start = TRAIN_TRICKS.get(run, {}).get("vq_start_epoch", 0)
        want["vq_argmin"] = steps * sum(1 for e in range(epochs)
                                        if e >= start) + val * epochs \
            + sum(s + 1 for s in lloyd_steps)
    if part == "b":
        want["chunk_decoder"] = val * epochs
    if part == "b" and cfg.autoencoder_vq \
            and cfg.autoencoder_vq_variant == "rvq":
        every = cfg.rvq_reestimate_every
        refits = sum(1 for e in range(1, epochs) if e % every == 0)
        if bigru:
            want["gru_sequence"] += 2 * (min(n, 20000) // 512) * refits
        want["vq_argmin"] = cfg.rvq_stages * (steps + val) * epochs + sum(
            s + 2 for s in lloyd_steps)
    if part in ("d", "audio"):
        chunks = cfg.sentence_frame_length // cfg.n_poses
        batches = -(-chunks * n // 512) - (-chunks * m // 512)
        want["gru_sequence"] += 2 * batches
        if cfg.token_stages > 1:
            want["vq_argmin"] += cfg.token_stages * batches
    return want


def train_measure(run: str, part: str, cfg, arrays, val_arrays,
                  n_words: int, variant: str = "") -> dict:
    """The trainer's steps (its first epoch's batches) on a fresh model
    (the variant's step: see train_step_of): launches per
    step and per validation batch, steps/s and samples/s over
    TRAIN_TIMED_STEPS steps, the forward / backward / optimizer split over
    5 steps, and the device's idle share and device ops per step over
    TRAIN_PROFILED_STEPS steps (torch.profiler, whose post-processing
    grows with the device ops it records: a Part-b step launches
    ~7,800)."""
    import torch

    from gesture2vec_tpu_torch.models.layers import dropout_generator
    from gesture2vec_tpu_torch.train import dae_trainer as dt
    from gesture2vec_tpu_torch.train import seq_ae_trainer as st
    from gesture2vec_tpu_torch.train import text2token_trainer as tt
    from gesture2vec_tpu_torch.train.optim import Adam
    from gesture2vec_tpu_torch.train.token_loop import to_device

    model = fresh_model(part, cfg, n_words, "cuda").train()
    opt = Adam(model.parameters(), cfg.learning_rate)
    step = train_step_of(part, cfg, model, opt, variant)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bs = cfg.batch_size
    n = arrays[0].shape[0]
    perm = np.random.default_rng(0).permutation(n)
    n_timed, n_prof = TRAIN_TIMED_STEPS[part], TRAIN_PROFILED_STEPS[part]
    epoch = [tuple(to_device(a, "cuda") for a in step_inputs(
                 cfg, arrays, perm[b * bs:(b + 1) * bs], b))
             for b in range(min(n // bs, n_timed + n_prof + 6))]
    # an epoch shorter than the steps measured (the recipe's 13) starts
    # over
    batches = [epoch[i % len(epoch)] for i in range(n_timed + n_prof + 6)]

    def run_steps(bb):
        for batch in bb:
            with dropout_generator(gen):
                step(*batch)

    reset_launches()
    run_steps(batches[:1])
    torch.cuda.synchronize()
    per_step = all_launches()
    model.eval()
    reset_launches()
    vb = tuple(to_device(a[:bs], "cuda") for a in val_arrays)
    if part == "a":
        dt.eval_step(model, *vb)
    elif part == "b":
        st.eval_step(cfg, model, *vb)
    elif part == "audio":
        from gesture2vec_tpu_torch.train import audio2token_trainer as at
        at.make_eval_step(model)(*vb)
    elif part in ("baseline", "c2g"):
        from gesture2vec_tpu_torch.train import misc_trainers as mt
        (mt.baseline_eval_step if part == "baseline"
         else mt.c2g_eval_step)(cfg, model, *vb)
    else:
        tt.make_eval_step(model)(*vb)
    torch.cuda.synchronize()
    per_val = all_launches()
    model.train()
    split = {"forward_ms": 0.0, "backward_ms": 0.0, "optimizer_ms": 0.0}
    for batch in batches[1:6]:
        opt.zero_grad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dropout_generator(gen):
            loss = step.loss(*batch)
        loss = loss[0] if isinstance(loss, tuple) else loss
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt_s in (("forward_ms", t1 - t0), ("backward_ms", t2 - t1),
                          ("optimizer_ms", t3 - t2)):
            split[key] += dt_s * 1e3 / 5
    timed = batches[6:6 + n_timed]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = batches[6 + n_timed:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(prof)
    torch.cuda.synchronize()
    busy = device_busy(lambda: run_steps(prof), time.perf_counter() - t0)
    busy["device_ops_per_step"] = busy["device_ops"] / max(len(prof), 1)
    return {"steps_per_epoch": n // bs, "batch": bs,
            "launches_per_step": per_step,
            "launches_per_val_batch": per_val,
            "timed_steps": len(timed), "steps_per_s": len(timed) / wall,
            "samples_per_s": len(timed) * bs / wall, "split_ms": split,
            "profiled_steps": len(prof), **busy}


def cancelled_grad(path: tuple, vq_frame: bool = False) -> bool:
    """Whether a parameter's gradient is rounding (zero in exact
    arithmetic): a bias in front of a batch-statistics BatchNorm through
    a linear map only (the decoders' pre_linear, the TCN's output layer,
    the VQFrame's encoder, the audio mel encoder's fc and bn2) or an
    attention's key bias, which its softmax cancels."""
    return path[-2:] in (("pre_linear", "bias"), ("k", "bias")) \
        or path == ("encoder", "decoder", "bias") \
        or (vq_frame and path == ("encoder", "bias")) \
        or path[-3:] in (("wav_encoder", "fc", "bias"),
                         ("wav_encoder", "bn2", "bias"))


def train_card_vs_cpu(part: str, cfg, arrays, n_words: int,
                      variant: str = "") -> dict:
    """One train step (the variant's: see train_step_of) from the same
    initial weights and batch on the card and on the CPU, every dropout
    off (a VAE samples its mean): the loss (relative), each gradient
    against the CPU's largest magnitude of that tensor (the tensors whose
    gradient is rounding against the largest gradient of the model: the
    biases that a batch-statistics BatchNorm cancels - the decoder's
    pre_linear, the VQFrame's encoder, the audio mel encoder's fc and
    bn2, whose outputs reach fc_bn through fc alone - and an attention's
    key bias, which its softmax cancels), and every buffer the step updates (the
    BatchNorm statistics, a VQFrame's EMA state) against the larger of 1
    and its largest magnitude. A VQFrame's codes may differ only at a
    near-tie of the CPU's distances (NEAR_TIE), and then the EMA state
    need not agree. The feedback step feeds back the rollout's own
    choices: where the card's and the CPU's differ, the step is a
    near-tie when the CPU's two best scores of some decision lie within
    LOGIT_TIE (then its loss and gradients need not agree). A ReLU's or an
    |x|'s input (custom_loss, the decoders) that lies on another side of
    0 on the card than on the CPU changes that element's subgradient:
    every such input's CPU value must lie within KINK_TIE of its call's
    largest magnitude, and the CPU step is then run again, from the same
    weights, on the card's sides of 0 (kink_inputs(force=...)); that
    run is held to the card as above ("grad_rel_err_unforced" keeps the
    first run's gradient error)."""
    import copy

    import torch

    from gesture2vec_tpu_torch.compat.from_jax import param_entries
    from gesture2vec_tpu_torch.models.dae import VQFrame
    from gesture2vec_tpu_torch.ops.vq_kernel import codebook_distances
    from gesture2vec_tpu_torch.train.optim import Adam
    from gesture2vec_tpu_torch.train.token_loop import to_device

    feedback = variant == "feedback"
    cpu = fresh_model(part, cfg, n_words, "cpu").train()
    card = copy.deepcopy(cpu).cuda().train()
    rerun = copy.deepcopy(cpu)
    vq_frame = isinstance(cpu, VQFrame)
    batch = step_inputs(cfg, arrays, np.arange(cfg.batch_size), 0)

    def run(m, dev: str, force: list | None = None) -> dict:
        step = train_step_of(part, cfg, m, Adam(m.parameters(), 1e-3),
                             variant)
        inputs = [to_device(a, dev) for a in batch]
        got = {}
        if vq_frame:
            # the quantizer's input and codes, before the EMA update
            cb = m.vq.codebook.detach().cpu().clone()
            def keep(mod, inp, out, cb=cb):
                got.setdefault("codes", (inp[0].detach().cpu(), cb,
                                         out.encodings.argmax(-1).cpu()))
            hook = m.vq.register_forward_hook(keep)
        with kink_inputs(force) as calls:
            loss = step.loss(*inputs)
        if vq_frame:
            hook.remove()
        loss = loss[0] if isinstance(loss, tuple) else loss
        loss.backward()
        got.update(
            loss=float(loss), kinks=calls,
            grads={path: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).detach().cpu()
                   for path, p, _, _ in param_entries(m)},
            buffers={name: b.detach().cpu()
                     for name, b in m.named_buffers()})
        if feedback:
            with torch.no_grad():
                res = m.eval()(*inputs[:3])
            m.train()
            got["choices"] = {k: res[k].cpu() for k in res
                              if k in ("tokens", "stage_tokens", "logits",
                                       "stage_logits")}
        return got

    def grad_err(ref: dict, other: dict) -> tuple:
        top = max(float(g.abs().max()) for g in ref.values())
        worst, where = 0.0, ""
        for path, g in ref.items():
            scale = top if cancelled_grad(path, vq_frame) \
                else float(g.abs().max())
            err = float((other[path] - g).abs().max()) / max(scale, 1e-30)
            if err > worst:
                worst, where = err, "/".join(path)
        return worst, where

    first, on_card = run(cpu, "cpu"), run(card, "cuda")
    flips = kink_flips(first["kinks"], on_card["kinks"])
    unforced = grad_err(first["grads"], on_card["grads"])[0]
    host = run(rerun, "cpu", on_card["kinks"]) if flips["kink_flips"] \
        else first
    worst, where = grad_err(host["grads"], on_card["grads"])
    buf_worst, buf_where = 0.0, ""
    for name, b in host["buffers"].items():
        if b.dtype.is_floating_point:
            err = float((on_card["buffers"][name] - b).abs().max()) / max(
                1.0, float(b.abs().max()))
            if err > buf_worst:
                buf_worst, buf_where = err, name
    losses = host["loss"], on_card["loss"]
    out = {"loss_cpu": losses[0], "loss_card": losses[1],
           "loss_rel_err": abs(losses[1] - losses[0]) / abs(losses[0]),
           "grad_rel_err": worst, "grad_worst": where,
           "buffer_rel_err": buf_worst, "buffer_worst": buf_where,
           **flips, "grad_rel_err_unforced": unforced}
    codes = [r["codes"] for r in (host, on_card) if "codes" in r]
    choices = [r["choices"] for r in (host, on_card) if "choices" in r]
    if codes:
        (x, cb, a), (_, _, b) = codes
        differ, ties = near_ties(codebook_distances(x, cb), a, b)
        out.update(codes_differing=differ, code_near_ties=ties,
                   near_tie=differ > 0 and differ == ties)
    if feedback:
        same = all(torch.equal(choices[0][k], choices[1][k])
                   for k in ("tokens", "stage_tokens") if k in choices[0])
        gaps = [torch.topk(choices[0][k], 2, dim=-1).values.diff(dim=-1)
                .abs().min().item()
                for k in ("logits", "stage_logits") if k in choices[0]]
        out.update(feedback_choices_equal=same,
                   near_tie=not same and min(gaps) <= LOGIT_TIE,
                   min_decision_margin=min(gaps))
    return out


def train_path(smi: str, tmp: str, done: dict) -> tuple:
    """`cli/train.main()` for part a (the DAE, the VQFrame, the VAEFrame,
    and the VQFrame with VAE heads through `train_dae(vq_tricks=True)`),
    part b (GS-Soft, residual VQ, residual VQ with the transformer chunk
    encoder, the VAE tokenizer over the VQFrame's latents, the plain
    autoencoder, the similarity-supervised step) and part d (TCN, GRU
    encoder, then the recommended recipe's transformer with its feedback
    epoch) at the shipped configs' widths, each run's launches, speed and
    losses; then the checks. Fills `done` with what the bf16 and stream
    phases train over: the store root and stores, the checkpoints and
    the runs' rows."""
    import glob

    import torch

    from gesture2vec_tpu_torch.cli import train as cli_train
    from gesture2vec_tpu_torch.cli._common import build_generator
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.infer.audio2gesture import \
        AudioGestureGenerator
    from gesture2vec_tpu_torch.train import dae_trainer as dt
    from gesture2vec_tpu_torch.train import seq_ae_trainer as st
    from gesture2vec_tpu_torch.train.config import load_config

    bwd_rows = gru_backward_rows()
    root = os.path.join(tmp, "training")
    stores = write_train_store(root, np.random.default_rng(9))
    ckpts, runs, counts, gates_launches = {}, {}, {}, {}
    done.update(root=root, stores=stores, ckpts=ckpts, runs=runs)
    # the command's own data (cli/train.build_arrays), the re-fits' Lloyd
    # steps and the launches before and during a Part-a re-fit, recorded
    # as the command runs
    build, built = cli_train.build_arrays, {}
    lloyd, lloyd_steps = st.lloyd, []
    refit, refit_launches = dt.reestimate_codebook, []

    def recording_build(*args):
        built["out"] = build(*args)
        return built["out"]

    def recording_lloyd(*args, **kw):
        out = lloyd(*args, **kw)
        lloyd_steps.append(out[3])
        return out

    def recording_refit(*args, **kw):
        torch.cuda.synchronize()
        before = read_launches()
        refit(*args, **kw)
        torch.cuda.synchronize()
        after = read_launches()
        refit_launches.append((before, {k: after[k] - before[k]
                                        for k in after}))

    with kernel_shapes() as shapes:
        for run, part, shipped, cuts in TRAIN_RUNS:
            cfg_path = os.path.join(root, f"{run}.yml")
            save = os.path.join(root, "out", run)
            labels = {}
            if cuts.get("use_similarity"):
                # over the run's windows
                n_win = TRAIN_CLIPS * ((TRAIN_FRAMES - N_FRAMES)
                                       // cuts["subdivision_stride"] + 1)
                labels["similarity_labels"] = write_labels(
                    os.path.join(root, "gesture_labels.txt"), n_win,
                    np.random.default_rng(10))
            write_train_config(cfg_path, shipped, {
                # the audio Part d's stores carry the clips' speech
                "train_data_path": stores[2 if part == "audio" else 0],
                "val_data_path": stores[3 if part == "audio" else 1],
                "model_save_path": save, **cuts, **labels})
            argv = ["-c", cfg_path, "--part", part, "--save-dir", save]
            if part != "a":
                argv += ["--rep-checkpoint", ckpts[TRAIN_REPS.get(run, "a")]]
            if part in ("d", "audio"):
                argv += ["--autoencoder-checkpoint",
                         ckpts[TRAIN_TEACHERS[run]]]
            lloyd_steps.clear()
            refit_launches.clear()
            cli_train.build_arrays, st.lloyd, dt.lloyd = recording_build, \
                recording_lloyd, recording_lloyd
            dt.reestimate_codebook = recording_refit
            reset_launches()
            gates_before = sum(shapes["gru_sequence_gates"].values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                if run in TRAIN_TRICKS:
                    # the command has no vq_tricks flag: its data step,
                    # then the trainer
                    tcfg, (tr, va), _ = cli_train.build_arrays(
                        load_config(cfg_path), part, torch.device("cuda"))
                    _, hist = dt.train_dae(tcfg, tr, va, save_dir=save,
                                           device="cuda", **TRAIN_TRICKS[run])
                else:
                    _, hist = cli_train.main(argv)
                torch.cuda.synchronize()
            finally:
                cli_train.build_arrays, st.lloyd, dt.lloyd = build, lloyd, \
                    lloyd
                dt.reestimate_codebook = refit
            wall = time.perf_counter() - t0
            counts[run] = read_launches()
            # the forward's training variant: one launch for each backward
            gates_launches[run] = sum(
                shapes["gru_sequence_gates"].values()) - gates_before
            ckpts[run] = sorted(glob.glob(os.path.join(save, "*.bin")))[-1]
            cfg, (train, val), kw = built.pop("out")
            if part in ("d", "audio"):
                fields = (("mel", "tokens") if part == "audio" else
                          ("word_ids", "lengths", "tokens")) + (
                    ("stage_tokens",) if cfg.token_stages > 1 else ())
                train, val = (tuple(d[f] for f in fields)
                              for d in (train, val))
            else:
                train, val = (train,), (val,)
            n_words = kw.get("n_words", 0)
            row = {"phase": "train", "run": run, "part": part,
                   "config": f"configs/{shipped}", "cuts": cuts,
                   "cli_s": wall, "launches": counts[run],
                   "gates_launches": gates_launches[run],
                   "want_launches": train_want_launches(
                       part, run, cfg, train[0].shape[0], val[0].shape[0],
                       lloyd_steps),
                   "lloyd_steps": list(lloyd_steps),
                   "train_samples": int(train[0].shape[0]),
                   "val_samples": int(val[0].shape[0]),
                   "first_step_loss": hist["first_step_loss"][0],
                   "epoch_loss": hist["train_loss"],
                   "val_loss": hist["val_loss"],
                   # steps/s, the split and the idle share: a separate
                   # loop over the first epoch's batches on a fresh model
                   **train_measure(run, part, cfg, train, val, n_words),
                   "card_vs_cpu": train_card_vs_cpu(part, cfg, train,
                                                    n_words)}
            if refit_launches:
                # vq_tricks: the launches of the warmup epochs (and their
                # validation), of the re-fit, and of the epochs after it
                before, during = refit_launches[0]
                total = counts[run]
                row["epoch_launches"] = {
                    "before_refit": before, "refit": during,
                    "after_refit": {k: total[k] - before[k] - during[k]
                                    for k in total}}
            variants = (("feedback",) if cfg.feedback_finetune_epochs
                        else ("warmup",) if run in TRAIN_TRICKS else ())
            for variant in variants:
                # the feedback-matched finetune step, or vq_tricks' warmup
                # step, measured alike
                row[variant] = {
                    **train_measure(run, part, cfg, train, val, n_words,
                                    variant=variant),
                    "card_vs_cpu": train_card_vs_cpu(part, cfg, train,
                                                     n_words, variant)}
            emit(row)
            runs[run] = row

        # -- check ---------------------------------------------------------
        problems = []
        for run, row in runs.items():
            if row["launches"] != row["want_launches"]:
                problems.append(f"{run}: the command launched "
                                f"{row['launches']}, want "
                                f"{row['want_launches']}")
            if row["gates_launches"] != \
                    row["launches"]["gru_sequence_backward"]:
                problems.append(f"{run}: {row['gates_launches']} launches "
                                f"of the forward's training variant for "
                                f"{row['launches']['gru_sequence_backward']}"
                                f" of the backward")
            steps = {run: row}
            for variant in ("feedback", "warmup"):
                if variant in row:
                    steps[f"{run}_{variant}"] = row[variant]
            for name, measured in steps.items():
                want = {k: 0 for k in all_launches()}
                want.update(TRAIN_STEP_LAUNCHES[name])
                if measured["launches_per_step"] != want:
                    problems.append(f"{name}: launches per step "
                                    f"{measured['launches_per_step']}, "
                                    f"want {want}")
                cvc = measured["card_vs_cpu"]
                if cvc.get("near_tie"):
                    continue
                if not cvc["loss_rel_err"] <= TOL or \
                        not cvc["grad_rel_err"] <= TOL or \
                        not cvc["buffer_rel_err"] <= TOL or \
                        not cvc["kink_max_ratio"] <= KINK_TIE:
                    problems.append(f"{name}: card vs CPU {cvc}")
            if row["part"] == "b" and row["launches_per_val_batch"][
                    "chunk_decoder"] < 1:
                problems.append(f"{run}: validation launched no "
                                f"chunk_decoder")
            if row["part"] == "a" and row["launches_per_val_batch"][
                    "vq_argmin"] != int("vq_argmin" in TRAIN_STEP_LAUNCHES[
                        run]):
                problems.append(f"{run}: launches per validation batch "
                                f"{row['launches_per_val_batch']}")
            if run in TRAIN_TRICKS:
                cfg = load_config(os.path.join(root, f"{run}.yml"))
                n, m = row["train_samples"], row["val_samples"]
                val_b, steps_b = m // cfg.batch_size, n // cfg.batch_size
                want_epochs = {
                    "before_refit": val_b, "refit": sum(
                        s + 1 for s in row["lloyd_steps"]),
                    "after_refit": steps_b + val_b}
                got_epochs = {k: v["vq_argmin"] for k, v in row.get(
                    "epoch_launches", {}).items()}
                if got_epochs != want_epochs:
                    problems.append(f"{run}: vq_argmin launches by phase "
                                    f"{got_epochs}, want {want_epochs}")
            losses = [row["first_step_loss"], *row["epoch_loss"],
                      *row["val_loss"]]
            if not all(np.isfinite(losses)) or not \
                    row["epoch_loss"][-1] < row["first_step_loss"]:
                problems.append(f"{run}: losses {losses}")
        gens = {}
        for name, t2t_run, dae_run, tok_run in TRAIN_GENERATORS:
            gen, _ = build_generator(ckpts[t2t_run], ckpts[dae_run],
                                     ckpts[tok_run], ClipStore(stores[0]),
                                     mode="decode")
            reset_launches()
            frames, tokens = gen.generate(words(6.0), 6.0)
            torch.cuda.synchronize()
            got = read_launches()
            gens[name] = {"checkpoints": [t2t_run, dae_run, tok_run],
                          "dae": type(gen.dae_model).__name__,
                          "frames": list(frames.shape),
                          "finite": bool(np.isfinite(frames).all()),
                          "launches": got}
            if frames.shape != (int(6.0 * FPS), DIM) or not \
                    gens[name]["finite"] or got["chunk_decoder"] != 1:
                problems.append(f"{name}: generator {gens[name]}")
        # the audio Part d's checkpoint over its tokenizer and DAE, as
        # cli/infer_audio loads them: 6 s of speech, one window
        store = ClipStore(stores[0])
        gen = AudioGestureGenerator(
            a2t_model=load_checkpoint_and_model(ckpts["d_audio"],
                                                "audio2token")[0],
            seq_decoder=load_checkpoint_and_model(
                ckpts[TRAIN_TEACHERS["d_audio"]], "autoencoder_vq")[0]
            .decoder,
            dae_model=load_checkpoint_and_model(ckpts["a"], "DAE")[0],
            pose_mean=store.pose_mean, pose_std=store.pose_std,
            n_frames=N_FRAMES, sentence_frame_length=SENT_LEN, fps=FPS)
        reset_launches()
        frames, tokens = gen.generate(synthetic_speech(6.0, 3))
        torch.cuda.synchronize()
        got = read_launches()
        gens["d_audio"] = {"checkpoints": ["d_audio", "a",
                                           TRAIN_TEACHERS["d_audio"]],
                           "frames": list(frames.shape),
                           "finite": bool(np.isfinite(frames).all()),
                           "launches": got}
        if frames.shape != (SENT_LEN, DIM) or not gens["d_audio"]["finite"] \
                or got["chunk_decoder"] != 1 or got["gru_sequence"] != 4:
            problems.append(f"d_audio: generator {gens['d_audio']}")
    # every shape the path gave a kernel, held against its plain version
    # in a kernel phase
    compared = compared_shapes()
    seen = {name: sorted(c.items()) for name, c in shapes.items()}
    for name, counter in shapes.items():
        missing = sorted(set(counter) - compared[name])
        if missing:
            problems.append(f"{name}: shapes {missing} not compared with "
                            f"the plain version")
    emit({"phase": "check", "path": "train", "generators": gens,
          "card_vs_cpu": {r: row["card_vs_cpu"] for r, row in runs.items()},
          "feedback_card_vs_cpu": {r: row["feedback"]["card_vs_cpu"]
                                   for r, row in runs.items()
                                   if "feedback" in row},
          "warmup_card_vs_cpu": {r: row["warmup"]["card_vs_cpu"]
                                 for r, row in runs.items()
                                 if "warmup" in row},
          "kernel_shapes": {name: [[list(k), v] for k, v in c]
                            for name, c in seen.items()},
          "tol": TOL, "problems": problems})
    if problems:
        raise AssertionError(f"train check failed: {problems}")
    main_row = next(r for r in bwd_rows if r["T"] == 20 and r["B"] == 128
                    and not r["reverse"])
    gates_row = main_row["forward_gates_bound"]
    entry = {"name": "gru_sequence_backward", "route": "cuda",
             "source": "gesture2vec_tpu_torch/csrc/gru_sequence_backward.cu",
             "replaces": "gesture2vec_tpu/ops/gru_pallas.py:60",
             "replaces_note": "its gradient: the JAX package has no "
                              "Pallas backward and differentiates the "
                              "lax.scan",
             "status": "ported, then redesigned: reads the gates the "
                       "forward's training variant saved, one product a "
                       "step",
             "launches": sum(c["gru_sequence_backward"]
                             for c in counts.values()),
             "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
             "max_rel_err": max(max(*r["rel_err_vs_plain"].values(),
                                    *r["rel_err_vs_autograd"].values())
                                for r in bwd_rows),
             "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
             "bound_ms": main_row["bound_ms"],
             "bound_by": main_row["bound_by"],
             "library_ms": main_row["library_ms"],
             "recompute_bound_ms": main_row["recompute_bound_ms"],
             "by_shape": {f"T{r['T']}_B{r['B']}": {k: r.get(k) for k in (
                 "ms", "plain_ms", "bound_ms", "recompute_bound_ms",
                 "library_ms", "function_backward_ms",
                 "function_round_trip_ms", "library_round_trip_ms",
                 "forward_ms", "forward_gates_ms")}
                 for r in bwd_rows if not r["reverse"]},
             # the forward's training variant (csrc/gru_sequence.cu's
             # g2v_gru_sequence_gates), whose launches the train path also
             # counts as gru_sequence's
             "forward_variant": {
                 "name": "gru_sequence_gates", "route": "cuda",
                 "source": "gesture2vec_tpu_torch/csrc/gru_sequence.cu",
                 "replaces": "gesture2vec_tpu/ops/gru_pallas.py:60",
                 "launches": sum(gates_launches.values()),
                 "max_abs_err": max(r["gates_max_abs_err"]
                                    for r in bwd_rows),
                 "ms": main_row["forward_gates_ms"],
                 "plain_ms": main_row["forward_gates_plain_ms"],
                 "bound_ms": gates_row["bound_ms"],
                 "bound_by": gates_row["bound_by"],
                 "library_ms": main_row["library_forward_ms"],
                 "inference_ms": main_row["forward_ms"]}}
    return entry, counts


# -- compute_dtype: bfloat16, and the streaming source -------------------
def bf16_bound_ms(flops: float, values: float) -> dict:
    """The least time for bf16 work: 2 bytes a value at the memory rate
    against the operations at the card's bf16 tensor-core peak (its rate
    for bf16 operands with fp32 accumulation). Beside it
    `cuda_core_bound_ms`, the same with the operations at the fp32
    CUDA-core peak: the units the bf16 instantiations multiply on today,
    not a bound of the work."""
    nbytes = 2.0 * values
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "cuda_core_bound_ms": bound(flops, nbytes)["bound_ms"]}


def bf16_gru_values(T: int, B: int, H: int, gates: bool) -> float:
    """x_proj, h0, w_hh, b_hh in; outputs, last hidden (and the gates)
    out."""
    return (T * B * 3 * H + B * H + 3 * H * H + 3 * H + T * B * H + B * H
            + (T * B * 4 * H if gates else 0))


def bf16_kernel_rows() -> dict:
    """Each bf16 instantiation against its bf16 plain version on the card
    at the main path's shapes (BF16_GRU_SHAPES, both directions;
    TRAIN_VAL_DECODE), within BF16_TOL of the largest magnitude (fp32 sums
    in another order flip a bf16 rounding now and then, and the
    recurrence carries it): CUDA-event times of the kernel, its plain
    version and the fp32 kernel on the same values in fp32 (in turns:
    bf16, fp32, fp32, bf16), the bound (bf16_bound_ms) and, for the GRU,
    cuDNN's bf16 GRU layer (input product included) and its backward as
    the library yardsticks. Returns {kernel: {shape: row}}."""
    import torch

    from gesture2vec_tpu_torch.models.gru import gru_layer
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    g = torch.Generator(device="cuda").manual_seed(14)
    H, bf = HID, torch.bfloat16
    bnd = 1.0 / H ** 0.5

    def uni(*s):
        return (torch.rand(s, device="cuda", generator=g) * 2 - 1) * bnd

    w_ih, w_hh, b_ih, b_hh = uni(3 * H, H), uni(3 * H, H), uni(3 * H), \
        uni(3 * H)
    cudnn = torch.nn.GRU(H, H, 1).cuda()
    with torch.no_grad():
        for p, v in ((cudnn.weight_ih_l0, w_ih), (cudnn.weight_hh_l0, w_hh),
                     (cudnn.bias_ih_l0, b_ih), (cudnn.bias_hh_l0, b_hh)):
            p.copy_(v)
    cudnn = cudnn.to(bf)
    rows = {"gru_sequence_bf16": {}, "gru_sequence_gates_bf16": {},
            "gru_sequence_backward_bf16": {}, "chunk_decoder_bf16": {}}

    def in_turns(a, b, iters=20):
        t = [cuda_ms(f, iters) for f in (a, b, b, a)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    for T, B in BF16_GRU_SHAPES:
        xs = torch.randn(T, B, H, device="cuda", generator=g)
        h0 = 0.5 * torch.randn(B, H, device="cuda", generator=g)
        x_proj = (xs.reshape(-1, H) @ w_ih.t() + b_ih).reshape(T, B, -1)
        dys = torch.randn(T, B, H, device="cuda", generator=g)
        dhl = torch.randn(B, H, device="cuda", generator=g)
        f32 = (x_proj, h0, w_hh, b_hh)
        b16 = tuple(t.to(bf).contiguous() for t in f32)
        d16 = (dys.to(bf), dhl.to(bf))
        for reverse in (False, True):
            key = f"T{T}_B{B}" + ("_reverse" if reverse else "")
            with torch.no_grad():
                ys, h = gk.gru_sequence(*b16, reverse)
                ys_g, h_g, gates = gk.gru_sequence_gates(*b16, reverse)
                ys_p, h_p, gates_p = gk.gru_sequence_gates_plain(*b16,
                                                                 reverse)
                _, _, gates32 = gk.gru_sequence_gates(*f32, reverse)
                bwd = (gates, b16[1], b16[2], ys, *d16, reverse)
                got = gk.gru_sequence_backward(*bwd)
                want = gk.gru_sequence_backward_plain(
                    gates_p, b16[1], b16[2], ys_p, *d16, reverse)
                ys32 = gk.gru_sequence(*f32, reverse)[0]
                bwd32 = (gates32, h0, w_hh, ys32, dys, dhl, reverse)
                errs = {"ys": rel_err(ys.float(), ys_p.float()),
                        "h_last": rel_err(h.float(), h_p.float()),
                        "gates": rel_err(gates.float(), gates_p.float()),
                        **{n: rel_err(a.float(), b.float()) for n, a, b in
                           zip(("dx_proj", "dgh", "dh0"), got, want)}}
                bitwise = bool(torch.equal(ys, ys_g)
                               and torch.equal(h, h_g))
                fwd_ms, fwd32_ms = in_turns(
                    lambda: gk.gru_sequence(*b16, reverse),
                    lambda: gk.gru_sequence(*f32, reverse))
                gates_ms, gates32_ms = in_turns(
                    lambda: gk.gru_sequence_gates(*b16, reverse),
                    lambda: gk.gru_sequence_gates(*f32, reverse))
                bwd_ms, bwd32_ms = in_turns(
                    lambda: gk.gru_sequence_backward(*bwd),
                    lambda: gk.gru_sequence_backward(*bwd32))
                common = {"phase": "kernel", "T": T, "B": B, "H": H,
                          "reverse": reverse, "dtype": "bfloat16",
                          "rel_err_vs_plain": errs, "tol": BF16_TOL,
                          "ys_bitwise_equal_to_inference": bitwise}
                fwd_row = {**common, "kernel": "gru_sequence_bf16",
                           "launch": gk.launch_shape(B, H, dtype=bf),
                           "max_abs_err": max(
                               (ys.float() - ys_p.float()).abs().max()
                               .item(), (h.float() - h_p.float()).abs()
                               .max().item()),
                           "ms": fwd_ms, "fp32_ms": fwd32_ms,
                           "plain_ms": cuda_ms(lambda: gk.gru_sequence_plain(
                               *b16, reverse), 5),
                           **bf16_bound_ms(2.0 * T * B * H * 3 * H,
                                           bf16_gru_values(T, B, H, False))}
                gates_row = {**common, "kernel": "gru_sequence_gates_bf16",
                             "max_abs_err": (gates.float() - gates_p.float())
                             .abs().max().item(),
                             "ms": gates_ms, "fp32_ms": gates32_ms,
                             "plain_ms": cuda_ms(
                                 lambda: gk.gru_sequence_gates_plain(
                                     *b16, reverse), 5),
                             **bf16_bound_ms(2.0 * T * B * H * 3 * H,
                                             bf16_gru_values(T, B, H, True))}
                bwd_row = {**common, "kernel": "gru_sequence_backward_bf16",
                           "launch": gk.backward_launch_shape(B, H,
                                                              dtype=bf),
                           "max_abs_err": max(
                               (a.float() - b.float()).abs().max().item()
                               for a, b in zip(got, want)),
                           "ms": bwd_ms, "fp32_ms": bwd32_ms,
                           "plain_ms": cuda_ms(
                               lambda: gk.gru_sequence_backward_plain(
                                   gates_p, b16[1], b16[2], ys_p, *d16,
                                   reverse), 5),
                           **bf16_bound_ms(
                               2.0 * T * B * 3 * H * H,
                               T * B * 4 * H + 2 * B * H + 3 * H * H
                               + 2 * T * B * H + 2 * T * B * 3 * H + B * H)}
                if not reverse:
                    xs16, h016 = xs.to(bf), h0[None].to(bf)
                    fwd_row["library_ms"] = cuda_ms(
                        lambda: cudnn(xs16, h016), 20)
                    fwd_row["matmul_plus_kernel_ms"] = cuda_ms(
                        lambda: gru_layer(xs, h0, w_ih, w_hh, b_ih, b_hh,
                                          dtype=bf), 20)
                    gates_row["library_ms"] = fwd_row["library_ms"]
            if not reverse:
                # cuDNN's backward of one bf16 layer on the same weights
                xs_l = xs.to(bf).requires_grad_()
                h0_l = h0[None].to(bf).requires_grad_()
                y_c, h_c = cudnn(xs_l, h0_l)
                params = [xs_l, h0_l, *cudnn.parameters()]
                bwd_row["library_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(
                        (y_c, h_c), params, (d16[0], d16[1][None]),
                        retain_graph=True), 20)
            for row in (fwd_row, gates_row, bwd_row):
                row.setdefault("library_ms", None)
                emit(row)
                rows[row["kernel"]][key] = row
            worst = max(errs.values())
            if not np.isfinite(worst) or worst > BF16_TOL or not bitwise:
                raise AssertionError(f"bf16 GRU kernels {key}: {errs}, ys "
                                     f"bitwise equal to the inference "
                                     f"launch: {bitwise}")
    # the chunk decoder over a bf16-folded decoder step (eval BatchNorm
    # with non-trivial statistics), Part-b validation's shape
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
    dec = SeqDecoder(REP, H, L, N_FRAMES, 8, dtype=bf).cuda().eval()
    with torch.no_grad():
        for prm in dec.parameters():
            prm.copy_(uni(*prm.shape))
        bn = dec.decoder_step.pre_bn
        bn.running_mean.copy_(0.1 * torch.randn(H, device="cuda",
                                                generator=g))
        bn.running_var.copy_(torch.rand(H, device="cuda", generator=g)
                             + 0.5)
    B, n = TRAIN_VAL_DECODE
    w16 = dk.fold_decoder_step(dec.decoder_step, bf)
    w32 = dk.fold_decoder_step(dec.decoder_step)
    x0 = torch.randn(B, REP, device="cuda", generator=g)
    h0 = 0.5 * torch.randn(L, B, H, device="cuda", generator=g)
    a16 = (x0.to(bf), h0.to(bf), w16, n)
    with torch.no_grad():
        ys = dk.fused_chunk_decode(*a16)
        ys_p = dk.fused_chunk_decode_plain(*a16)
        err = rel_err(ys.float(), ys_p.float())
        ms, ms32 = in_turns(lambda: dk.fused_chunk_decode(*a16),
                            lambda: dk.fused_chunk_decode(x0, h0, w32, n))
        plain_ms = cuda_ms(lambda: dk.fused_chunk_decode_plain(*a16), 5)
    cb = chunk_decoder_bound_ms(B, REP, H, n)
    row = {"phase": "kernel", "kernel": "chunk_decoder_bf16", "B": B,
           "steps": n, "H": H, "D": REP, "dtype": "bfloat16",
           "launch": dk.launch_shape(B, H, REP, dtype=bf),
           "max_abs_err": (ys.float() - ys_p.float()).abs().max().item(),
           "rel_err_vs_plain": err, "tol": BF16_TOL, "ms": ms,
           "fp32_ms": ms32, "plain_ms": plain_ms, "library_ms": None,
           **bf16_bound_ms(cb["flops"], cb["bytes"] / 4.0)}
    emit(row)
    rows["chunk_decoder_bf16"][f"B{B}_steps{n}"] = row
    if not np.isfinite(err) or err > BF16_TOL:
        raise AssertionError(f"chunk_decoder_bf16: relative error {err}")
    return rows


def bf16_card_vs_cpu(part: str, cfg, cfg32, arrays, n_words: int,
                     variant: str = "") -> dict:
    """One bf16 train step (the variant's) on the card and on the CPU
    from the same initial weights, every dropout off, on each of the
    first BF16_CARD_BATCHES batches: the two run the same bf16 math (the
    CPU through the kernels' bf16 plain versions), so the card's loss and
    each gradient (in norm, against the CPU bf16 gradient's norm) are
    held to the CPU bf16 step's; the gradients that a batch-statistics BatchNorm or a softmax cancels (see
    train_card_vs_cpu) are measured against the largest norm. Beside
    them, as statistics only, the first batch's CPU fp32 step: each bf16
    step's distance from it. Limits: BF16_CARD_LOSS_TOL on the loss,
    BF16_CARD_TOL on each gradient, BF16_CARD_MEDIAN_TOL on their
    median."""
    import copy

    import torch

    from gesture2vec_tpu_torch.compat.from_jax import param_entries
    from gesture2vec_tpu_torch.train.optim import Adam
    from gesture2vec_tpu_torch.train.token_loop import to_device

    cpu16 = fresh_model(part, cfg, n_words, "cpu").train()
    card = copy.deepcopy(cpu16).cuda().train()
    cpu32 = fresh_model(part, cfg32, n_words, "cpu").train()

    def run(m, c, dev: str, batch):
        m.zero_grad(set_to_none=True)
        step = train_step_of(part, c, m, Adam(m.parameters(), 1e-3), variant)
        loss = step.loss(*[to_device(a, dev) for a in batch])
        loss = loss[0] if isinstance(loss, tuple) else loss
        loss.backward()
        return float(loss), {
            path: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().cpu().double() for path, p, _, _ in param_entries(m)}

    def norm_dist(got, want, top, path):
        scale = top if cancelled_grad(path) else float(want.norm())
        return float((got - want).norm()) / scale if scale else \
            float(got.norm())

    out = {"tol": {"loss": BF16_CARD_LOSS_TOL, "grad": BF16_CARD_TOL,
                   "grad_median": BF16_CARD_MEDIAN_TOL}, "batches": []}
    for b in range(BF16_CARD_BATCHES):
        batch = step_inputs(cfg, arrays, np.arange(b * cfg.batch_size,
                                                   (b + 1) * cfg.batch_size),
                            b)
        l16, g16 = run(cpu16, cfg, "cpu", batch)
        lc, gc = run(card, cfg, "cuda", batch)
        top = max(float(g.norm()) for g in g16.values())
        dist = {path: norm_dist(gc[path], g, top, path)
                for path, g in g16.items()}
        worst = max(dist, key=dist.get)
        read = {"loss_cpu": l16, "loss_card": lc,
                "loss_rel_err": abs(lc - l16) / abs(l16),
                "grad_worst": {"path": "/".join(worst),
                               "rel_err": dist[worst]},
                "grad_median": float(np.median(list(dist.values())))}
        if b == 0:
            l32, g32 = run(cpu32, cfg32, "cpu", batch)
            top32 = max(float(g.norm()) for g in g32.values())
            read["vs_fp32"] = {
                "loss_fp32": l32,
                "cpu_bf16_grad_worst": max(norm_dist(g16[p], g, top32, p)
                                           for p, g in g32.items()),
                "card_grad_worst": max(norm_dist(gc[p], g, top32, p)
                                       for p, g in g32.items())}
        out["batches"].append(read)
    out["ok"] = all(r["loss_rel_err"] <= BF16_CARD_LOSS_TOL
                    and r["grad_worst"]["rel_err"] <= BF16_CARD_TOL
                    and r["grad_median"] <= BF16_CARD_MEDIAN_TOL
                    for r in out["batches"])
    return out


def train_bf16_path(smi: str, done: dict) -> tuple:
    """compute_dtype: bfloat16 (TRAIN_BF16_RUNS): `cli/train.main()` for
    the GS-Soft BiGRU tokenizer, the GRU-encoder Part d, the recipe's
    transformer Part d with its feedback epoch over the residual-VQ
    tokenizer and the audio Part d, each at the shipped config's widths
    and batch 128 over the train path's store and checkpoints: the
    command's launches and losses; from a loop over its own arrays the
    launches per step and per validation batch, steps/s, the step split
    and the idle share beside the fp32 run's; one bf16 step on the card
    against the CPU's (bf16_card_vs_cpu); then a bf16 Part d and a bf16
    tokenizer through `cli/_common.build_generator` (fp32 models, finite
    frames of a 6 s transcript). Checks that a bf16 step launches the
    bf16 instantiations (BF16_LAUNCHES) and no fp32 kernel. Returns the
    kernels line's four bf16 entries and the phase's launches."""
    import glob

    import torch

    from gesture2vec_tpu_torch.cli import train as cli_train
    from gesture2vec_tpu_torch.cli._common import build_generator
    from gesture2vec_tpu_torch.data.store import ClipStore

    rows = bf16_kernel_rows()
    root, stores, ckpts = done["root"], done["stores"], done["ckpts"]
    build, built = cli_train.build_arrays, {}

    def recording_build(*args):
        built["out"] = build(*args)
        return built["out"]

    problems, runs, totals = [], {}, {k: 0 for k in bf16_launches()}
    for run, part, shipped, cuts, base in TRAIN_BF16_RUNS:
        cfg_path = os.path.join(root, f"{run}.yml")
        save = os.path.join(root, "out", run)
        write_train_config(cfg_path, shipped, {
            "train_data_path": stores[2 if part == "audio" else 0],
            "val_data_path": stores[3 if part == "audio" else 1],
            "model_save_path": save, "compute_dtype": "bfloat16", **cuts})
        argv = ["-c", cfg_path, "--part", part, "--save-dir", save,
                "--rep-checkpoint", ckpts["a"]]
        if part != "b":
            argv += ["--autoencoder-checkpoint", ckpts[TRAIN_TEACHERS[base]]]
        cli_train.build_arrays = recording_build
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            _, hist = cli_train.main(argv)
            torch.cuda.synchronize()
        finally:
            cli_train.build_arrays = build
        wall = time.perf_counter() - t0
        launched = all_launches()
        for k in totals:
            totals[k] += launched[k]
        ckpts[run] = sorted(glob.glob(os.path.join(save, "*.bin")))[-1]
        cfg, (train, val), kw = built.pop("out")
        if part in ("d", "audio"):
            fields = (("mel", "tokens") if part == "audio" else
                      ("word_ids", "lengths", "tokens")) + (
                ("stage_tokens",) if cfg.token_stages > 1 else ())
            train, val = (tuple(d[f] for f in fields) for d in (train, val))
        else:
            train, val = (train,), (val,)
        n_words = kw.get("n_words", 0)
        cfg32 = cfg.replace(compute_dtype="float32")
        fp32 = done["runs"][base]
        row = {"phase": "train_bf16", "run": run, "part": part,
               "config": f"configs/{shipped}", "cuts": cuts,
               "compute_dtype": cfg.compute_dtype, "cli_s": wall,
               "launches": launched,
               "first_step_loss": hist["first_step_loss"][0],
               "epoch_loss": hist["train_loss"],
               "val_loss": hist["val_loss"],
               **train_measure(run, part, cfg, train, val, n_words),
               "card_vs_cpu": bf16_card_vs_cpu(part, cfg, cfg32, train,
                                               n_words),
               "fp32": {k: fp32[k] for k in (
                   "steps_per_s", "samples_per_s", "split_ms",
                   "idle_share", "device_ops_per_step")}}
        steps = {run: row}
        if cfg.feedback_finetune_epochs:
            row["feedback"] = {
                **train_measure(run, part, cfg, train, val, n_words,
                                variant="feedback"),
                "card_vs_cpu": bf16_card_vs_cpu(part, cfg, cfg32, train,
                                                n_words, "feedback"),
                "fp32": {k: fp32["feedback"][k] for k in (
                    "steps_per_s", "split_ms", "idle_share")}}
            steps[f"{run}_feedback"] = row["feedback"]
        emit(row)
        runs[run] = row
        # -- check ---------------------------------------------------------
        per_step, per_val = BF16_LAUNCHES[run]
        for name, measured in steps.items():
            want = {k: 0 for k in all_launches()}
            want.update(per_step)
            if measured["launches_per_step"] != want:
                problems.append(f"{name}: launches per step "
                                f"{measured['launches_per_step']}, want "
                                f"{want}")
            if not measured["card_vs_cpu"]["ok"]:
                problems.append(f"{name}: card vs CPU "
                                f"{measured['card_vs_cpu']}")
        want = {k: 0 for k in all_launches()}
        want.update(per_val)
        if row["launches_per_val_batch"] != want:
            problems.append(f"{run}: launches per validation batch "
                            f"{row['launches_per_val_batch']}, want {want}")
        # the command: one gate-saving launch for each backward one, no
        # fp32 training kernel, a bf16 chunk decode a Part-b validation
        # batch (its data step's teacher sweeps run the fp32 tokenizer)
        if launched["gru_sequence_gates_bf16"] != \
                launched["gru_sequence_backward_bf16"] or \
                launched["gru_sequence_backward"] or \
                (per_step and not launched["gru_sequence_backward_bf16"]) \
                or launched["chunk_decoder"] or \
                (part == "b") != (launched["chunk_decoder_bf16"] > 0):
            problems.append(f"{run}: the command launched {launched}")
        losses = [row["first_step_loss"], *row["epoch_loss"],
                  *row["val_loss"]]
        if not all(np.isfinite(losses)) or not \
                row["epoch_loss"][-1] < row["first_step_loss"]:
            problems.append(f"{run}: losses {losses}")
    # bf16-trained checkpoints generate in fp32
    gen, _ = build_generator(ckpts["d_gru_bf16"], ckpts["a"],
                             ckpts["b_gssoft_bf16"], ClipStore(stores[0]),
                             mode="decode")
    models = (gen.t2t_model, gen.seq_decoder)
    fp32_models = all(p.dtype == torch.float32 for m in models
                      for p in m.parameters()) and \
        gen.t2t_model.compute_dtype is None and gen.seq_decoder.dtype is None
    reset_launches()
    frames, _ = gen.generate(words(6.0), 6.0)
    torch.cuda.synchronize()
    got = all_launches()
    generator = {"checkpoints": ["d_gru_bf16", "a", "b_gssoft_bf16"],
                 "fp32_models": fp32_models, "frames": list(frames.shape),
                 "finite": bool(np.isfinite(frames).all()), "launches": got}
    if not fp32_models or frames.shape != (int(6.0 * FPS), DIM) or \
            not generator["finite"] or got["chunk_decoder"] != 1 or \
            any(got[k] for k in bf16_launches()):
        problems.append(f"bf16 generator {generator}")
    emit({"phase": "check", "path": "train_bf16", "generator": generator,
          "card_vs_cpu": {r: row["card_vs_cpu"] for r, row in runs.items()},
          "tol": BF16_TOL, "problems": problems})
    if problems:
        raise AssertionError(f"train_bf16 check failed: {problems}")
    entries = []
    for name, fp32_name, main_key in (
            ("gru_sequence_bf16", "gru_sequence", "T20_B128"),
            ("gru_sequence_gates_bf16", "gru_sequence_gates", "T20_B128"),
            ("gru_sequence_backward_bf16", "gru_sequence_backward",
             "T20_B128"),
            ("chunk_decoder_bf16", "chunk_decoder", "B128_steps19")):
        main = rows[name][main_key]
        entries.append({
            "name": name, "route": "cuda",
            "source": "gesture2vec_tpu_torch/csrc/" + (
                "chunk_decoder.cu" if name.startswith("chunk") else
                "gru_sequence_backward.cu" if "backward" in name else
                "gru_sequence.cu"),
            "replaces": ("gesture2vec_tpu/ops/decoder_pallas.py:144"
                         if name.startswith("chunk") else
                         "gesture2vec_tpu/ops/gru_pallas.py:60"),
            "replaces_note": f"the bf16 instantiation of {fp32_name} (the "
                             f"JAX package's compute_dtype: bfloat16)",
            "launches": totals[name],
            "max_abs_err": max(r["max_abs_err"]
                               for r in rows[name].values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "cuda_core_bound_ms": main["cuda_core_bound_ms"],
            "library_ms": main["library_ms"], "fp32_ms": main["fp32_ms"],
            "by_shape": {k: {key: r.get(key) for key in (
                "ms", "fp32_ms", "plain_ms", "bound_ms", "bound_by",
                "cuda_core_bound_ms", "library_ms",
                "matmul_plus_kernel_ms", "max_abs_err")}
                for k, r in rows[name].items()}})
    return entries, totals


def rss_sampler():
    """A thread sampling this process's resident set every 20 ms: returns
    (stop, peak, start) where stop() ends it, peak() gives the largest RSS
    seen and start the RSS when it began, in MiB."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")
    seen = [0]
    stop_ev = threading.Event()

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    def loop():
        while not stop_ev.is_set():
            seen[0] = max(seen[0], rss())
            stop_ev.wait(0.02)

    seen[0] = rss()
    start = seen[0] / 2 ** 20
    t = threading.Thread(target=loop, daemon=True)
    t.start()

    def stop():
        stop_ev.set()
        t.join()
        seen[0] = max(seen[0], rss())
    return stop, lambda: seen[0] / 2 ** 20, start


def stream_path(smi: str, done: dict) -> dict:
    """The streaming sources (`data/streaming`) on the train path's store:
    Part a (configs/DAE.yml) from StreamingFrames and Part b
    (configs/VQ-VAE.yml, the GS-Soft BiGRU tokenizer) from
    StreamingWindows with the frozen Part-a DAE as its transform
    (`data/teacher.window_teacher`, run in the prefetch worker), one epoch
    each, beside the same trainer on the in-RAM arrays cli/train builds:
    steps/s of each, the host's peak RSS during each and its growth over
    the RSS at the start (the process's own ~8 GB of CUDA context, stores
    and earlier phases under it; the in-RAM arrays are built before), the
    launches (the same steps, so the same counts), and both losses
    falling."""
    import torch

    from gesture2vec_tpu_torch.cli import train as cli_train
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.data.streaming import (StreamingFrames,
                                                      StreamingWindows)
    from gesture2vec_tpu_torch.data.teacher import window_teacher
    from gesture2vec_tpu_torch.train import dae_trainer as dt
    from gesture2vec_tpu_torch.train import seq_ae_trainer as st
    from gesture2vec_tpu_torch.train.config import load_config

    root, stores, ckpts = done["root"], done["stores"], done["ckpts"]
    store = ClipStore(stores[0])
    dae = load_checkpoint_and_model(ckpts["a"], "DAE", "cuda")[0]
    out, problems = {}, []
    for part, shipped, trainer in (("a", "DAE.yml", dt.train_dae),
                                   ("b", "VQ-VAE.yml", st.train_seq_ae)):
        cfg_path = os.path.join(root, f"stream_{part}.yml")
        write_train_config(cfg_path, shipped, {
            "train_data_path": stores[0], "val_data_path": stores[1],
            "epochs": 1, "rep_learning_checkpoint": ckpts["a"]})
        cfg, (train, val), _ = cli_train.build_arrays(
            load_config(cfg_path), part, torch.device("cuda"))
        if part == "a":
            source = StreamingFrames(store)
        else:
            source = StreamingWindows(
                store, cfg.n_poses, cfg.subdivision_stride,
                transform=window_teacher(dae))
        res = {}
        for how, data in (("in_ram", train), ("stream", source)):
            n = len(data)
            stop, peak, start = rss_sampler()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, hist = trainer(cfg, data, val, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stop()
            steps = n // cfg.batch_size
            res[how] = {"samples": n, "steps": steps, "epoch_s": wall,
                        "steps_per_s": steps / wall,
                        "peak_rss_mib": peak(), "rss_at_start_mib": start,
                        "peak_rss_growth_mib": peak() - start,
                        "launches": all_launches(),
                        "first_step_loss": hist["first_step_loss"][0],
                        "epoch_loss": hist["train_loss"],
                        "val_loss": hist["val_loss"]}
            losses = [res[how]["first_step_loss"], *hist["train_loss"],
                      *hist["val_loss"]]
            if not all(np.isfinite(losses)) or \
                    not hist["train_loss"][-1] < hist["first_step_loss"][0]:
                problems.append(f"{part} {how}: losses {losses}")
        if res["stream"]["launches"] != res["in_ram"]["launches"] or \
                res["stream"]["steps"] != res["in_ram"]["steps"]:
            problems.append(f"{part}: stream {res['stream']} against in "
                            f"RAM {res['in_ram']}")
        row = {"phase": "stream", "part": part, "config": f"configs/{shipped}",
               "batch": cfg.batch_size, **res,
               "stream_over_in_ram_steps_per_s":
                   res["stream"]["steps_per_s"]
                   / res["in_ram"]["steps_per_s"]}
        emit(row)
        out[part] = row
    emit({"phase": "check", "path": "stream", "problems": problems})
    if problems:
        raise AssertionError(f"stream check failed: {problems}")
    return out


# -- the baseline, c2g and the GAN (g2v-train --part baseline|c2g|gan) ---
# (run, shipped config, cuts) over the train path's store (2,600 windows
# of 20 frames: 20 full batches of 128; the validation store 1), c2g over
# the train path's DAE "a" and GS-Soft tokenizer "b_gssoft" (512 codes);
# widths as shipped (hidden 200, 2 layers, 20 frames, 300-dim word
# vectors, noise_dim 400); epochs cut to 2 (the baseline's loss falls
# slowly in its first) and to 1 for the GAN (11 D updates a step)
MISC_RUNS = (("baseline", "seq2seq.yml", {"epochs": 2}),
             ("c2g", "c2g.yml", {"epochs": 2}),
             ("gan", "gan.yml", {"epochs": 1}))
# kernel launches a train step and a validation batch (the others 0),
# from the code: a text encoder's masked BiGRU is 2 layers x 2 directions
# (4 launches), c2g's pre_gru and the discriminator's pose GRU 2 layers
# (2); under grad each forward is the gate-saving variant (counted among
# gru_sequence's launches) and has one backward launch. The GAN step: the
# fake batch's generator forward without grad (4 inference), 11 D updates
# (the first and 10 unrolled) of 2 forwards x (4 + 2) = 132 gate-saving,
# the generator's update (its text encoder 4 gate-saving; D's text
# encoder 4 inference, as no gradient reaches D; D's pose GRU 2
# gate-saving): 8 inference + 138 gate-saving launches, 138 backward.
# A validation batch runs without grad; c2g's rolls out through one
# chunk-decoder launch
MISC_STEP_LAUNCHES = {
    "baseline": {"gru_sequence": 4, "gru_sequence_backward": 4},
    "c2g": {"gru_sequence": 2, "gru_sequence_backward": 2},
    "gan": {"gru_sequence": 8 + 138, "gru_sequence_backward": 138}}
MISC_GATES = {"baseline": 4, "c2g": 2, "gan": 138}
MISC_VAL_LAUNCHES = {"baseline": {"gru_sequence": 4},
                     "c2g": {"gru_sequence": 2, "chunk_decoder": 1}}
# the slice's new kernel shapes (H=200): the GRU sequence at the text
# encoders' 32 word slots, the pose GRU's 20 frames and c2g's one step at
# the training batch, baseline generation's one window (B=1) and c2g over
# all 512 ids; its gradient at the first three; the chunk decoder at
# c2g's validation batch and its 512 ids (19 steps)
MISC_GRU_SHAPES = ((32, 128), (20, 128), (1, 128), (32, 1), (1, K))
MISC_BWD_SHAPES = ((32, 128), (20, 128), (1, 128))
MISC_DECODER_SHAPES = ((128, N_FRAMES - 1), (K, N_FRAMES - 1))
# baseline generation's transcript
MISC_GEN_S = 60.0


def misc_want_launches(run: str, cfg, n: int, m: int) -> dict:
    """The launches `cli/train --part run` must make over n train and m
    validation samples (full batches only): MISC_STEP_LAUNCHES a step,
    MISC_VAL_LAUNCHES a validation batch, and for c2g the data step's
    tokenizer, its BiGRU's layer 0 (2 launches) per 512 windows of the
    train and the validation set."""
    bs, epochs = cfg.batch_size, cfg.epochs
    want = {name: 0 for name in launch_counters()}
    for per, count in ((MISC_STEP_LAUNCHES[run], n // bs),
                       (MISC_VAL_LAUNCHES.get(run, {}), m // bs)):
        for k, v in per.items():
            want[k] += v * count * epochs
    if run == "c2g":
        want["gru_sequence"] += 2 * (-(-n // 512) - (-m // 512))
    return want


def misc_kernel_rows(c2g) -> dict:
    """The kernels at the slice's new shapes against their plain versions
    on the same inputs: the chunk decoder with the trained c2g's folded
    step from its zero seed and its pre_gru's hidden of ids 0.. at each
    MISC_DECODER_SHAPES; the GRU sequence at each MISC_GRU_SHAPES (both
    directions) with cuDNN's layer beside it; the GRU training kernels at
    MISC_BWD_SHAPES (`gru_backward_rows`)."""
    import torch

    from gesture2vec_tpu_torch.models.gru import gru_layer
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    g = torch.Generator(device="cuda").manual_seed(23)
    rows = {"chunk_decoder": {}, "gru_sequence": {},
            "gru_sequence_backward": {}}
    folded = dk.fold_decoder_step(c2g.step)
    for B, n in MISC_DECODER_SHAPES:
        with torch.no_grad():
            ids = torch.arange(B, device="cuda") % K
            _, h0 = c2g.pre_gru(c2g.embedding(ids)[None])
        x0 = torch.zeros(B, REP, device="cuda")
        ys = dk.fused_chunk_decode(x0, h0.contiguous(), folded, n)
        ref = dk.fused_chunk_decode_plain(x0, h0, folded, n)
        torch.cuda.synchronize()
        row = {"phase": "kernel", "path": "misc_train",
               "kernel": "chunk_decoder", "B": B, "H": HID, "D": REP,
               "n_steps": n, "launch": decoder_launch(B, HID, REP),
               "max_abs_err": (ys - ref).abs().max().item(), "tol": TOL,
               "ms": cuda_ms(lambda: dk.fused_chunk_decode(
                   x0, h0.contiguous(), folded, n), 20),
               "plain_ms": cuda_ms(lambda: dk.fused_chunk_decode_plain(
                   x0, h0, folded, n), 10),
               "library_ms": None, **chunk_decoder_bound_ms(B, REP, HID, n)}
        emit(row)
        rows["chunk_decoder"][f"misc_B{B}_T{n}"] = row
    bnd = 1.0 / HID ** 0.5
    w_ih, w_hh = ((torch.rand(3 * HID, HID, device="cuda", generator=g)
                   * 2 - 1) * bnd for _ in range(2))
    b_ih, b_hh = ((torch.rand(3 * HID, device="cuda", generator=g) * 2 - 1)
                  * bnd for _ in range(2))
    cudnn = torch.nn.GRU(HID, HID, 1).cuda()
    with torch.no_grad():
        for prm, v in ((cudnn.weight_ih_l0, w_ih), (cudnn.weight_hh_l0, w_hh),
                       (cudnn.bias_ih_l0, b_ih), (cudnn.bias_hh_l0, b_hh)):
            prm.copy_(v)
    with torch.inference_mode():
        for T, B in MISC_GRU_SHAPES:
            xs = torch.randn(T, B, HID, device="cuda", generator=g)
            h0 = torch.zeros(B, HID, device="cuda")
            xp = (xs.reshape(-1, HID) @ w_ih.t() + b_ih).reshape(T, B, -1)
            err = 0.0
            for reverse in (False, True):
                ys, h = gk.gru_sequence(xp, h0, w_hh, b_hh, reverse)
                ys_p, h_p = gk.gru_sequence_plain(xp, h0, w_hh, b_hh,
                                                  reverse)
                torch.cuda.synchronize()
                err = max(err, (ys - ys_p).abs().max().item(),
                          (h - h_p).abs().max().item())
            row = {"phase": "kernel", "path": "misc_train",
                   "kernel": "gru_sequence", "T": T, "B": B, "H": HID,
                   "directions": 2, "launch": gru_launch(B, HID),
                   "max_abs_err": err, "tol": TOL,
                   "ms": cuda_ms(lambda: gk.gru_sequence(xp, h0, w_hh,
                                                         b_hh), 20),
                   "plain_ms": cuda_ms(lambda: gk.gru_sequence_plain(
                       xp, h0, w_hh, b_hh), 5),
                   **gru_bound_ms(T, B, HID),
                   # cuDNN computes the input product too: its yardstick
                   # is the matmul plus the kernel
                   "library_ms": cuda_ms(lambda: cudnn(xs, h0[None]), 20),
                   "matmul_plus_kernel_ms": cuda_ms(lambda: gru_layer(
                       xs, h0, w_ih, w_hh, b_ih, b_hh), 20)}
            emit(row)
            rows["gru_sequence"][f"misc_T{T}_B{B}"] = row
    for r in gru_backward_rows(MISC_BWD_SHAPES):
        if not r["reverse"]:
            r["path"] = "misc_train"
            rows["gru_sequence_backward"][f"misc_T{r['T']}_B{r['B']}"] = r
    bad = [r for k in rows.values() for r in k.values()
           if not r["max_abs_err"] <= r["tol"]]
    if bad:
        raise AssertionError(f"kernels at the misc path's shapes: {bad}")
    return rows


def gan_batches(cfg, data, count: int) -> list:
    """The first count batches of the GAN trainer's first epoch, on the
    card."""
    from gesture2vec_tpu_torch.train.token_loop import to_device

    bs = cfg.batch_size
    perm = np.random.default_rng(max(cfg.random_seed, 0)).permutation(
        data[0].shape[0])
    n = data[0].shape[0] // bs
    return [tuple(to_device(a[perm[(b % n) * bs:(b % n + 1) * bs]], "cuda")
                  for a in data) for b in range(count)]


def gan_measure(cfg, data, n_words: int) -> dict:
    """The GAN trainer's step (`train/gan_trainer.GANStep`, 10 unrolled D
    updates) on a fresh pair of models: launches per step (and of the
    gate-saving variant), steps/s and samples/s over TRAIN_TIMED_STEPS,
    the split into the fake batch, the 11 D updates and the generator's
    update (with D's restore) over 3 steps, the idle share and device ops
    per step over TRAIN_PROFILED_STEPS."""
    import torch

    from gesture2vec_tpu_torch.models.layers import dropout_generator
    from gesture2vec_tpu_torch.ops import gru_kernel as gk
    from gesture2vec_tpu_torch.train import gan_trainer as gt
    from gesture2vec_tpu_torch.train.optim import Adam

    g, d = gt.init_gan(*gt.build_gan(cfg, n_words, DIM), 0,
                       torch.device("cuda"))
    step = gt.GANStep(g, d, Adam(g.parameters(), cfg.learning_rate,
                                 clip_norm=None),
                      Adam(d.parameters(), cfg.learning_rate,
                           clip_norm=None),
                      keep_unrolled=cfg.gan_keep_unrolled)
    drop = torch.Generator(device="cuda").manual_seed(0)
    noise_gen = torch.Generator(device="cuda").manual_seed(1)
    bs = cfg.batch_size
    n_timed, n_prof = TRAIN_TIMED_STEPS["gan"], TRAIN_PROFILED_STEPS["gan"]
    batches = gan_batches(cfg, data, 4 + n_timed + n_prof)

    def noise():
        return torch.randn(bs, cfg.noise_dim, generator=noise_gen,
                           device="cuda")

    def run_steps(bb):
        for batch in bb:
            with dropout_generator(drop):
                step(*batch, noise())

    reset_launches()
    run_steps(batches[:1])
    torch.cuda.synchronize()
    per_step = all_launches()
    gates = gk.gru_sequence_gates.launches
    split = {"fake_ms": 0.0, "d_updates_ms": 0.0, "g_step_ms": 0.0}
    for tokens, lengths, real in batches[1:4]:
        z, seed = noise(), real[:, 0]
        with dropout_generator(drop):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fake = step.fake_batch(tokens, lengths, z, seed)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, _, saved = step.unroll(tokens, lengths, real, fake)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            step.g_update(tokens, lengths, z, seed)
            if saved is not None:
                step.restore_d(*saved)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        for key, dt_s in (("fake_ms", t1 - t0), ("d_updates_ms", t2 - t1),
                          ("g_step_ms", t3 - t2)):
            split[key] += dt_s * 1e3 / 3
    timed = batches[4:4 + n_timed]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = batches[4 + n_timed:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(prof)
    torch.cuda.synchronize()
    busy = device_busy(lambda: run_steps(prof), time.perf_counter() - t0)
    busy["device_ops_per_step"] = busy["device_ops"] / max(len(prof), 1)
    return {"steps_per_epoch": data[0].shape[0] // bs, "batch": bs,
            "unroll_steps": step.unroll_steps,
            "launches_per_step": per_step, "gates_per_step": gates,
            "timed_steps": len(timed), "steps_per_s": len(timed) / wall,
            "samples_per_s": len(timed) * bs / wall, "split_ms": split,
            "profiled_steps": len(prof), **busy}


def gan_card_vs_cpu(cfg, data, n_words: int) -> dict:
    """The GAN step from the same initial models, batch and noise on the
    card and on the CPU, every dropout off: the fake batch (relative to
    its largest magnitude), the first D update alone (its losses and D's
    gradients, each against its tensor's largest magnitude), then the
    whole step from the start again (the three losses; the generator's
    gradients, pre_linear's bias against the model's largest gradient as
    in train_card_vs_cpu; its BatchNorm statistics against the larger of
    1 and their largest magnitude). A ReLU input on another side of 0 on
    the card (kink_inputs) makes the run a near-tie when each such input
    lies within KINK_TIE of its call's largest magnitude."""
    import copy

    import torch

    from gesture2vec_tpu_torch.compat.from_jax import param_entries
    from gesture2vec_tpu_torch.train import gan_trainer as gt
    from gesture2vec_tpu_torch.train.optim import Adam
    from gesture2vec_tpu_torch.train.token_loop import to_device

    g, d = gt.init_gan(*gt.build_gan(cfg, n_words, DIM), 0,
                       torch.device("cpu"))
    bs = cfg.batch_size
    batch = [a[:bs] for a in data]
    noise = torch.randn(bs, cfg.noise_dim,
                        generator=torch.Generator().manual_seed(0))

    def grads(model):
        return {path: (p.grad if p.grad is not None
                       else torch.zeros_like(p)).detach().cpu()
                for path, p, _, _ in param_entries(model)}

    def run(dev: str) -> dict:
        t = [to_device(a, dev) for a in batch]
        z = noise.to(dev)
        out = {}
        with kink_inputs() as calls:
            for whole in (False, True):
                gm, dm = copy.deepcopy(g).to(dev), copy.deepcopy(d).to(dev)
                step = gt.GANStep(
                    gm, dm, Adam(gm.parameters(), cfg.learning_rate,
                                 clip_norm=None),
                    Adam(dm.parameters(), cfg.learning_rate,
                         clip_norm=None),
                    keep_unrolled=cfg.gan_keep_unrolled)
                gm.train()
                dm.train()
                if not whole:
                    fake = step.fake_batch(*t[:2], z, t[2][:, 0])
                    out["first"] = [float(v) for v in
                                    step.d_update(*t, fake)]
                    out["fake"], out["d_grads"] = fake.cpu(), grads(dm)
                    continue
                out["metrics"] = {k: float(v)
                                  for k, v in step(*t, z).items()}
                out["g_grads"] = grads(gm)
                out["buffers"] = {name: b.detach().cpu()
                                  for name, b in gm.named_buffers()
                                  if b.dtype.is_floating_point}
        out["kinks"] = calls
        return out

    def tree_err(ref: dict, other: dict) -> tuple:
        top = max(float(v.abs().max()) for v in ref.values())
        worst, where = 0.0, ""
        for path, v in ref.items():
            scale = top if cancelled_grad(path) else float(v.abs().max())
            err = float((other[path] - v).abs().max()) / max(scale, 1e-30)
            if err > worst:
                worst, where = err, "/".join(path)
        return worst, where

    host, card = run("cpu"), run("cuda")
    flips = kink_flips(host["kinks"], card["kinks"])
    losses = {**dict(zip(("first_d_real", "first_d_fake"), host["first"])),
              **host["metrics"]}
    card_losses = {**dict(zip(("first_d_real", "first_d_fake"),
                              card["first"])), **card["metrics"]}
    d_err, d_where = tree_err(host["d_grads"], card["d_grads"])
    g_err, g_where = tree_err(host["g_grads"], card["g_grads"])
    buf = max(float((card["buffers"][k] - v).abs().max())
              / max(1.0, float(v.abs().max()))
              for k, v in host["buffers"].items())
    return {"losses_cpu": losses, "losses_card": card_losses,
            "loss_rel_err": max(abs(card_losses[k] - v) / max(abs(v), 1e-30)
                                for k, v in losses.items()),
            "fake_rel_err": rel_err(card["fake"], host["fake"]),
            "d_grad_rel_err": d_err, "d_grad_worst": d_where,
            "grad_rel_err": g_err, "grad_worst": g_where,
            "buffer_rel_err": buf, **flips,
            "near_tie": flips["kink_flips"] > 0
            and flips["kink_max_ratio"] <= KINK_TIE}


def misc_train_path(smi: str, done: dict) -> tuple:
    """`cli/train.main()` for --part baseline, c2g and gan over the train
    path's store (c2g over its DAE and GS-Soft tokenizer) at the shipped
    configs' widths, one epoch each: each command's launches against
    those its steps, validation batches and data step must make, and
    its seconds; from a separate loop on fresh models, launches per step
    and per validation batch, steps/s, the split (forward / backward /
    optimizer; the GAN's fake batch / D updates / generator step), the
    idle share and device ops per step; one step card against CPU; the
    losses. Then the kernels at the new shapes against their plain
    versions, `generate_baseline` over the trained baseline's checkpoint
    and a MISC_GEN_S transcript card against CPU, and c2g over all 512
    ids through the chunk-decoder kernel against its plain loop (and the
    parity_frozen_hidden model, which launches no chunk decoder). Returns
    ({kernel: {shape: row}}, {run: the command's launches})."""
    import glob

    import torch

    from gesture2vec_tpu_torch.cli import train as cli_train
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.infer.baseline_infer import generate_baseline
    from gesture2vec_tpu_torch.text.vocab import build_vocab

    root, stores, ckpts = done["root"], done["stores"], done["ckpts"]
    build, built = cli_train.build_arrays, {}

    def recording_build(*args):
        built["out"] = build(*args)
        return built["out"]

    counts, runs, files, problems = {}, {}, {}, []
    with kernel_shapes() as shapes:
        for run, shipped, cuts in MISC_RUNS:
            cfg_path = os.path.join(root, f"misc_{run}.yml")
            save = os.path.join(root, "out", f"misc_{run}")
            write_train_config(cfg_path, shipped, {
                "train_data_path": stores[0], "val_data_path": stores[1],
                "model_save_path": save, **cuts})
            argv = ["-c", cfg_path, "--part", run, "--save-dir", save]
            if run == "c2g":
                argv += ["--rep-checkpoint", ckpts["a"],
                         "--autoencoder-checkpoint", ckpts["b_gssoft"]]
            reset_launches()
            gates_before = sum(shapes["gru_sequence_gates"].values())
            cli_train.build_arrays = recording_build
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                _, hist = cli_train.main(argv)
                torch.cuda.synchronize()
            finally:
                cli_train.build_arrays = build
            wall = time.perf_counter() - t0
            counts[run] = read_launches()
            gates = sum(shapes["gru_sequence_gates"].values()) - gates_before
            files[run] = sorted(glob.glob(os.path.join(save, "*.bin")))[-1]
            cfg, (train, val), kw = built.pop("out")
            n_words = kw.get("n_words", 0)
            if run != "c2g":
                fields = ("word_ids", "lengths", "poses")
                train = tuple(train[f] for f in fields)
                val = tuple(val[f] for f in fields) if val else ((),)
            m = len(val[0])
            row = {"phase": "misc_train", "run": run,
                   "config": f"configs/{shipped}", "cuts": cuts,
                   "widths": {"hidden": cfg.hidden_size,
                              "layers": cfg.n_layers,
                              "batch": cfg.batch_size,
                              "frames": cfg.n_poses,
                              "word_embed": cfg.wordembed_dim,
                              "noise_dim": cfg.noise_dim,
                              "codes": cfg.autoencoder_vq_components},
                   "cli_s": wall, "launches": counts[run],
                   "gates_launches": gates,
                   "want_launches": misc_want_launches(
                       run, cfg, train[0].shape[0], m),
                   "train_samples": int(train[0].shape[0]),
                   "val_samples": m, "history": hist}
            if run == "gan":
                row.update(gan_measure(cfg, train, n_words),
                           card_vs_cpu=gan_card_vs_cpu(cfg, train, n_words))
            else:
                row.update(train_measure(run, run, cfg, train, val,
                                         n_words),
                           card_vs_cpu=train_card_vs_cpu(run, cfg, train,
                                                         n_words))
            emit(row)
            runs[run] = row
        # the tools path reads the baseline's and c2g's checkpoints
        done["misc_ckpts"] = dict(files)

        # -- generation over the trained checkpoints ------------------------
        store = ClipStore(stores[0])
        vocab = build_vocab("corpus", [[w[0] for w in c["words"]]
                                       for c in store.clips])
        ws = words(MISC_GEN_S, 4)
        gen = {}
        for dev in ("cuda", "cpu"):
            model, _ = load_checkpoint_and_model(files["baseline"],
                                                 "baseline", dev)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen[dev] = generate_baseline(
                model, vocab, ws, MISC_GEN_S, pose_mean=store.pose_mean,
                pose_std=store.pose_std, fps=FPS, device=dev)
            torch.cuda.synchronize()
            gen[dev + "_s"] = time.perf_counter() - t0
            gen[dev + "_launches"] = read_launches()
        n_windows = len(range(0, int(MISC_GEN_S * FPS) - N_FRAMES + 1,
                              N_FRAMES - 4))
        baseline_gen = {
            "frames": list(gen["cuda"].shape), "windows": n_windows,
            "finite": bool(np.isfinite(gen["cuda"]).all()),
            "card_s": gen["cuda_s"], "cpu_s": gen["cpu_s"],
            "launches": gen["cuda_launches"],
            "max_abs_err_vs_cpu": float(np.abs(gen["cuda"]
                                               - gen["cpu"]).max()),
            "tol": TOL * max(1.0, float(np.abs(gen["cpu"]).max()))}
        emit({"phase": "misc_generate", **baseline_gen})
        c2g, _ = load_checkpoint_and_model(files["c2g"], "c2g", "cuda")
        ids = torch.arange(K, device="cuda")
        c2g_all = {}
        with torch.no_grad():
            for name, kernel, frozen in (("kernel", True, False),
                                         ("plain", False, False),
                                         ("frozen", True, True)):
                c2g.use_kernel, c2g.parity_frozen_hidden = kernel, frozen
                reset_launches()
                c2g_all[name] = c2g(ids)
                torch.cuda.synchronize()
                c2g_all[name + "_launches"] = read_launches()
        c2g.use_kernel, c2g.parity_frozen_hidden = True, False
        ref = c2g_all["plain"]
        c2g_row = {"ids": K, "frames": list(c2g_all["kernel"].shape),
                   "max_abs_err": (c2g_all["kernel"] - ref).abs().max()
                   .item(), "tol": TOL * max(1.0, ref.abs().max().item()),
                   "launches": c2g_all["kernel_launches"],
                   "plain_launches": c2g_all["plain_launches"],
                   "frozen_launches": c2g_all["frozen_launches"],
                   "frozen_finite": bool(torch.isfinite(
                       c2g_all["frozen"]).all())}
        emit({"phase": "misc_c2g_all_ids", **c2g_row})
        rows = misc_kernel_rows(c2g)

    # -- check -------------------------------------------------------------
    for run, row in runs.items():
        if row["launches"] != row["want_launches"]:
            problems.append(f"{run}: the command launched {row['launches']}"
                            f", want {row['want_launches']}")
        if row["gates_launches"] != row["launches"]["gru_sequence_backward"]:
            problems.append(f"{run}: {row['gates_launches']} gate-saving "
                            f"launches for {row['launches']} backward")
        want = {k: 0 for k in all_launches()}
        want.update(MISC_STEP_LAUNCHES[run])
        if row["launches_per_step"] != want:
            problems.append(f"{run}: launches per step "
                            f"{row['launches_per_step']}, want {want}")
        if run == "gan" and row["gates_per_step"] != MISC_GATES[run]:
            problems.append(f"gan: {row['gates_per_step']} gate-saving "
                            f"launches a step, want {MISC_GATES[run]}")
        if run != "gan":
            want = {k: 0 for k in all_launches()}
            want.update(MISC_VAL_LAUNCHES[run])
            if row["launches_per_val_batch"] != want:
                problems.append(f"{run}: launches per validation batch "
                                f"{row['launches_per_val_batch']}, want "
                                f"{want}")
        cvc = row["card_vs_cpu"]
        if not cvc.get("near_tie") and not (
                cvc["loss_rel_err"] <= TOL and cvc["grad_rel_err"] <= TOL
                and cvc["buffer_rel_err"] <= TOL
                and cvc["kink_max_ratio"] <= KINK_TIE
                and cvc.get("d_grad_rel_err", 0.0) <= TOL
                and cvc.get("fake_rel_err", 0.0) <= TOL):
            problems.append(f"{run}: card vs CPU {cvc}")
        hist = row["history"]
        losses = [v for vals in hist.values() for v in vals]
        if run == "gan":
            first, last = hist["first_step_d_loss"][0], \
                hist["d_real"][-1] + hist["d_fake"][-1]
        else:
            first, last = hist["first_step_loss"][0], hist["train_loss"][-1]
        if not all(np.isfinite(losses)) or not last < first:
            problems.append(f"{run}: losses {hist}")
    if not baseline_gen["finite"] or baseline_gen["frames"] != [
            int(MISC_GEN_S * FPS), DIM] or not \
            baseline_gen["max_abs_err_vs_cpu"] <= baseline_gen["tol"] or \
            baseline_gen["launches"]["gru_sequence"] != 4 * n_windows:
        problems.append(f"generate_baseline: {baseline_gen}")
    if not c2g_row["max_abs_err"] <= c2g_row["tol"] or \
            c2g_row["launches"]["chunk_decoder"] != 1 or \
            c2g_row["plain_launches"]["chunk_decoder"] != 0 or \
            c2g_row["frozen_launches"]["chunk_decoder"] != 0 or \
            not c2g_row["frozen_finite"]:
        problems.append(f"c2g over all ids: {c2g_row}")
    compared = compared_shapes()
    compared["gru_sequence"] |= {(T, B, HID) for T, B in MISC_GRU_SHAPES}
    for name in ("gru_sequence_gates", "gru_sequence_backward"):
        compared[name] |= {(T, B, HID) for T, B in MISC_BWD_SHAPES}
    compared["gru_sequence"] |= compared["gru_sequence_gates"]
    compared["chunk_decoder"] |= set(MISC_DECODER_SHAPES)
    for name, counter in shapes.items():
        missing = sorted(set(counter) - compared[name])
        if missing:
            problems.append(f"{name}: shapes {missing} not compared with "
                            f"the plain version")
    emit({"phase": "check", "path": "misc_train",
          "card_vs_cpu": {r: row["card_vs_cpu"] for r, row in runs.items()},
          "kernel_shapes": {name: [[list(k), v] for k, v in sorted(
              c.items())] for name, c in shapes.items()},
          "tol": TOL, "problems": problems})
    if problems:
        raise AssertionError(f"misc_train check failed: {problems}")
    return rows, counts

# -- the tools path: cli/tools, the reference importer, FLOPs, profiling --
# (run, checkpoint kind) written as reference .pt payloads and imported
TOOLS_IMPORTS = (("a", "DAE"), ("b_gssoft", "autoencoder_vq"),
                 ("d_gru", "text2embedding"))
# g2v-infer --mode decode over the imported files (the cli path's middle
# request), baseline-infer's transcript (14 windows of 20 frames at
# stride 16), and c2g-samples' clusters x samples: one rollout of 128
# rows, the chunk decoder's (128, 19) that the misc path compared
TOOLS_DECODE_S, TOOLS_BASELINE_S, TOOLS_C2G = 60.0, 12.0, (32, 4)
# the phase's own corpus (make_dataset's data_pipe.json exports the BVH
# files; its transcripts and motion feed unityfy and human-study): 2
# Trinity-layout files of 12 s at 60 fps
TOOLS_CORPUS = (2, 720)
# the runs whose train-path steps/s give an MFU: 3x the analytic forward
# a step (utils/flops), against the card's bf16 and fp32 peaks
TOOLS_MFU_RUNS = ("a", "b_gssoft", "d_tcn", "d_gru", "d_recipe")
# the profiled decode request
TOOLS_TRACE_S = 6.0


def write_reference_checkpoint(path: str, payload: dict, kind: str,
                               layout) -> None:
    """A checkpoint payload (`compat/checkpoint.load_checkpoint`'s) as
    the reference trainer's .pt file: {args (argparse.Namespace with the
    reference's key names), epoch, pose_dim, gen_dict (the state dict in
    the reference's layout: tests/torch_reference_layout.py, the inverse
    of compat/torch_import's converters)}."""
    import torch

    params = payload["params"]
    stats = payload["extra"].get("batch_stats", {})
    n_layers = int(payload["config"].get("n_layers", 2))
    sd = {"DAE": lambda: layout.dae_sd(params),
          "autoencoder_vq": lambda: layout.seq_ae_sd(params, stats,
                                                     n_layers),
          "text2embedding": lambda: layout.text2token_sd(params, stats,
                                                         n_layers)}[kind]()
    torch.save(layout.reference_payload(
        sd, layout.reference_args(payload["config"]),
        epoch=int(payload["epoch"]), pose_dim=int(payload["pose_dim"])),
        path)


def tree_leaves(tree, prefix=()) -> dict:
    """{path: leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(tree_leaves(v, prefix + (k,)))
    return out


def same_bits(a: dict, b: dict) -> list:
    """The paths whose leaves differ in dtype, shape or bits (or exist on
    one side only)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    bad = sorted("/".join(p) for p in set(la) ^ set(lb))
    for p in set(la) & set(lb):
        x, y = np.asarray(la[p]), np.asarray(lb[p])
        if x.dtype != y.dtype or x.shape != y.shape or \
                x.tobytes() != y.tobytes():
            bad.append("/".join(p))
    return sorted(bad)


def mfu_forward_flops(run: str, cfg, batch: int) -> float:
    """The analytic forward FLOPs (utils/flops) of a train-path run's
    model at its config's widths: Part a's DAE, Part b's tokenizer, Part
    d's TCN / GRU model or the recipe's transformer over the sentence
    dataset's 48 word slots."""
    from gesture2vec_tpu_torch.utils import flops

    if run.startswith("a"):
        return flops.dae_forward_flops(batch, cfg.input_motion_dim,
                                       cfg.hidden_size)
    if run.startswith("b"):
        return flops.seq_ae_forward_flops(
            batch, cfg.n_poses, cfg.rep_learning_dim, cfg.hidden_size,
            cfg.n_layers, cfg.autoencoder_vq_components,
            "transformer" if cfg.extras.get("seq_arch") == "transformer"
            else "bigru")
    kw = dict(max_words=MAXW, embed=cfg.wordembed_dim,
              hidden=cfg.hidden_size, n_layers=cfg.n_layers,
              n_steps=cfg.sentence_frame_length // cfg.n_poses,
              codes=cfg.autoencoder_vq_components)
    if cfg.extras.get("t2t_arch") == "transformer":
        return flops.transformer_t2t_forward_flops(batch, **kw)
    return flops.text2token_forward_flops(
        batch, encoder=cfg.extras.get("text_encoder", "tcn"), **kw)


def tools_path(smi: str, done: dict) -> dict:
    """`python -m gesture2vec_tpu_torch.cli.tools` and its modules over the
    train path's and the misc path's checkpoints (`done`), each stage
    timed by `utils/profiling.StageTimer`: the train path's DAE, GS-Soft
    tokenizer and GRU-encoder Part d written as reference .pt payloads
    and brought back by `import-checkpoint` (every tree bit for bit),
    `g2v-infer --mode decode` over the imported and the original files on
    the card and over the imported ones on the CPU, the validation store's
    windows through the imported tokenizer card against CPU,
    `baseline-infer` and `c2g-samples` card against CPU, `unityfy` and
    `human-study` over the phase's own corpus, the MFU of the train
    path's steps (`utils/flops`), and one profiler trace of a decode
    request, which must name the chunk-decoder kernel. Returns {run: the
    launches on the card}."""
    import glob

    import torch

    from gesture2vec_tpu_torch.cli import infer as cli_infer
    from gesture2vec_tpu_torch.cli import make_dataset, tools
    from gesture2vec_tpu_torch.cli._common import build_generator
    from gesture2vec_tpu_torch.compat.checkpoint import (
        load_checkpoint, load_checkpoint_and_model)
    from gesture2vec_tpu_torch.compat.torch_import import merge_params
    from gesture2vec_tpu_torch.data.datasets import pose_windows
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.data.teacher import (encode_windows_with_dae,
                                                    tokenize_windows)
    from gesture2vec_tpu_torch.infer import exporter
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.utils import flops
    from gesture2vec_tpu_torch.utils.profiling import (StageTimer, annotate,
                                                       trace)

    layout = repo_test_module("torch_reference_layout")
    root, stores, ckpts = done["root"], done["stores"], done["ckpts"]
    misc = done["misc_ckpts"]
    tdir = os.path.join(root, "tools")
    os.makedirs(tdir, exist_ok=True)
    timer = StageTimer(sync=True)
    counts, problems = {}, []

    # -- the phase's corpus: data_pipe.json, transcripts, motion ---------
    with timer.stage("make_dataset"):
        repo_test_module("fixtures")
        n_files, n_src = TOOLS_CORPUS
        corpus = repo_test_module("corpus").make_corpus(
            os.path.join(tdir, "corpus"), n_files=n_files, n_frames=n_src,
            fps=60, with_audio=False)
        make_dataset.main([corpus, "--out", os.path.join(tdir, "ingested"),
                           "--no-audio"])
    pipe = os.path.join(tdir, "ingested", "data_pipe.json")

    with kernel_shapes() as shapes:
        # -- 1. the round trip through the reference layout --------------
        imported, trees = {}, {}
        for run, kind in TOOLS_IMPORTS:
            src = load_checkpoint(ckpts[run])
            pt = os.path.join(tdir, f"{run}.pt")
            imported[run] = os.path.join(tdir, f"{run}_imported.bin")
            with timer.stage("import_checkpoint"):
                write_reference_checkpoint(pt, src, kind, layout)
                tools.main(["import-checkpoint", pt, imported[run],
                            "--kind", kind])
            got = load_checkpoint(imported[run])
            # leaves the reference has no counterpart of, kept from the
            # source by merge_params
            unmatched = sorted("/".join(p) for p in set(tree_leaves(
                src["params"])) - set(tree_leaves(got["params"])))
            merged = merge_params(src["params"], got["params"])
            trees[run] = {
                "kind": kind, "pt_bytes": os.path.getsize(pt),
                "leaves": len(tree_leaves(got["params"])),
                "unmatched_leaves": unmatched,
                "params_differing": same_bits(merged, src["params"]),
                "batch_stats_differing": same_bits(
                    got["extra"].get("batch_stats", {}),
                    src["extra"].get("batch_stats", {})),
                "header": [got["kind"], got["epoch"], got["pose_dim"]],
                "source_header": [kind, src["epoch"], src["pose_dim"]],
                "n_words": [got["extra"].get("n_words"),
                            src["extra"].get("n_words")]}
            t = trees[run]
            if t["params_differing"] or t["batch_stats_differing"] or \
                    t["header"] != t["source_header"] or \
                    t["n_words"][0] != t["n_words"][1] or unmatched:
                problems.append(f"import {run}: {t}")
        emit({"phase": "main", "path": "tools", "run": "import_checkpoint",
              "command": "python -m gesture2vec_tpu_torch.cli.tools "
                         "import-checkpoint ref.pt out.bin --kind KIND",
              "imports": trees, "card": smi})

        # g2v-infer over the imported files and the originals
        transcript = write_transcript(os.path.join(tdir, "t60.json"),
                                      TOOLS_DECODE_S, 5)

        def g2v_infer(files, dev, name):
            argv = [files["d_gru"], transcript, files["a"],
                    files["b_gssoft"], "--store", stores[0], "--pipeline",
                    pipe, "--mode", "decode", "--out",
                    os.path.join(tdir, name + ".bvh"), "--device", dev]
            reset_launches()
            with timer.stage("g2v_infer_" + name):
                (frames, toks, _), = cli_infer.main(argv)
            counts["g2v_infer_" + name] = read_launches()
            return frames, toks

        n_win = int(np.ceil(TOOLS_DECODE_S / (SENT_LEN / FPS)))
        imp = g2v_infer(imported, "cuda", "imported")
        orig = g2v_infer(ckpts, "cuda", "original")
        imp_cpu = g2v_infer(imported, "cpu", "imported_cpu")
        cmp = compare_runs(imp, imp_cpu, lambda: token_margins(
            build_generator(imported["d_gru"], imported["a"],
                            imported["b_gssoft"], ClipStore(stores[0]),
                            mode="decode", device="cpu", seed=0)[0],
            [TOOLS_DECODE_S], 5)[TOOLS_DECODE_S])
        decode = {"windows": n_win, "frames": list(imp[0].shape),
                  "finite": bool(np.isfinite(imp[0]).all()),
                  "imported_vs_original_tokens_identical": bool(
                      np.array_equal(imp[1], orig[1])),
                  "imported_vs_original_max_abs_err": float(np.abs(
                      imp[0] - orig[0]).max()),
                  "card_vs_cpu": cmp}
        # a decode request of any length: one chunk-decoder rollout and
        # the GRU text encoder's two bidirectional layers (the traced
        # request below too)
        want = {"chunk_decoder": 1, "gru_sequence": 4,
                "gru_sequence_backward": 0, "vq_argmin": 0}
        emit({"phase": "main", "path": "tools", "run": "g2v_infer_decode",
              "seconds": TOOLS_DECODE_S, **decode, "want_launches": want,
              "launches": {k: counts["g2v_infer_" + k] for k in (
                  "imported", "original")}, "tol": TOL, "card": smi})
        if imp[0].shape != (n_win * SENT_LEN, DIM) or not decode["finite"] \
                or not decode["imported_vs_original_tokens_identical"] \
                or not decode["imported_vs_original_max_abs_err"] <= TOL \
                or not cmp["ok"]:
            problems.append(f"g2v-infer over the imported files: {decode}")
        for name in ("imported", "original"):
            if counts["g2v_infer_" + name] != want:
                problems.append(f"g2v-infer {name}: launches "
                                f"{counts['g2v_infer_' + name]}, want "
                                f"{want}")

        # the validation store's windows through the imported tokenizer
        b_cfg = load_config(load_checkpoint(ckpts["b_gssoft"])["config"])
        train_store = ClipStore(stores[0])
        wins = pose_windows(ClipStore(stores[1]), b_cfg.n_poses,
                            b_cfg.subdivision_stride, train_store.pose_mean,
                            train_store.pose_std)
        tok = {}
        for side, dev in (("card", "cuda"), ("cpu", "cpu")):
            dae, _ = load_checkpoint_and_model(imported["a"], "DAE", dev)
            seq, _ = load_checkpoint_and_model(imported["b_gssoft"],
                                               "autoencoder_vq", dev)
            reset_launches()
            with timer.stage("tokenize_" + side):
                lat = encode_windows_with_dae(dae, wins)
                tok[side] = (*tokenize_windows(seq, lat), lat)
            counts.setdefault("tokenize", read_launches())
        (t_card, s_card, _), (t_cpu, s_cpu, l_cpu) = tok["card"], tok["cpu"]
        with torch.inference_mode():
            hid_cpu = seq.encode_hidden(torch.from_numpy(l_cpu))
        differ, ties = gssoft_near_ties(seq, hid_cpu, t_card, t_cpu)
        batches = -(-len(wins) // 512)
        tokenize = {"windows": len(wins), "batches": batches,
                    "tokens_differing": differ, "near_ties": ties,
                    "tie_margin": GSSOFT_TIE,
                    "distinct_tokens": int(len(np.unique(t_card))),
                    "seq_latents_max_abs_err": float(np.abs(
                        s_card - s_cpu).max()),
                    "launches": counts["tokenize"],
                    "want_launches": {"chunk_decoder": 0,
                                      "gru_sequence": 2 * batches,
                                      "gru_sequence_backward": 0,
                                      "vq_argmin": 0}}
        emit({"phase": "main", "path": "tools", "run": "imported_tokenizer",
              **tokenize, "tol": TOL, "card": smi})
        if differ != ties or not tokenize["seq_latents_max_abs_err"] <= TOL \
                or tokenize["launches"] != tokenize["want_launches"]:
            problems.append(f"imported tokenizer: {tokenize}")

        # -- 2. baseline-infer and c2g-samples, card against CPU ------------
        seen, real = [], exporter.frames_to_bvh

        def recording(frames, fe, path=None):
            seen.append(np.array(frames))
            return real(frames, fe, path=path)

        bt = write_transcript(os.path.join(tdir, "t12.json"),
                              TOOLS_BASELINE_S, 6)
        n_clusters, per = TOOLS_C2G
        runs = {"baseline_infer": lambda side, dev: [
                    "baseline-infer", misc["baseline"], bt, "--store",
                    stores[0], "--pipeline", pipe, "--out",
                    os.path.join(tdir, f"baseline_{side}.bvh"), "--device",
                    dev],
                "c2g_samples": lambda side, dev: [
                    "c2g-samples", misc["c2g"], ckpts["a"], "--store",
                    stores[0], "--pipeline", pipe, "--out",
                    os.path.join(tdir, f"c2g_{side}"), "--clusters",
                    str(n_clusters), "--per-cluster", str(per), "--device",
                    dev]}
        n_windows = len(range(0, int(TOOLS_BASELINE_S * FPS) - N_FRAMES + 1,
                              N_FRAMES - 4))
        wants = {"baseline_infer": {"chunk_decoder": 0,
                                    "gru_sequence": 4 * n_windows,
                                    "gru_sequence_backward": 0,
                                    "vq_argmin": 0},
                 "c2g_samples": {"chunk_decoder": 1, "gru_sequence": 2,
                                 "gru_sequence_backward": 0,
                                 "vq_argmin": 0}}
        exporter.frames_to_bvh = recording
        try:
            for name, argv in runs.items():
                out = {}
                for side, dev in (("card", "cuda"), ("cpu", "cpu")):
                    seen.clear()
                    reset_launches()
                    with timer.stage(f"{name}_{side}"):
                        ret = tools.main(argv(side, dev))
                    counts.setdefault(name, read_launches())
                    out[side] = (ret, np.stack(seen))
                (r_card, f_card), (r_cpu, f_cpu) = out["card"], out["cpu"]
                row = {"returned": [r_card if np.isscalar(r_card) else
                                    list(r_card.shape),
                                    r_cpu if np.isscalar(r_cpu) else
                                    list(r_cpu.shape)],
                       "exported": list(f_card.shape),
                       "finite": bool(np.isfinite(f_card).all()),
                       "max_abs_err_vs_cpu": float(np.abs(
                           f_card - f_cpu).max()),
                       "tol": TOL * max(1.0, float(np.abs(f_cpu).max())),
                       "launches": counts[name], "want_launches": wants[name]}
                if name == "baseline_infer":
                    row["windows"] = n_windows
                else:
                    row["files"] = len(glob.glob(os.path.join(
                        tdir, "c2g_card", "*", "*.bvh")))
                emit({"phase": "main", "path": "tools", "run": name, **row,
                      "card": smi})
                if not row["finite"] or f_card.shape != f_cpu.shape or \
                        not row["max_abs_err_vs_cpu"] <= row["tol"] or \
                        row["launches"] != row["want_launches"] or \
                        row.get("files", n_clusters * per) != \
                        n_clusters * per:
                    problems.append(f"{name}: {row}")
        finally:
            exporter.frames_to_bvh = real

        # -- 5. one profiler trace of a decode request ---------------------
        gen, _ = build_generator(imported["d_gru"], imported["a"],
                                 imported["b_gssoft"], train_store,
                                 mode="decode", device="cuda")
        gen.generate(words(TOOLS_TRACE_S, 7), TOOLS_TRACE_S)
        log_dir = os.path.join(tdir, "trace")
        reset_launches()
        with timer.stage("traced_decode"):
            with trace(log_dir):
                with annotate("g2v_decode_request"):
                    gen.generate(words(TOOLS_TRACE_S, 7), TOOLS_TRACE_S)
                torch.cuda.synchronize()
        counts["traced_decode"] = read_launches()
        files = glob.glob(os.path.join(log_dir, "*.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
        traced = {"files": [os.path.basename(f) for f in files],
                  "bytes": len(text),
                  "names_chunk_decode_kernel": "chunk_decode_kernel" in text,
                  "names_gru_sequence_kernel": "gru_sequence_kernel" in text,
                  "names_annotation": "g2v_decode_request" in text,
                  "launches": counts["traced_decode"], "want_launches": want}
        emit({"phase": "main", "path": "tools", "run": "trace", **traced,
              "card": smi})
        if len(files) != 1 or not traced["names_chunk_decode_kernel"] or \
                not traced["names_gru_sequence_kernel"] or \
                not traced["names_annotation"] or \
                traced["launches"] != want:
            problems.append(f"trace: {traced}")

    # -- 3. unityfy and human-study on the host ----------------------------
    with timer.stage("unityfy"):
        unity = tools.main(["unityfy", os.path.join(corpus, "Transcripts"),
                            "--out", os.path.join(tdir, "unity")])
    motion = sorted(glob.glob(os.path.join(corpus, "Motion", "*.bvh")))[0]
    with timer.stage("human_study"):
        study = tools.main([
            "human-study", motion, os.path.join(
                corpus, "Transcripts", os.path.basename(motion)[:-4]
                + ".json"), "--out", os.path.join(tdir, "study")])
    host = {"unityfy_files": len(unity), "human_study_clips": len(study),
            "human_study_files": len(os.listdir(os.path.join(tdir,
                                                             "study")))}
    emit({"phase": "main", "path": "tools", "run": "host_tools", **host,
          "card": smi})
    want_clips = int(n_src / 60 // 6)
    if host != {"unityfy_files": n_files, "human_study_clips": want_clips,
                "human_study_files": 2 * want_clips}:
        problems.append(f"host tools: {host}")

    # -- 4. MFU of the train path's steps ---------------------------------
    mfu = {}
    for run in TOOLS_MFU_RUNS:
        row = done["runs"][run]
        cfg = load_config(load_checkpoint(ckpts[run])["config"])
        fwd = mfu_forward_flops(run, cfg, row["batch"])
        secs = 1.0 / row["steps_per_s"]
        mfu[run] = {"batch": row["batch"], "forward_flops": fwd,
                    "step_flops": 3 * fwd, "steps_per_s": row["steps_per_s"],
                    "mfu_bf16": flops.mfu(3 * fwd, secs),
                    "mfu_fp32": flops.mfu(3 * fwd, secs,
                                          flops.H100_PEAK_FP32)}
    emit({"phase": "mfu", "path": "tools", "runs": mfu,
          "peaks": {"bf16": flops.H100_PEAK_BF16,
                    "fp32": flops.H100_PEAK_FP32},
          "step_flops": "3x the analytic forward (utils/flops)",
          "card": smi})

    # -- check ---------------------------------------------------------------
    compared = compared_shapes()
    compared["gru_sequence"] |= {(T, B, HID) for T, B in MISC_GRU_SHAPES}
    compared["chunk_decoder"] |= set(MISC_DECODER_SHAPES)
    for name, counter in shapes.items():
        missing = sorted(set(counter) - compared[name])
        if missing:
            problems.append(f"{name}: shapes {missing} not compared with "
                            f"the plain version")
    emit({"phase": "timing", "path": "tools", "stages": timer.report()
          .splitlines(), "stages_s": timer.totals, "card": smi})
    emit({"phase": "check", "path": "tools", "launches": counts,
          "kernel_shapes": {name: [[list(k), v] for k, v in sorted(
              c.items())] for name, c in shapes.items()},
          "tol": TOL, "problems": problems})
    if problems:
        raise AssertionError(f"tools check failed: {problems}")
    return counts


def tf_part_c_path(smi: str, tmp: str, files: dict) -> dict:
    """The Part-c sweep with `seq_arch: transformer` tokenizers written as
    the JAX package's checkpoints: the GS-Soft sweep over the 244-minute
    store with K-Means (K=300) on its sequence latents, and the 4-stage
    residual-VQ sweep with all stage tokens. Checks: launches (no
    `gru_sequence`), the residual tokens of the kernel path against the
    plain path on the card, and the card against the CPU on the first
    windows."""
    import torch

    from gesture2vec_tpu_torch.cluster import kmeans as km
    from gesture2vec_tpu_torch.cluster.latent_dataset import \
        build_latent_dataset
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.data.teacher import (encode_windows_with_dae,
                                                    tokenize_windows)

    (vq_p, vq_s), (rvq_p, rvq_s) = tf_tokenizer_trees(
        np.random.default_rng(1))
    extras = {"extras": {"seq_arch": "transformer"}}
    ckpt = {"gssoft": os.path.join(tmp, "tf_vq.bin"),
            "rvq": os.path.join(tmp, "tf_rvq.bin")}
    write_checkpoint(ckpt["gssoft"], {**VQ_ARGS, "name": "VQVAE_tf",
                                      **extras}, vq_p, vq_s,
                     "autoencoder_vq", REP)
    write_checkpoint(ckpt["rvq"], {**RVQ_ARGS, "name": "VQVAE_rvq_tf",
                                   **extras}, rvq_p, rvq_s,
                     "autoencoder_vq", REP)
    dae, _ = load_checkpoint_and_model(files["dae"], "DAE")
    seqs = {v: load_checkpoint_and_model(p, "autoencoder_vq")[0]
            for v, p in ckpt.items()}
    if any(m.encoder_arch != "transformer" for m in seqs.values()):
        raise AssertionError("the tokenizers' encoders are not transformers")
    store = ClipStore(files["train"])
    stride = {"gssoft": VQ_ARGS["subdivision_stride"],
              "rvq": RVQ_ARGS["subdivision_stride"]}
    stages = RVQ_ARGS["rvq_stages"]

    def sweep(v):
        return build_latent_dataset(store, dae_model=dae, seq_model=seqs[v],
                                    n_poses=20, stride=stride[v],
                                    all_stages=v == "rvq")

    counts, data = {}, {}
    for v in ("gssoft", "rvq"):
        reset_launches()
        data[v] = sweep(v)
        counts[v] = read_launches()
    reset_launches()
    fit = km.kmeans_fit(data["gssoft"]["seq_latents"], PC_KMEANS, seed=0)
    counts["kmeans"] = read_launches()
    n = {v: data[v]["tokens"].shape[0] for v in data}
    want = {"gssoft": {"chunk_decoder": 0, "gru_sequence": 0,
                       "gru_sequence_backward": 0, "vq_argmin": 0},
            "rvq": {"chunk_decoder": 0, "gru_sequence": 0,
                    "gru_sequence_backward": 0,
                    "vq_argmin": stages * math.ceil(n["rvq"] / 512)},
            "kmeans": {"chunk_decoder": 0, "gru_sequence": 0,
                       "gru_sequence_backward": 0,
                       "vq_argmin": sum(fit.n_iter) + len(fit.n_iter)}}
    distinct = {"gssoft": int(len(np.unique(data["gssoft"]["tokens"]))),
                "rvq": [int(len(np.unique(data["rvq"]["tokens"][:, s])))
                        for s in range(stages)]}
    emit({"phase": "main", "path": "tf_part_c", "launches": counts,
          "want": want, "windows": n, "distinct_codes": distinct,
          "kmeans_lloyd_steps": fit.n_iter,
          "kmeans_inertia": float(fit.inertia)})
    if counts != want or distinct["gssoft"] < 2 or min(distinct["rvq"]) < 2 \
            or data["rvq"]["tokens"].shape != (n["rvq"], stages):
        raise AssertionError(f"transformer-tokenizer sweep: launches "
                             f"{counts}, want {want}; codes {distinct}")

    # -- timing -------------------------------------------------------
    lat = {v: data[v]["dae_latents"] for v in data}
    timing = {}
    for v in ("gssoft", "rvq"):
        s_sweep = best_s(lambda: sweep(v), reps=2)
        timing[v] = {"windows": n[v], "sweep_s": s_sweep,
                     "sweep_windows_per_s": n[v] / s_sweep,
                     "tokenize_s": best_s(lambda: tokenize_windows(
                         seqs[v], lat[v], all_stages=v == "rvq"), reps=2)}
    timing["gssoft"]["device_busy"] = device_busy(
        lambda: sweep("gssoft"), timing["gssoft"]["sweep_s"])
    emit({"phase": "timing", "path": "tf_part_c", **timing, "card": smi})

    # -- check: kernel path against plain path, card against CPU -------
    rvq = seqs["rvq"]
    rvq.set_use_kernels(False)
    plain = tokenize_windows(rvq, lat["rvq"], all_stages=True)[0]
    rvq.set_use_kernels(True)
    k_rows, k_ties = rvq_near_ties(rvq, lat["rvq"], data["rvq"]["tokens"],
                                   plain)
    dae_c, _ = load_checkpoint_and_model(files["dae"], "DAE", "cpu")
    cpu = {}
    for v, path in ckpt.items():
        seq_c, _ = load_checkpoint_and_model(path, "autoencoder_vq", "cpu")
        lat_c = encode_windows_with_dae(
            dae_c, data[v]["windows"][:CPU_WINDOWS])
        toks_c, seq_lat_c = tokenize_windows(seq_c, lat_c,
                                             all_stages=v == "rvq")
        err = max(float(np.abs(lat[v][:CPU_WINDOWS] - lat_c).max()),
                  float(np.abs(data[v]["seq_latents"][:CPU_WINDOWS]
                               - seq_lat_c).max()))
        if v == "gssoft":
            with torch.inference_mode():
                hid_c = seq_c.encode_hidden(torch.from_numpy(lat_c))
            rows, ties = gssoft_near_ties(
                seq_c, hid_c, data[v]["tokens"][:CPU_WINDOWS], toks_c)
        else:
            rows, ties = rvq_near_ties(rvq, lat[v][:CPU_WINDOWS],
                                       data[v]["tokens"][:CPU_WINDOWS],
                                       toks_c)
        cpu[v] = {"windows": CPU_WINDOWS, "tokens_differing": rows,
                  "near_ties": ties, "max_abs_err": err}
    result = {"phase": "check", "path": "tf_part_c",
              "rvq_kernel_vs_plain": {"windows_differing": k_rows,
                                      "near_ties": k_ties},
              "card_vs_cpu": cpu, "tol": TOL, "near_tie_gap": NEAR_TIE,
              "gssoft_tie_margin": GSSOFT_TIE}
    emit(result)
    if k_rows != k_ties or any(c["tokens_differing"] != c["near_ties"]
                               or not c["max_abs_err"] <= TOL
                               for c in cpu.values()):
        raise AssertionError(f"transformer-tokenizer check failed: {result}")
    return counts


# -- the audio-context family --------------------------------------------
def synthetic_speech(seconds: float, seed: int = 0) -> np.ndarray:
    """Speech-like audio at 16 kHz from a seed: two tones and noise,
    amplitude-modulated at a syllable rate (3-5 Hz), so that the mel
    chunks differ from second to second."""
    rng = np.random.default_rng(seed)
    n = int(seconds * AUDIO_SR)
    f0, f1, syl = rng.uniform(100, 200), rng.uniform(600, 1200), \
        rng.uniform(3, 5)
    out = np.empty(n, np.float32)
    step = 1 << 22
    for a in range(0, n, step):
        t = np.arange(a, min(a + step, n)) / AUDIO_SR
        carrier = np.sin(2 * np.pi * f0 * t) \
            + 0.5 * np.sin(2 * np.pi * f1 * t) \
            + 0.3 * rng.normal(size=t.shape)
        out[a:a + len(t)] = 0.3 * carrier * (
            0.5 + 0.5 * np.sin(2 * np.pi * syl * t))
    return out


def audio_trees(rng: np.random.Generator, fusion: str = "audio") -> dict:
    """Random configs/audio.yml-width Audio2Token variables in the JAX
    package's layout (numpy): the mel encoder (fusion "audio") or the
    word + raw-chunk encoder ("both", the 5000 x 300 word table), its
    2-layer BiGRU at hidden 200, and a token decoder drawn as the decode
    path's (512 codes, attention); uniform in +-1/sqrt(fan_in), BatchNorm
    scale near 1 and statistics near (0, 1)."""
    from gesture2vec_tpu_torch.models.audio import (SPECTRAL_SPECS,
                                                   TRI_SPECS, conv_length)

    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, size=shape).astype(np.float32)

    def bn(c):
        return ({"scale": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
                 "bias": (0.1 * rng.normal(size=c)).astype(np.float32)},
                {"mean": (0.1 * rng.normal(size=c)).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, size=c).astype(np.float32)})

    both = fusion == "both"
    specs, in_ch = (TRI_SPECS, 1) if both else (SPECTRAL_SPECS, 128)
    wav, stats = {}, {}
    for i, (ch, k, _, _) in enumerate(specs):
        wav[f"conv{i}"] = {"kernel": u((k, in_ch, ch), k * in_ch),
                           "bias": u((ch,), k * in_ch)}
        if i < 3:
            wav[f"bn{i}"], stats[f"bn{i}"] = bn(ch)
        in_ch = ch
    if both:
        n_in = conv_length(AUDIO_SR, TRI_SPECS) * in_ch
        wav["out_layer"] = {"kernel": u((n_in, HID), n_in),
                            "bias": u((HID,), n_in)}
    else:
        n_in = conv_length(32, SPECTRAL_SPECS) * in_ch
        wav["fc"] = {"kernel": u((n_in, HID), n_in), "bias": u((HID,), n_in)}
        wav["fc_bn"], stats["fc_bn"] = bn(HID)
    gru = {}
    for layer in range(L):
        d = (WORDEMBED + HID if both else HID) if layer == 0 else 2 * HID
        for sfx in ("", "_reverse"):
            gru.update({f"l{layer}_w_ih{sfx}": u((3 * HID, d), HID),
                        f"l{layer}_w_hh{sfx}": u((3 * HID, HID), HID),
                        f"l{layer}_b_ih{sfx}": u((3 * HID,), HID),
                        f"l{layer}_b_hh{sfx}": u((3 * HID,), HID)})
    enc = {"wav_encoder": wav, "gru": gru}
    if both:
        enc["embedding"] = {"embedding": (rng.normal(size=(
            N_WORDS, WORDEMBED)) / np.sqrt(WORDEMBED)).astype(np.float32)}
    t2t, _, _ = jax_layout_trees(rng)
    return {"params": {"encoder": enc,
                       "decoder_step": t2t["params"]["decoder_step"]},
            "batch_stats": {"encoder": {"wav_encoder": stats},
                            "decoder_step": t2t["batch_stats"]
                            ["decoder_step"]}}


def audio_kernel_rows(folded, gru_w) -> dict:
    """Both kernels at the shapes the audio path gives them, against
    their plain versions: the GRU sequence at each of AUDIO_GRU_SHAPES
    (T=6: one step a second of a 6 s window; T=48: the fusion encoder's
    word window), both directions, with cuDNN's layer and the matmul plus
    the kernel beside it; the chunk decoder at AUDIO_DECODER_SHAPES (the
    60 s and 1800 s chunk batches, 20 steps and 24 with decode_overlap
    4)."""
    import torch

    from gesture2vec_tpu_torch.models.gru import gru_layer
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    g = torch.Generator(device="cuda").manual_seed(13)
    rows = {"chunk_decoder": {}, "gru_sequence": {}}
    for B, n in AUDIO_DECODER_SHAPES:
        x0 = torch.randn(B, REP, device="cuda", generator=g)
        h0 = torch.randn(2, B, HID, device="cuda", generator=g)
        ys = dk.fused_chunk_decode(x0, h0, folded, n)
        ref = dk.fused_chunk_decode_plain(x0, h0, folded, n)
        torch.cuda.synchronize()
        row = {"phase": "kernel", "path": "audio", "kernel": "chunk_decoder",
               "B": B, "H": HID, "D": REP, "n_steps": n,
               "launch": decoder_launch(B, HID, REP),
               "max_abs_err": (ys - ref).abs().max().item(), "tol": TOL,
               "ms": cuda_ms(lambda: dk.fused_chunk_decode(x0, h0, folded,
                                                           n), 20),
               "plain_ms": cuda_ms(lambda: dk.fused_chunk_decode_plain(
                   x0, h0, folded, n), 10),
               "library_ms": None,
               **chunk_decoder_bound_ms(B, REP, HID, n)}
        emit(row)
        rows["chunk_decoder"][f"audio_B{B}_T{n}"] = row
    w_ih, w_hh, b_ih, b_hh = gru_w
    cudnn = torch.nn.GRU(w_ih.shape[1], HID, 1).cuda()
    with torch.no_grad():
        for prm, v in ((cudnn.weight_ih_l0, w_ih), (cudnn.weight_hh_l0, w_hh),
                       (cudnn.bias_ih_l0, b_ih), (cudnn.bias_hh_l0, b_hh)):
            prm.copy_(v)
    with torch.inference_mode():
        for T, B in AUDIO_GRU_SHAPES:
            xs = torch.randn(T, B, w_ih.shape[1], device="cuda", generator=g)
            h0 = torch.zeros(B, HID, device="cuda")
            xp = (xs.reshape(-1, xs.shape[2]) @ w_ih.t() + b_ih).reshape(
                T, B, -1)
            err = 0.0
            for reverse in (False, True):
                ys, h = gk.gru_sequence(xp, h0, w_hh, b_hh, reverse)
                ys_p, h_p = gk.gru_sequence_plain(xp, h0, w_hh, b_hh,
                                                  reverse)
                torch.cuda.synchronize()
                err = max(err, (ys - ys_p).abs().max().item(),
                          (h - h_p).abs().max().item())
            y_c, h_c = cudnn(xs, h0[None])
            y_k, h_k = gru_layer(xs, h0, w_ih, w_hh, b_ih, b_hh)
            row = {"phase": "kernel", "path": "audio",
                   "kernel": "gru_sequence", "T": T, "B": B, "H": HID,
                   "directions": 2, "launch": gru_launch(B, HID),
                   "max_abs_err": err, "tol": TOL,
                   "ms": cuda_ms(lambda: gk.gru_sequence(xp, h0, w_hh,
                                                         b_hh), 20),
                   "plain_ms": cuda_ms(lambda: gk.gru_sequence_plain(
                       xp, h0, w_hh, b_hh), 5),
                   **gru_bound_ms(T, B, HID),
                   # cuDNN computes the input product too: its yardstick
                   # is the matmul plus the kernel
                   "library_ms": cuda_ms(lambda: cudnn(xs, h0[None]), 20),
                   "matmul_plus_kernel_ms": cuda_ms(lambda: gru_layer(
                       xs, h0, w_ih, w_hh, b_ih, b_hh), 20),
                   "cudnn_max_abs_err": max(
                       (y_c - y_k).abs().max().item(),
                       (h_c[0] - h_k).abs().max().item())}
            emit(row)
            rows["gru_sequence"][f"T{T}_B{B}"] = row
    bad = [r for k in rows.values() for r in k.values()
           if not r["max_abs_err"] <= TOL]
    if bad:
        raise AssertionError(f"kernels at the audio path's shapes: {bad}")
    return rows


def decode_margins(model, args, mask, beam: int, temperature: float,
                   top_k: int, stage0_temperature: float, gumbel):
    """One window's decode by a token model (args = (encoder outputs,
    decoder hidden, seed), one row) and its decision margins (n_steps -
    1,): at each step the smallest gap between the best and the
    second-best score of any choice made; greedy and sampled scores from
    the logits through `decision_scores`, beam's from its step scores
    (the K-th against the (K+1)-th, and at the last step the best
    hypothesis' lead). Returns (the decode, the margins)."""
    import torch

    from gesture2vec_tpu_torch.models.text2token import decision_scores

    def gap(scores):
        top = torch.topk(scores, 2, dim=-1).values
        return top[..., 0] - top[..., 1]

    if beam:
        res = model.beam_decode(*args, beam, mask)
        s = res["step_scores"][0]
        m = s[:, beam - 1] - s[:, beam]
        if beam > 1:
            m[-1] = torch.minimum(m[-1], s[-1, 0] - s[-1, 1])
        return res, m
    t0 = temperature if stage0_temperature < 0.0 else stage0_temperature
    res = model.decode_tokens(*args, mask, temperature=temperature,
                              top_k=top_k,
                              stage0_temperature=stage0_temperature,
                              gumbel=gumbel)
    m = gap(decision_scores(res["logits"][:, 1:], t0, top_k, None
                            if gumbel is None else gumbel[:, :, 0]))[0]
    if "stage_logits" in res:
        m = torch.minimum(m, gap(decision_scores(
            res["stage_logits"], temperature, top_k,
            None if gumbel is None else gumbel[:, :, 1:]))[0]
            .min(dim=-1).values)
    return res, m


def audio_margins(gen, audio: np.ndarray, d: float, words_=None
                  ) -> np.ndarray:
    """token_margins for a fresh AudioGestureGenerator's first request:
    (windows, n_steps - 1), the windows replayed as `generate` decodes
    them, on the request's own noise."""
    import torch

    a2t, n_pre = gen.a2t_model, gen.a2t_model.n_pre
    W = max(int(np.ceil(d / (SENT_LEN / FPS))), 1)
    with torch.inference_mode():
        enc_in = gen.encoder_inputs(audio, W, words_)
        noise = gen._noise(gen._next_generator(), (1, W))
        eo, dh = a2t.encode_audio(enc_in)
        seed = torch.zeros((1, gen.n_steps), dtype=torch.long,
                           device=eo.device)
        per = []
        for w in range(W):
            res, m = decode_margins(
                a2t, (eo[:, w:w + 1], dh[:, w:w + 1], seed), None,
                gen._beam, gen.temperature, gen.top_k, -1.0,
                None if noise is None else noise[:, w])
            per.append(m)
            seed = torch.zeros_like(seed)
            seed[:, :n_pre] = res["tokens"][:, -n_pre:]
        return torch.stack(per).cpu().numpy()


def audio_stage_split(gen, audio: np.ndarray, d: float, reps: int = 2,
                      words_=None) -> dict:
    """Host seconds of one request's stages (best of reps, each timed
    alone on synchronised work): the encoder inputs (the mel frontend on
    the host, or the raw chunks and word ids, and the copy to the card),
    the batched encode, the encode with the token decode (noise
    included), and the chunk rollout with the DAE decode (or the picks,
    gather and DAE decode) to host frames."""
    import torch

    W = max(int(np.ceil(d / (SENT_LEN / FPS))), 1)
    out = {"mel_frontend": best_s(lambda: gen.encoder_inputs(
        audio, W, words_), reps)}
    enc_in = gen.encoder_inputs(audio, W, words_)
    with torch.inference_mode():
        def tokens():
            return gen._predict(enc_in, gen._noise(gen._next_generator(),
                                                   (1, W)))
        out["encode"] = best_s(lambda: gen.a2t_model.encode_audio(enc_in),
                               reps)
        out["encode_and_tokens"] = best_s(tokens, reps)
        pred = tokens()
        out["decode_and_dae"] = best_s(lambda: gen._motion(pred), reps)
    return out


def audio_path(smi: str, tmp: str, files: dict) -> tuple:
    """The audio Part d (configs/audio.yml: hidden 200, 2 layers, 512
    codes, attention, 6 one-second mel chunks a window) over Part c's DAE
    and GS-Soft tokenizer: random weights written as an audio2token
    checkpoint in the JAX package's format and loaded through
    compat/from_jax; synthetic speech from seeds. Decode mode at 6 s, 60 s
    and 1800 s; exemplar mode over the cluster CLI's bank with and without
    continuity at 60 s; at 60 s the decode policies (sampled, beam 4,
    soft 1.0, overlap 4) and `audio_fusion: both` with words; 8 streaming
    sessions sharing one step; `cli/infer_audio` to a BVH. Returns (the
    kernel rows, launches by run)."""
    import torch
    from scipy.io import wavfile

    from gesture2vec_tpu_torch.cli import infer_audio
    from gesture2vec_tpu_torch.cluster.latent_dataset import \
        load_latent_dataset
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.infer.audio2gesture import \
        AudioGestureGenerator
    from gesture2vec_tpu_torch.infer.streaming import (
        AudioStreamingGestureSession, build_audio_streaming_step)
    from gesture2vec_tpu_torch.io.bvh import parse_bvh
    from gesture2vec_tpu_torch.ops.decoder_kernel import fold_decoder_step
    from gesture2vec_tpu_torch.text.vocab import Vocab

    vocab = Vocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    rng = np.random.default_rng(21)
    ckpts = {}
    for fusion in ("audio", "both"):
        tree = audio_trees(rng, fusion)
        ckpts[fusion] = os.path.join(tmp, f"a2t_{fusion}.bin")
        write_checkpoint(ckpts[fusion], {**AUDIO_ARGS, "audio_fusion": fusion},
                         tree["params"], tree["batch_stats"], "audio2token",
                         K, lang_model=vocab.state_dict()
                         if fusion == "both" else None, n_words=N_WORDS)
    store = ClipStore(files["train"])
    bank = load_latent_dataset(files["bank"])
    models = {}

    def make(device, kernels=True, fusion="audio", mode="decode",
             **policy):
        key = (device, fusion)
        if key not in models:
            models[key] = (
                load_checkpoint_and_model(ckpts[fusion], "audio2token",
                                          device)[0],
                load_checkpoint_and_model(files["vq"], "autoencoder_vq",
                                          device)[0].decoder,
                load_checkpoint_and_model(files["dae"], "DAE", device)[0])
        a2t, seq, dae = models[key]
        a2t.set_use_kernels(kernels)
        return AudioGestureGenerator(
            a2t_model=a2t, seq_decoder=seq, dae_model=dae,
            pose_mean=store.pose_mean, pose_std=store.pose_std,
            n_frames=N_FRAMES, sentence_frame_length=SENT_LEN, fps=FPS,
            mode=mode, latent_bank=bank if mode == "exemplar" else None,
            seed=0, vocab=vocab if fusion == "both" else None,
            max_words=MAXW, use_fused_decoder=kernels, device=device,
            **policy)

    gen = make("cuda")
    enc = gen.a2t_model.encoder.gru
    rows = audio_kernel_rows(fold_decoder_step(gen.seq_decoder.decoder_step),
                             [t.detach() for t in enc.layer_weights(0,
                                                                    False)])
    audios = {d: synthetic_speech(d, 1) for d in AUDIO_REQUESTS_S}
    d60 = AUDIO_POLICY_S
    unit = SENT_LEN / FPS
    launches, problems = {}, []

    def want(mode, n_windows=1):
        return {"chunk_decoder": int(mode == "decode") * n_windows,
                "gru_sequence": 4 * n_windows, "gru_sequence_backward": 0,
                "vq_argmin": 0}

    def check_frames(name, d, out):
        n_windows = max(int(np.ceil(d / unit)), 1)
        frames, toks = out
        if frames.shape != (n_windows * SENT_LEN, DIM) \
                or toks.shape != (n_windows * SENT_LEN // N_FRAMES,) \
                or not np.isfinite(frames).all():
            problems.append(f"{name} {d} s: frames {frames.shape}, tokens "
                            f"{toks.shape}")

    def request(g, d, name, fusion="audio"):
        """One request with its launches, and the chunk and GRU shapes."""
        w = words(d) if fusion == "both" else None
        torch.cuda.synchronize()
        reset_launches()
        out = g.generate(audios[d], d, words=w)
        torch.cuda.synchronize()
        got = read_launches()
        check_frames(name, d, out)
        return out, got

    with kernel_shapes() as shapes:
        # -- decode mode at 6 s, 60 s, 1800 s ------------------------------
        outs, per_request = {}, {}
        for d in AUDIO_REQUESTS_S:
            outs[d], per_request[d] = request(gen, d, "decode")
        launches["decode"] = {k: sum(c[k] for c in per_request.values())
                              for k in launch_counters()}
        module = make("cuda", kernels=False)
        vs_module = {d: compare_runs(
            outs[d], module.generate(audios[d], d),
            lambda d=d: audio_margins(make("cuda", kernels=False),
                                      audios[d], d)) for d in outs}
        make("cuda")                 # the kernels back on
        vs_cpu = compare_runs(
            make("cuda").generate(audios[d60], d60),
            make("cpu").generate(audios[d60], d60),
            lambda: audio_margins(make("cpu"), audios[d60], d60))
        timing = {}
        for d in AUDIO_REQUESTS_S:
            long = d >= 1800
            secs = best_s(lambda: gen.generate(audios[d], d),
                          reps=1 if long else 2)
            timing[d] = {"seconds": secs,
                         "frames_per_s": outs[d][0].shape[0] / secs,
                         "stages_s": audio_stage_split(
                             gen, audios[d], d, reps=1 if long else 2)}
        d_long = AUDIO_REQUESTS_S[-1]
        timing[d_long]["device_busy"] = device_busy(
            lambda: gen.generate(audios[d_long], d_long),
            timing[d_long]["seconds"])
        want_decode = {d: want("decode") for d in AUDIO_REQUESTS_S}
        emit({"phase": "audio", "run": "decode", "requests_s":
              list(AUDIO_REQUESTS_S), "launches_per_request": per_request,
              "want": want_decode, "kernel_vs_module": vs_module,
              "card_vs_cpu_60s": vs_cpu, "tol": TOL,
              "near_tie_margin": LOGIT_TIE,
              "distinct_tokens_1800s": int(len(np.unique(
                  outs[d_long][1]))), "timing": timing, "card": smi})
        if per_request != want_decode or not vs_cpu["ok"] \
                or not all(c["ok"] for c in vs_module.values()):
            problems.append("decode mode failed its checks")

        # -- exemplar mode at 60 s -----------------------------------------
        for cont in (False, True):
            name = "exemplar_continuity" if cont else "exemplar"
            g = make("cuda", mode="exemplar", exemplar_continuity=cont)
            out, got = request(g, d60, name)
            launches[name] = got
            runs = {}
            for dev in ("cuda", "cpu"):
                gd = make(dev, mode="exemplar", exemplar_continuity=cont)
                picks, pick = [], gd._picks
                gd._picks = lambda toks, pick=pick, picks=picks: \
                    picks.append(pick(toks)) or picks[-1]
                runs[dev] = (gd.generate(audios[d60], d60), picks[0])
            cmp = compare_runs(runs["cuda"][0], runs["cpu"][0],
                               lambda cont=cont: audio_margins(
                                   make("cpu", mode="exemplar",
                                        exemplar_continuity=cont),
                                   audios[d60], d60))
            cmp["picks_identical"] = bool(np.array_equal(runs["cuda"][1],
                                                         runs["cpu"][1]))
            secs = best_s(lambda: g.generate(audios[d60], d60))
            emit({"phase": "audio", "run": name, "request_s": d60,
                  "launches": got, "want": want("exemplar"),
                  "bank_windows": int(bank["tokens"].shape[0]),
                  "card_vs_cpu_60s": cmp, "tol": TOL,
                  "timing": {"seconds": secs,
                             "frames_per_s": out[0].shape[0] / secs,
                             "stages_s": audio_stage_split(g, audios[d60],
                                                           d60)},
                  "card": smi})
            if got != want("exemplar") or not cmp["ok"] or (
                    cmp["tokens_identical"] and not cmp["picks_identical"]):
                problems.append(f"{name} failed its checks")

        # -- the decode policies at 60 s -----------------------------------
        for name, fusion, policy in AUDIO_POLICIES:
            g = make("cuda", fusion=fusion, **policy)
            w = words(d60) if fusion == "both" else None
            out, got = request(g, d60, name, fusion)
            launches[name] = got
            first = make("cuda", fusion=fusion, **policy).generate(
                audios[d60], d60, words=w)
            vs_mod = compare_runs(
                first, make("cuda", False, fusion, **policy).generate(
                    audios[d60], d60, words=w),
                lambda: audio_margins(make("cuda", False, fusion, **policy),
                                      audios[d60], d60, w))
            make("cuda", fusion=fusion)
            cpu = compare_runs(
                first, make("cpu", fusion=fusion, **policy).generate(
                    audios[d60], d60, words=w),
                lambda: audio_margins(make("cpu", fusion=fusion, **policy),
                                      audios[d60], d60, w))
            secs = best_s(lambda: g.generate(audios[d60], d60, words=w))
            emit({"phase": "audio", "run": name, "fusion": fusion,
                  "options": policy, "request_s": d60, "launches": got,
                  "want": want("decode"), "kernel_vs_module_60s": vs_mod,
                  "card_vs_cpu_60s": cpu, "tol": TOL,
                  "near_tie_margin": LOGIT_TIE,
                  "timing": {"seconds": secs,
                             "frames_per_s": out[0].shape[0] / secs,
                             "stages_s": audio_stage_split(
                                 g, audios[d60], d60, words_=w)},
                  "card": smi})
            if got != want("decode") or not vs_mod["ok"] or not cpu["ok"]:
                problems.append(f"{name} failed its checks")

        # -- 8 streaming sessions sharing one step --------------------------
        step = build_audio_streaming_step(gen)
        streams = [synthetic_speech(d60, 100 + s)
                   for s in range(AUDIO_STREAMS)]
        sessions = [AudioStreamingGestureSession(gen, step=step)
                    for _ in streams]
        emitted = [[] for _ in streams]
        latencies = []
        torch.cuda.synchronize()
        reset_launches()
        t_all = time.perf_counter()
        for now in np.arange(2.0, d60 + 1e-9, 2.0):
            for s, sess in enumerate(sessions):
                t0 = time.perf_counter()
                got = sess.push(streams[s][:int(now * AUDIO_SR)], now)
                if got:
                    latencies.append((time.perf_counter() - t0) / len(got))
                emitted[s] += got
        for s, sess in enumerate(sessions):
            emitted[s] += sess.finish(d60)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
        got = read_launches()
        launches["streams"] = got
        n_win = sum(len(e) for e in emitted)
        worst, same = 0.0, True
        for s, e in enumerate(emitted):
            ref = gen.generate(streams[s], d60)
            frames = np.concatenate([f for f, _ in e])
            toks = np.concatenate([t for _, t in e])
            same = same and np.array_equal(toks, ref[1])
            worst = max(worst, float(np.abs(frames - ref[0]).max()))
        want_streams = want("decode", n_win)
        emit({"phase": "audio", "run": "streams", "sessions": AUDIO_STREAMS,
              "stream_s": d60, "windows": n_win, "launches": got,
              "want": want_streams, "tokens_equal_generate": same,
              "frames_vs_generate_max_abs_err": worst, "tol": TOL,
              "timing": {"seconds": wall, "windows_per_s": n_win / wall,
                         "window_latency_s": percentiles(latencies)},
              "card": smi})
        if got != want_streams or not same or not worst <= TOL:
            problems.append("streams failed their checks")

        # -- g2v-infer-audio at 60 s ----------------------------------------
        wav = os.path.join(tmp, "speech_60s.wav")
        wavfile.write(wav, AUDIO_SR, (audios[d60] * 32767).astype(np.int16))
        bvh = os.path.join(tmp, "audio_60s.bvh")
        pipe = os.path.join(tmp, "ingested", "data_pipe.json")
        reset_launches()
        t0 = time.perf_counter()
        frames, toks, path = infer_audio.main(
            [ckpts["audio"], wav, files["dae"], files["vq"], "--store",
             files["train"], "--pipeline", pipe, "--out", bvh,
             "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        got = read_launches()
        launches["cli"] = got
        with open(path) as f:
            parsed = parse_bvh(f.read(), from_text=True)
        check_frames("cli", d60, (frames, toks))
        emit({"phase": "audio", "run": "cli", "command":
              "python -m gesture2vec_tpu_torch.cli.infer_audio a2t.bin "
              "speech.wav dae.bin vq.bin --store train --pipeline "
              "data_pipe.json", "request_s": d60, "launches": got,
              "want": want("decode"), "seconds": cli_s,
              "bvh_frames": int(parsed.n_frames), "card": smi})
        if got != want("decode") or parsed.n_frames != frames.shape[0]:
            problems.append("g2v-infer-audio failed its checks")

    compared = compared_shapes()
    for name, counter in shapes.items():
        missing = sorted(set(counter) - compared[name])
        if missing:
            problems.append(f"{name}: shapes {missing} not compared with "
                            f"the plain version")
    emit({"phase": "check", "path": "audio", "kernel_shapes": {
        name: [[list(k), v] for k, v in sorted(c.items())]
        for name, c in shapes.items()}, "problems": problems})
    if problems:
        raise AssertionError(f"audio path failed: {problems}")
    return rows, launches


# -- the analysis and reconstruction paths ------------------------------
def analysis_kernel_rows(seq, shapes: dict) -> dict:
    """The three kernels at the analysis path's shapes, against their
    plain versions on the same inputs: the chunk decoder with the
    tokenizer's folded weights at each (B, steps) of shapes["chunk_decoder"]
    (the codebook's B=512 from zero seeds, the reconstruction's chunk
    batches), the GRU sequence with its encoder's layer-0 weights at each
    (T, B, H), both directions, with cuDNN's layer beside it, the VQ argmin
    at each (N, K, D) (the silhouette sweep's K-Means and the cluster
    CLI's)."""
    import torch

    from gesture2vec_tpu_torch.models.gru import gru_layer
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk
    from gesture2vec_tpu_torch.ops import vq_kernel as vk

    g = torch.Generator(device="cuda").manual_seed(17)
    rows = {"chunk_decoder": {}, "gru_sequence": {}, "vq_argmin": {}}
    folded = dk.fold_decoder_step(seq.decoder.decoder_step)
    cb = seq.decoder.codebook.detach()
    for B, n in sorted(shapes["chunk_decoder"]):
        if B == cb.shape[0]:     # the codebook's rows from zero seeds
            x0 = torch.zeros(B, REP, device="cuda")
            h0 = cb.reshape(B, L, HID).transpose(0, 1).contiguous()
        else:
            x0 = torch.randn(B, REP, device="cuda", generator=g)
            h0 = torch.tanh(torch.randn(L, B, HID, device="cuda",
                                        generator=g))
        ys = dk.fused_chunk_decode(x0, h0, folded, n)
        ref = dk.fused_chunk_decode_plain(x0, h0, folded, n)
        torch.cuda.synchronize()
        row = {"phase": "kernel", "path": "analysis",
               "kernel": "chunk_decoder", "B": B, "H": HID, "D": REP,
               "n_steps": n, "launch": decoder_launch(B, HID, REP),
               "max_abs_err": (ys - ref).abs().max().item(), "tol": TOL,
               "ms": cuda_ms(lambda: dk.fused_chunk_decode(x0, h0, folded,
                                                           n), 20),
               "plain_ms": cuda_ms(lambda: dk.fused_chunk_decode_plain(
                   x0, h0, folded, n), 10),
               "library_ms": None, **chunk_decoder_bound_ms(B, REP, HID, n)}
        emit(row)
        rows["chunk_decoder"][f"analysis_B{B}_T{n}"] = row
    gru = seq.encoder.gru
    w_ih, w_hh, b_ih, b_hh = (getattr(gru, f"l0_{n}").detach() for n in
                              ("w_ih", "w_hh", "b_ih", "b_hh"))
    cudnn = torch.nn.GRU(w_ih.shape[1], HID, 1).cuda()
    with torch.no_grad():
        for prm, v in ((cudnn.weight_ih_l0, w_ih), (cudnn.weight_hh_l0, w_hh),
                       (cudnn.bias_ih_l0, b_ih), (cudnn.bias_hh_l0, b_hh)):
            prm.copy_(v)
    with torch.inference_mode():
        for T, B, H in sorted(shapes["gru_sequence"]):
            xs = torch.randn(T, B, w_ih.shape[1], device="cuda", generator=g)
            h0 = torch.zeros(B, HID, device="cuda")
            xp = (xs.reshape(-1, xs.shape[2]) @ w_ih.t() + b_ih).reshape(
                T, B, -1)
            err = 0.0
            for reverse in (False, True):
                ys, h = gk.gru_sequence(xp, h0, w_hh, b_hh, reverse)
                ys_p, h_p = gk.gru_sequence_plain(xp, h0, w_hh, b_hh,
                                                  reverse)
                torch.cuda.synchronize()
                err = max(err, (ys - ys_p).abs().max().item(),
                          (h - h_p).abs().max().item())
            row = {"phase": "kernel", "path": "analysis",
                   "kernel": "gru_sequence", "T": T, "B": B, "H": HID,
                   "directions": 2, "launch": gru_launch(B, HID),
                   "max_abs_err": err, "tol": TOL,
                   "ms": cuda_ms(lambda: gk.gru_sequence(xp, h0, w_hh,
                                                         b_hh), 20),
                   "plain_ms": cuda_ms(lambda: gk.gru_sequence_plain(
                       xp, h0, w_hh, b_hh), 5),
                   **gru_bound_ms(T, B, HID),
                   # cuDNN computes the input product too: its yardstick
                   # is the matmul plus the kernel
                   "library_ms": cuda_ms(lambda: cudnn(xs, h0[None]), 20),
                   "matmul_plus_kernel_ms": cuda_ms(lambda: gru_layer(
                       xs, h0, w_ih, w_hh, b_ih, b_hh), 20)}
            emit(row)
            rows["gru_sequence"][f"analysis_T{T}_B{B}"] = row
        for N, Kc, D in sorted(shapes["vq_argmin"]):
            x = torch.randn(N, D, device="cuda", generator=g)
            c = torch.randn(Kc, D, device="cuda", generator=g)
            idx, dmin = vk.vq_argmin(x, c)
            d = vk.codebook_distances(x, c)
            dp, ip = d.min(dim=1)
            differ, ties = near_ties(d, idx, ip)
            row = {"phase": "kernel", "path": "analysis",
                   "kernel": "vq_argmin", "N": N, "K": Kc, "D": D,
                   "launch": vq_launch(N, D),
                   "max_abs_err": (dmin - dp).abs().max().item(),
                   "rows_differing": differ, "near_ties": ties,
                   "near_tie_gap": NEAR_TIE, "tol": DMIN_TOL,
                   "ms": cuda_ms(lambda: vk.vq_argmin(x, c), 20),
                   "plain_ms": cuda_ms(lambda: vk.vq_argmin_plain(x, c), 10),
                   "library_ms": None, **vq_bound_ms(N, Kc, D)}
            emit(row)
            rows["vq_argmin"][f"analysis_N{N}_K{Kc}_D{D}"] = row
    bad = [r for k in rows.values() for r in k.values()
           if not r["max_abs_err"] <= r["tol"]
           or r.get("rows_differing", 0) != r.get("near_ties", 0)]
    if bad:
        raise AssertionError(f"kernels at the analysis path's shapes: {bad}")
    return rows


def analysis_path(smi: str, tmp: str, files: dict) -> tuple:
    """The analysis and reconstruction paths over Part c's DAE and GS-Soft
    tokenizer (configs/VQ-VAE.yml: hidden 200, 2 layers, 512 codes), its
    train and validation stores and bank, and the cli path's ingest
    (data_pipe.json and the corpus's BVH files): `decode_codebook` (one
    chunk-decoder launch at B=512, 19 steps), `silhouette_sweep` over the
    bank's first 2,000 sequence latents (K=2..11: K-Means through the
    VQ-argmin kernel, the silhouette in torch), `export_cluster_samples`
    from the bank (2 a token), `cli/cluster` over the validation store
    with --kmeans 8 --export-samples 2 --pipeline, `cli/reconstruct` on a
    corpus BVH (Part a; Part a+b with --overlap 5; --warmup-steps 5; an
    `autoencoder_att` tokenizer written in the JAX file format, its decode
    in plain PyTorch), each with --html-player and against its --device
    cpu run, and a parity checkpoint (the eval step dropout: refused with
    the kernel on, reproducible with it off). Returns (the kernel rows,
    launches by run)."""
    import glob

    import torch

    from gesture2vec_tpu_torch.cli import cluster as cluster_cli
    from gesture2vec_tpu_torch.cli import reconstruct as rec_cli
    from gesture2vec_tpu_torch.cluster.analysis import (silhouette_score,
                                                         silhouette_sweep)
    from gesture2vec_tpu_torch.cluster.kmeans import kmeans_fit
    from gesture2vec_tpu_torch.cluster.latent_dataset import (
        decode_codebook, export_cluster_samples, sample_indices)
    from gesture2vec_tpu_torch.compat.checkpoint import (
        load_checkpoint, load_checkpoint_and_model)
    from gesture2vec_tpu_torch.compat.from_jax import (flax_init,
                                                       to_jax_variables)
    from gesture2vec_tpu_torch.data.datasets import normalize
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.infer.reconstruct import chunked_reconstruct
    from gesture2vec_tpu_torch.io.bvh import parse_bvh
    from gesture2vec_tpu_torch.mocap.features import FeatureExtractor
    from gesture2vec_tpu_torch.models.seq_ae import SeqVQAutoencoder

    problems, launches = [], {}
    pipe = os.path.join(tmp, "ingested", "data_pipe.json")
    bvh = sorted(glob.glob(os.path.join(tmp, "corpus", "Motion",
                                        "*.bvh")))[-1]
    store = ClipStore(files["train"])
    fe = FeatureExtractor.load(pipe)
    dae, _ = load_checkpoint_and_model(files["dae"], "DAE")
    seq, _ = load_checkpoint_and_model(files["vq"], "autoencoder_vq")
    n_files = lambda d: sum(len(fs) for _, _, fs in os.walk(d))  # noqa

    def run(name, fn):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = read_launches()
        return out, time.perf_counter() - t0

    with kernel_shapes() as shapes:
        # -- decode_codebook: the whole codebook in one eval decode -----
        motion, secs = run("decode_codebook",
                           lambda: decode_codebook(seq, dae))
        seq.decoder.use_kernel = False
        plain = decode_codebook(seq, dae)
        seq.decoder.use_kernel = True
        err = float(np.abs(motion - plain).max())
        emit({"phase": "analysis", "run": "decode_codebook",
              "shape": list(motion.shape),
              "launches": launches["decode_codebook"],
              "kernel_vs_plain_max_abs_err": err, "tol": TOL,
              "seconds": secs, "card": smi})
        if launches["decode_codebook"] != {**dict.fromkeys(
                launches["decode_codebook"], 0), "chunk_decoder": 1} \
                or motion.shape != (K, N_FRAMES, DIM) or not err <= TOL:
            problems.append("decode_codebook failed its checks")

        # -- silhouette_sweep over the bank's first 2,000 latents ------
        with np.load(files["bank"]) as z:
            tokens = z["tokens"]
            latents = z["seq_latents"][:ANALYSIS_SWEEP_ROWS]
            dae_latents = z["dae_latents"]
        scores, secs = run("silhouette_sweep", lambda: silhouette_sweep(
            latents, ANALYSIS_K_RANGE, device="cuda"))
        xc = torch.from_numpy(latents).cuda()
        sil_err = 0.0
        for k in (ANALYSIS_K_RANGE[0], ANALYSIS_K_RANGE[-1]):
            labels = kmeans_fit(xc, k, n_init=1, max_iter=50).labels
            sil_err = max(sil_err, abs(
                silhouette_score(xc, labels) - silhouette_score(
                    torch.from_numpy(latents), labels.cpu())))
        emit({"phase": "analysis", "run": "silhouette_sweep",
              "rows": len(latents), "scores": scores,
              "launches": launches["silhouette_sweep"],
              "silhouette_card_vs_cpu_abs_err": sil_err, "tol": 1e-5,
              "seconds": secs, "card": smi})
        sweep = launches["silhouette_sweep"]
        if sorted(scores) != list(ANALYSIS_K_RANGE) or not sweep[
                "vq_argmin"] or any(v for kn, v in sweep.items()
                                    if kn != "vq_argmin") \
                or not sil_err <= 1e-5:
            problems.append("silhouette_sweep failed its checks")

        # -- export_cluster_samples from the bank, 2 a token -----------
        out = os.path.join(tmp, "analysis_samples")
        bank = {"tokens": tokens, "dae_latents": dae_latents}
        n, secs = run("export_cluster_samples", lambda: export_cluster_samples(
            bank, out, fe, store.pose_mean, store.pose_std, dae,
            max_per_token=2))
        want_n = sum(len(v) for v in sample_indices(tokens, 2).values())
        emit({"phase": "analysis", "run": "export_cluster_samples",
              "files": n, "files_on_disk": n_files(out), "want": want_n,
              "launches": launches["export_cluster_samples"],
              "seconds": secs, "card": smi})
        if n != want_n or n_files(out) != n or any(
                launches["export_cluster_samples"].values()):
            problems.append("export_cluster_samples failed its checks")
        del bank, dae_latents

        # -- cli/cluster over the validation store ---------------------
        out = os.path.join(tmp, "analysis_clusters")
        argv = [files["dae"], files["vq"], "--store", files["val"],
                "--kmeans", str(ANALYSIS_KMEANS), "--export-samples", "2",
                "--pipeline", pipe, "--out", out]
        summary, secs = run("cli_cluster", lambda: cluster_cli.main(argv))
        got = launches["cli_cluster"]
        n_win = summary["windows"]
        want = {"gru_sequence": 2 * math.ceil(n_win / 512),
                "vq_argmin": sum(summary["kmeans_n_iter"])
                + len(summary["kmeans_n_iter"])}
        emit({"phase": "analysis", "run": "cli_cluster", "command":
              "python -m gesture2vec_tpu_torch.cli.cluster dae.bin vq.bin "
              f"--store val --kmeans {ANALYSIS_KMEANS} --export-samples 2 "
              "--pipeline data_pipe.json", "windows": n_win,
              "samples": summary["samples"],
              "samples_on_disk": n_files(os.path.join(out, "samples")),
              "kmeans_lloyd_steps": summary["kmeans_n_iter"],
              "launches": got, "want": want, "seconds": secs, "card": smi})
        if any(got[kn] != v for kn, v in want.items()) \
                or got["chunk_decoder"] or summary["samples"] != n_files(
                    os.path.join(out, "samples")):
            problems.append("cli/cluster failed its checks")

        # -- cli/reconstruct on a corpus BVH ---------------------------
        att = SeqVQAutoencoder(REP, HID, L, N_FRAMES, vq_components=K,
                               use_attention=True)
        flax_init(att, torch.Generator().manual_seed(23))
        v = to_jax_variables(att)
        ckpt = {"att": os.path.join(tmp, "vq_att.bin"),
                "parity": os.path.join(tmp, "vq_parity.bin")}
        write_checkpoint(ckpt["att"], {**VQ_ARGS, "autoencoder_att": True},
                         v["params"], v["batch_stats"], "autoencoder_vq",
                         REP)
        payload = load_checkpoint(files["vq"])
        write_checkpoint(ckpt["parity"], VQ_ARGS, payload["params"],
                         payload["extra"]["batch_stats"], "autoencoder_vq",
                         REP, parity=True)
        n_chunks = lambda overlap: (  # noqa
            (int(parse_bvh(bvh).n_frames) // 3 - N_FRAMES)
            // (N_FRAMES - overlap) + 1)
        plan = [("part_a", [], {}),
                ("part_ab_overlap5", ["--autoencoder-checkpoint",
                                      files["vq"], "--overlap", "5"],
                 {"gru_sequence": 4, "chunk_decoder": 1}),
                ("part_ab_warmup5", ["--autoencoder-checkpoint",
                                     files["vq"], "--warmup-steps", "5"],
                 {"gru_sequence": 4, "chunk_decoder": 1}),
                ("part_ab_attention", ["--autoencoder-checkpoint",
                                       ckpt["att"]],
                 {"gru_sequence": 4, "chunk_decoder": 0})]
        for name, flags, want in plan:
            argv = [files["dae"], bvh, "--store", files["train"],
                    "--pipeline", pipe, *flags,
                    "--out", os.path.join(tmp, f"rec_{name}.bvh"),
                    "--html-player", os.path.join(tmp, f"rec_{name}.html")]
            res, secs = run(f"reconstruct_{name}", lambda: rec_cli.main(argv))
            t0 = time.perf_counter()
            cpu = rec_cli.main([*argv[:-4], "--device", "cpu", "--out",
                                os.path.join(tmp, f"rec_{name}_cpu.bvh")])
            cpu_s = time.perf_counter() - t0
            got = launches[f"reconstruct_{name}"]
            err = float(np.abs(res["frames"] - cpu["frames"]).max())
            data = parse_bvh(res["out"])
            emit({"phase": "analysis", "run": f"reconstruct_{name}",
                  "command": "python -m gesture2vec_tpu_torch.cli."
                             "reconstruct dae.bin clip.bvh "
                             + " ".join(os.path.basename(f) for f in flags),
                  "frames": list(res["frames"].shape), "mse": res["mse"],
                  "kernel_decode": res["kernel"], "launches": got,
                  "want": want, "card_vs_cpu_max_abs_err": err, "tol": TOL,
                  "bvh_frames": int(data.n_frames),
                  "html_bytes": os.path.getsize(res["html"]),
                  "seconds": secs, "cpu_seconds": cpu_s, "card": smi})
            if any(got[kn] != want.get(kn, 0) for kn in got) \
                    or not err <= TOL or not np.isfinite(
                        res["frames"]).all() \
                    or data.n_frames != res["frames"].shape[0]:
                problems.append(f"cli/reconstruct {name} failed its checks")

        # -- a parity checkpoint: eval step dropout --------------------
        frames = normalize(fe.transform(parse_bvh(bvh)).astype(np.float32),
                           store.pose_mean, store.pose_std)
        par, _ = load_checkpoint_and_model(ckpt["parity"], "autoencoder_vq")
        try:
            chunked_reconstruct(par, dae, frames, N_FRAMES)
            refused = ""
        except ValueError as e:
            refused = str(e)
        par.set_use_kernels(False)
        first, secs = run("reconstruct_parity", lambda: chunked_reconstruct(
            par, dae, frames, N_FRAMES))
        again = chunked_reconstruct(par, dae, frames, N_FRAMES)
        emit({"phase": "analysis", "run": "reconstruct_parity",
              "eval_step_dropout": par.decoder.eval_step_dropout,
              "kernel_on": refused, "chunks": n_chunks(0),
              "launches": launches["reconstruct_parity"],
              "reproducible": bool(np.array_equal(first, again)),
              "seconds": secs, "card": smi})
        if "eval decode on the card" not in refused \
                or not par.decoder.eval_step_dropout \
                or not np.array_equal(first, again) \
                or not np.isfinite(first).all():
            problems.append("the parity checkpoint failed its checks")

    rows = analysis_kernel_rows(seq, {
        name: set(c) for name, c in shapes.items()
        if name in ("chunk_decoder", "gru_sequence", "vq_argmin")})
    emit({"phase": "check", "path": "analysis", "kernel_shapes": {
        name: [[list(k), v] for k, v in sorted(c.items())]
        for name, c in shapes.items()}, "problems": problems,
        "not_driven": ANALYSIS_NOT_DRIVEN})
    if problems:
        raise AssertionError(f"analysis path failed: {problems}")
    return rows, launches


# -- the scale-out path --------------------------------------------------
# configs/VQ-VAE.yml (and _rvq) at its widths: 4 steps of the global batch
# of 128 and one validation batch, one epoch
SCALE_N, SCALE_VAL = 512, 128
# pipelined_gru_stack: T, B, microbatches, stages
SCALE_PP = (20, 128, 4, 2)
SCALE_REQUESTS_S = (6.0, 6.0, 12.0)


def scale_config(shipped: str, **overrides):
    """A shipped config at its widths, one epoch."""
    from gesture2vec_tpu_torch.train.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    return load_config(os.path.join(here, "configs", shipped), epochs=1,
                       **overrides)


def scale_windows(n: int, seed: int) -> np.ndarray:
    """n smooth random latent windows (N_FRAMES x REP)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, N_FRAMES)[None, :, None]
    base = rng.normal(size=(n, 1, REP))
    return (base + 0.5 * np.sin(2 * np.pi * t + base)
            + 0.1 * rng.normal(size=(n, N_FRAMES, REP))).astype(np.float32)


SCALE_COLLECTIVES = ("all_reduce", "all_gather", "broadcast")
SCALE_HOPS = ("send", "recv")


@contextlib.contextmanager
def collective_clock():
    """Host seconds and calls inside the port's collectives and its
    point-to-point hops (their gloo host staging included), in all and by
    helper, by wrapping parallel/mesh's helpers. Each call is synchronised
    on both sides, so a run under the clock is slower than one without: it
    is a run of its own. A send's seconds are its staging and its start
    (the transfer completes at the wait); a recv's include waiting for the
    sender."""
    import torch

    from gesture2vec_tpu_torch.parallel import mesh as pmesh
    from gesture2vec_tpu_torch.parallel import pipeline as ppipe

    clock = {"seconds": 0.0, "calls": 0,
             "by_name": {n: [0.0, 0]
                         for n in SCALE_COLLECTIVES + SCALE_HOPS}}
    saved = []
    for mod in (pmesh, ppipe):
        for name in SCALE_COLLECTIVES + SCALE_HOPS:
            if not hasattr(mod, name):
                continue
            def timed(*a, _fn=getattr(mod, name), _name=name, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                clock["seconds"] += dt
                clock["calls"] += 1
                clock["by_name"][_name][0] += dt
                clock["by_name"][_name][1] += 1
                return out
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, timed)
    try:
        yield clock
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def shapes_json(shapes: dict) -> dict:
    return {name: [[list(k), v] for k, v in sorted(c.items())]
            for name, c in shapes.items() if c}


def gather_ranks(mine: dict) -> list:
    """Every rank's dict, in rank order."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def warm_timed_clocked(run):
    """run() three times: a warm-up (the process's CUDA context, kernel
    loading, the mesh's first collectives and communicators), a timed run
    with nothing wrapped (its launches counted), and a run under the
    collective clock and the shape recorder. Returns (the timed run's
    result, {its seconds and launches, the clocked run's seconds,
    collective time and kernel shapes})."""
    import torch

    run()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    with kernel_shapes() as shapes, collective_clock() as clock:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        clocked = time.perf_counter() - t0
    return out, {"launches": launches, "shapes": shapes_json(shapes),
                 "seconds": secs, "clocked_seconds": clocked,
                 "collective_s": sum(clock["by_name"][n][0]
                                     for n in SCALE_COLLECTIVES),
                 "collective_calls": sum(clock["by_name"][n][1]
                                         for n in SCALE_COLLECTIVES),
                 "hop_s": sum(clock["by_name"][n][0] for n in SCALE_HOPS),
                 "hop_calls": sum(clock["by_name"][n][1]
                                  for n in SCALE_HOPS),
                 "by_name": clock["by_name"]}


def scale_rank_train(cfg, windows, val) -> dict:
    """A rank's train_seq_ae over cfg's mesh on the card (a rank function
    for parallel/launch.run; `warm_timed_clocked`): the timed run's
    history, and every rank's launches, kernel shapes, seconds and
    collective time."""
    from gesture2vec_tpu_torch.train.seq_ae_trainer import train_seq_ae

    (_, hist), mine = warm_timed_clocked(
        lambda: train_seq_ae(cfg, windows, val, device="cuda"))
    return {"history": hist, "ranks": gather_ranks(mine)}


def scale_rank_tokens(cfg, windows) -> dict:
    """The residual-VQ tokenizer's initial weights row-sharded over
    dp=1 x tp=2: its stage tokens of windows (each stage's argmin on the
    rank's 256 codebook rows, the nearest over the ranks), and every
    rank's launches and kernel shapes."""
    import torch

    from gesture2vec_tpu_torch.parallel.mesh import make_mesh, shard_params
    from gesture2vec_tpu_torch.train.dae_trainer import init_model
    from gesture2vec_tpu_torch.train.seq_ae_trainer import make_seq_ae

    mesh = make_mesh({"dp": 1, "tp": 2}, "cuda")
    model = init_model(make_seq_ae(cfg), max(cfg.random_seed, 0),
                       mesh.device).eval()
    shard_params(model, mesh)
    reset_launches()
    with kernel_shapes() as shapes, torch.no_grad():
        toks = model.stage_tokens(model.encode_hidden(
            torch.from_numpy(windows).to(mesh.device)))
        torch.cuda.synchronize()
    return {"tokens": toks.cpu().numpy(), "ranks": gather_ranks({
        "launches": read_launches(), "shapes": shapes_json(shapes)})}


def scale_rank_pipeline(stacked, x, target) -> dict:
    """pipelined_gru_stack over pp=2 on the card (parallel/pipeline.
    run_stack; `warm_timed_clocked`): the timed run's output and
    gradients, and every rank's launches, kernel shapes, seconds,
    collective and hop time."""
    from gesture2vec_tpu_torch.parallel.pipeline import run_stack

    T, B, micro, stages = SCALE_PP
    got, mine = warm_timed_clocked(lambda: run_stack(
        "gru", stacked, x, target, {"pp": stages}, micro, device="cuda"))
    got["ranks"] = gather_ranks(mine)
    return got


def scale_kernel_rows() -> dict:
    """The kernels at the shapes each rank sees against their plain
    versions: the GRU sequence and its training kernels at B=64 (dp=2's
    half batch) beside B=128 (the GRU sequence also against one cuDNN GRU
    layer, its input product included, as `gru_kernel_rows`), the VQ
    argmin on a tp shard (128 rows x 256 codes) and on dp=2's half batch
    (64 x 512) beside the whole (128 x 512), the chunk decoder's
    validation rollout at B=64."""
    import torch

    from gesture2vec_tpu_torch.models.gru import gru_layer
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk
    from gesture2vec_tpu_torch.ops import vq_kernel as vk

    g = torch.Generator(device="cuda").manual_seed(31)
    rows = {"chunk_decoder": {}, "gru_sequence": {},
            "gru_sequence_backward": {}, "vq_argmin": {}}
    bnd = 1.0 / HID ** 0.5
    w_hh = (torch.rand(3 * HID, HID, device="cuda", generator=g) * 2 - 1) \
        * bnd
    b_hh = (torch.rand(3 * HID, device="cuda", generator=g) * 2 - 1) * bnd
    w_ih = (torch.rand(3 * HID, HID, device="cuda", generator=g) * 2 - 1) \
        * bnd
    b_ih = (torch.rand(3 * HID, device="cuda", generator=g) * 2 - 1) * bnd
    cudnn = torch.nn.GRU(HID, HID, 1).cuda()
    with torch.no_grad():
        for p, v in ((cudnn.weight_ih_l0, w_ih), (cudnn.weight_hh_l0, w_hh),
                     (cudnn.bias_ih_l0, b_ih), (cudnn.bias_hh_l0, b_hh)):
            p.copy_(v)
    for B in (64, 128):
        xs = torch.randn(N_FRAMES, B, HID, device="cuda", generator=g)
        h0 = torch.zeros(B, HID, device="cuda")
        with torch.inference_mode():
            xp = (xs.reshape(-1, HID) @ w_ih.t() + b_ih).reshape(
                N_FRAMES, B, -1)
            ys, h = gk.gru_sequence(xp, h0, w_hh, b_hh)
            ys_p, h_p = gk.gru_sequence_plain(xp, h0, w_hh, b_hh)
            y_c, h_c = cudnn(xs, h0[None])
            torch.cuda.synchronize()
            row = {"phase": "kernel", "path": "scale_out",
                   "kernel": "gru_sequence", "T": N_FRAMES, "B": B,
                   "H": HID, "max_abs_err": max(
                       (ys - ys_p).abs().max().item(),
                       (h - h_p).abs().max().item()), "tol": TOL,
                   "ms": cuda_ms(lambda: gk.gru_sequence(xp, h0, w_hh,
                                                         b_hh), 20),
                   "plain_ms": cuda_ms(lambda: gk.gru_sequence_plain(
                       xp, h0, w_hh, b_hh), 5),
                   # cuDNN computes the input product too: its yardstick
                   # is the matmul plus the kernel
                   "library_ms": cuda_ms(lambda: cudnn(xs, h0[None]), 20),
                   "matmul_plus_kernel_ms": cuda_ms(lambda: gru_layer(
                       xs, h0, w_ih, w_hh, b_ih, b_hh), 20),
                   "cudnn_max_abs_err": max(
                       (y_c - ys).abs().max().item(),
                       (h_c[0] - h).abs().max().item()),
                   **gru_bound_ms(N_FRAMES, B, HID)}
        emit(row)
        rows["gru_sequence"][f"scale_T{N_FRAMES}_B{B}"] = row
    for r in gru_backward_rows(((N_FRAMES, 64),)):
        if not r["reverse"]:
            r["path"] = "scale_out"
            rows["gru_sequence_backward"][f"scale_T{N_FRAMES}_B64"] = r
    D = L * HID
    for N, Kc in ((128, K // 2), (64, K), (128, K)):
        x = torch.randn(N, D, device="cuda", generator=g)
        cb = torch.randn(Kc, D, device="cuda", generator=g)
        idx, dmin = vk.vq_argmin(x, cb)
        d = vk.codebook_distances(x, cb)
        dmin_p, idx_p = d.min(dim=1)
        torch.cuda.synchronize()
        differ, ties = near_ties(d, idx, idx_p)
        row = {"phase": "kernel", "path": "scale_out", "kernel": "vq_argmin",
               "N": N, "K": Kc, "D": D, "rows_differing": differ,
               "near_ties": ties, "near_tie_gap": NEAR_TIE,
               "max_abs_err": (dmin - dmin_p).abs().max().item(),
               "tol": DMIN_TOL,
               "ms": cuda_ms(lambda: vk.vq_argmin(x, cb), 20),
               "plain_ms": cuda_ms(lambda: vk.vq_argmin_plain(x, cb), 20),
               "library_ms": None, **vq_bound_ms(N, Kc, D)}
        emit(row)
        if differ != ties:
            row["max_abs_err"] = float("inf")
        rows["vq_argmin"][f"scale_N{N}_K{Kc}"] = row
    folded = random_folded(HID, REP, g)
    n = N_FRAMES - 1
    x0 = torch.randn(64, REP, device="cuda", generator=g)
    h0 = torch.randn(2, 64, HID, device="cuda", generator=g)
    ys = dk.fused_chunk_decode(x0, h0, folded, n)
    ref = dk.fused_chunk_decode_plain(x0, h0, folded, n)
    torch.cuda.synchronize()
    row = {"phase": "kernel", "path": "scale_out", "kernel": "chunk_decoder",
           "B": 64, "H": HID, "D": REP, "n_steps": n,
           "max_abs_err": (ys - ref).abs().max().item(), "tol": TOL,
           "ms": cuda_ms(lambda: dk.fused_chunk_decode(x0, h0, folded, n),
                         20),
           "plain_ms": cuda_ms(lambda: dk.fused_chunk_decode_plain(
               x0, h0, folded, n), 10),
           "library_ms": None, **chunk_decoder_bound_ms(64, REP, HID, n)}
    emit(row)
    rows["chunk_decoder"][f"scale_B64_T{n}"] = row
    bad = [r for k in rows.values() for r in k.values()
           if not r["max_abs_err"] <= r["tol"]]
    if bad:
        raise AssertionError(f"kernels at the scale-out shapes: {bad}")
    return rows


def scale_single(cfg, windows, val) -> dict:
    """The run without a mesh on the card, after a warm-up run as the
    ranks' (`warm_timed_clocked`): history, seconds, launches."""
    from gesture2vec_tpu_torch.train.seq_ae_trainer import train_seq_ae

    (_, hist), mine = warm_timed_clocked(
        lambda: train_seq_ae(cfg, windows, val, device="cuda"))
    return {"history": hist, "seconds": mine["seconds"],
            "launches": mine["launches"]}


def scale_generator():
    """The decode-mode generator at the bench widths, random weights."""
    from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
    from gesture2vec_tpu_torch.text.vocab import Vocab

    vocab = Vocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    return generator_from_jax(
        *jax_layout_trees(np.random.default_rng(0)), vocab,
        np.zeros(DIM, np.float32), np.ones(DIM, np.float32),
        n_frames=N_FRAMES, sentence_frame_length=SENT_LEN, fps=FPS,
        max_words=MAXW, device="cuda", mode="decode")


def scale_out_path(smi: str) -> tuple:
    """The scale-out slice on the card (see the module note): returns
    (the kernels at the ranks' shapes, {run: rank 0's launches})."""
    import torch

    from gesture2vec_tpu_torch.parallel import launch
    from gesture2vec_tpu_torch.parallel.mesh import make_mesh
    from gesture2vec_tpu_torch.parallel.pipeline import (gru_stage,
                                                         stack_stages)

    problems, counts = [], {}
    windows, val = scale_windows(SCALE_N, 41), scale_windows(SCALE_VAL, 42)
    cfg = scale_config("VQ-VAE.yml")
    rvq = scale_config("VQ-VAE_rvq.yml")
    steps, vals = SCALE_N // cfg.batch_size, SCALE_VAL // cfg.batch_size

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    def check_ranks(run, ranks, want):
        for i, r in enumerate(ranks):
            got = {k: r["launches"][k] for k in want}
            if got != want:
                problems.append(f"{run} rank {i}: launches {got}, want "
                                f"{want}")

    # 6. a mesh larger than the cards
    try:
        make_mesh({"dp": 2}, "cuda")
        raised = ""
    except ValueError as e:
        raised = str(e)
    emit({"phase": "scale_out", "check": "make_mesh_dp2_on_one_card",
          "raised": raised, "cards": torch.cuda.device_count()})
    if torch.cuda.device_count() == 1 and "needs 2 devices" not in raised:
        problems.append("make_mesh({'dp': 2}) on one card did not raise")

    # the single-card references
    single = scale_single(cfg, windows, val)
    single_rvq = scale_single(rvq, windows, val)
    want_b = train_want_launches("b", "b_gssoft", cfg, SCALE_N, SCALE_VAL,
                                 [])
    want_rvq = train_want_launches("b", "b_rvq", rvq, SCALE_N, SCALE_VAL, [])
    for name, run, want in (("single", single, want_b),
                            ("single_rvq", single_rvq, want_rvq)):
        if run["launches"] != want:
            problems.append(f"{name}: launches {run['launches']}, want "
                            f"{want}")

    # 1. dp=1 under NCCL (one spawned rank) against the run without a mesh
    t0 = time.perf_counter()
    nccl = launch.run(scale_rank_train, (cfg.replace(mesh_shape={"dp": 1}),
                                         windows, val), world_size=1,
                      device="cuda")
    nccl_s = time.perf_counter() - t0
    err = rel(nccl["history"]["train_loss"] + nccl["history"]["val_loss"],
              single["history"]["train_loss"]
              + single["history"]["val_loss"])
    check_ranks("nccl_dp1", nccl["ranks"], want_b)
    if not err <= 1e-6:
        problems.append(f"dp=1 under NCCL: losses {err} from the single "
                        f"run")
    counts["nccl_dp1"] = nccl["ranks"][0]["launches"]

    # 2-4. two gloo ranks sharing the card: dp=2; the residual VQ over
    # dp=1 x tp=2 (training, and its tokens); the GRU stack over pp=2
    T, B, micro, stages = SCALE_PP
    g = torch.Generator().manual_seed(43)
    bnd = 1.0 / HID ** 0.5
    layers = [{k: (torch.rand(*shape, generator=g) * 2 - 1) * bnd
               for k, shape in (("w_ih", (3 * HID, HID)),
                                ("w_hh", (3 * HID, HID)),
                                ("b_ih", (3 * HID,)), ("b_hh", (3 * HID,)))}
              for _ in range(stages)]
    stacked = stack_stages(layers)
    x = torch.randn(B, T, HID, generator=g)
    target = torch.randn(B, T, HID, generator=g)
    jobs = [(scale_rank_train, (cfg.replace(mesh_shape={"dp": 2}), windows,
                                val), {}),
            (scale_rank_train, (rvq.replace(mesh_shape={"dp": 1, "tp": 2}),
                                windows, val), {}),
            (scale_rank_tokens, (rvq, val), {}),
            (scale_rank_pipeline, (stacked, x, target), {})]
    t0 = time.perf_counter()
    dp2, tp2, toks, pp = launch.run(launch.call_all, (jobs,), world_size=2,
                                    device="cuda", backend="gloo")
    gloo_s = time.perf_counter() - t0

    err_dp2 = rel(dp2["history"]["train_loss"] + dp2["history"]["val_loss"],
                  single["history"]["train_loss"]
                  + single["history"]["val_loss"])
    check_ranks("gloo_dp2", dp2["ranks"], want_b)
    if not err_dp2 <= 1e-4:
        problems.append(f"dp=2 over gloo: losses {err_dp2} from the "
                        f"single run")
    err_tp2 = rel(tp2["history"]["train_loss"] + tp2["history"]["val_loss"],
                  single_rvq["history"]["train_loss"]
                  + single_rvq["history"]["val_loss"])
    check_ranks("gloo_tp2", tp2["ranks"], want_rvq)
    if not err_tp2 <= 1e-4:
        problems.append(f"dp=1 x tp=2 over gloo: losses {err_tp2} from the "
                        f"single run")
    for i, r in enumerate(tp2["ranks"] + toks["ranks"]):
        shards = {tuple(k)[1] for k, _ in r["shapes"].get("vq_argmin", [])}
        if shards != {K // 2}:
            problems.append(f"tp=2 rank {i % 2}: vq_argmin on codebook "
                            f"rows {sorted(shards)}, want {K // 2}")

    # the tokens against the unsharded tokenizer's on the card
    from gesture2vec_tpu_torch.train.dae_trainer import init_model
    from gesture2vec_tpu_torch.train.seq_ae_trainer import make_seq_ae

    ref_model = init_model(make_seq_ae(rvq), max(rvq.random_seed, 0),
                           torch.device("cuda")).eval()
    with torch.no_grad():
        want_toks = ref_model.stage_tokens(ref_model.encode_hidden(
            torch.from_numpy(val).cuda())).cpu().numpy()
    flips = int((toks["tokens"] != want_toks).sum())
    check_ranks("gloo_tp2_tokens", toks["ranks"], {
        "gru_sequence": 2, "vq_argmin": rvq.rvq_stages})
    if flips:
        problems.append(f"tp=2 tokens: {flips} differ from the unsharded "
                        f"tokenizer's")

    # the pipeline against the sequential stack on the card
    st = {k: v.cuda().requires_grad_() for k, v in stacked.items()}
    xs = x.cuda().requires_grad_()
    y = xs
    for i in range(stages):
        y = gru_stage({k: v[i] for k, v in st.items()}, y)
    torch.mean((y - target.cuda()) ** 2).backward()
    pp_err = max([(pp["y"].cuda() - y.detach()).abs().max().item()]
                 + [(pp["grads"][k].cuda() - st[k].grad).abs().max().item()
                    / max(st[k].grad.abs().max().item(), 1e-30)
                    for k in st]
                 + [(pp["x_grad"].cuda() - xs.grad).abs().max().item()
                    / max(xs.grad.abs().max().item(), 1e-30)])
    check_ranks("gloo_pp2", pp["ranks"], {"gru_sequence": micro,
                                          "gru_sequence_backward": micro})
    if not pp_err <= 1e-4:
        problems.append(f"pp=2 pipeline: {pp_err} from the sequential "
                        f"stack")
    counts.update(gloo_dp2=dp2["ranks"][0]["launches"],
                  gloo_tp2=tp2["ranks"][0]["launches"],
                  gloo_tp2_tokens=toks["ranks"][0]["launches"],
                  gloo_pp2=pp["ranks"][0]["launches"])

    # 5. generate_batch over a dp=1 mesh at the bench widths
    gen = scale_generator()
    transcripts = [words(d, seed=i) for i, d in enumerate(SCALE_REQUESTS_S)]
    reset_launches()
    plain = gen.generate_batch(transcripts, list(SCALE_REQUESTS_S))
    want_gen = read_launches()
    reset_launches()
    meshed = gen.generate_batch(transcripts, list(SCALE_REQUESTS_S),
                                mesh=make_mesh({"dp": 1}, "cuda"))
    counts["generate_batch_dp1"] = read_launches()
    gen_flips = sum(int((a[1] != b[1]).sum()) for a, b in zip(meshed, plain))
    gen_err = max(float(np.abs(a[0] - b[0]).max())
                  for a, b in zip(meshed, plain))
    if gen_flips or not gen_err <= TOL \
            or counts["generate_batch_dp1"] != want_gen:
        problems.append(f"generate_batch over dp=1: {gen_flips} token "
                        f"flips, frames {gen_err}, launches "
                        f"{counts['generate_batch_dp1']} vs {want_gen}")

    rows = scale_kernel_rows()

    def per_step(ranks):
        # steps/s of the timed run (the whole call, its validation
        # included), collectives of the clocked run
        return [{"steps_per_s": steps / r["seconds"],
                 "collective_ms_per_step": 1e3 * r["collective_s"] / steps,
                 "collective_calls": r["collective_calls"],
                 "seconds": r["seconds"],
                 "clocked_seconds": r["clocked_seconds"]} for r in ranks]

    emit({"phase": "scale_out", "config": "configs/VQ-VAE.yml",
          "widths": {"hidden": cfg.hidden_size, "layers": cfg.n_layers,
                     "codes": cfg.autoencoder_vq_components,
                     "rep": cfg.rep_learning_dim, "frames": cfg.n_poses,
                     "batch": cfg.batch_size},
          "steps": steps, "val_batches": vals,
          "single": {"history": single["history"],
                     "steps_per_s": steps / single["seconds"],
                     "seconds": single["seconds"]},
          "nccl_dp1": {"history": nccl["history"], "rel_err": err,
                       "tol": 1e-6, "ranks": per_step(nccl["ranks"]),
                       "launch_s": nccl_s},
          "gloo_dp2": {"history": dp2["history"], "rel_err": err_dp2,
                       "tol": 1e-4, "ranks": per_step(dp2["ranks"])},
          "gloo_tp2": {"config": "configs/VQ-VAE_rvq.yml",
                       "history": tp2["history"],
                       "single_history": single_rvq["history"],
                       "rel_err": err_tp2, "tol": 1e-4,
                       "ranks": per_step(tp2["ranks"])},
          "tp2_tokens": {"windows": SCALE_VAL, "flips": flips,
                         "stages": rvq.rvq_stages},
          "gloo_pp2": {"T": T, "B": B, "H": HID, "n_micro": micro,
                       "max_rel_err": pp_err, "tol": 1e-4,
                       "ranks": [{"seconds": r["seconds"],
                                  "clocked_seconds": r["clocked_seconds"],
                                  "collective_ms": 1e3 * r["collective_s"],
                                  "collective_calls": r["collective_calls"],
                                  "hop_ms": 1e3 * r["hop_s"],
                                  "hop_calls": r["hop_calls"],
                                  "by_name_ms": {
                                      n: [1e3 * v[0], v[1]]
                                      for n, v in r["by_name"].items()}}
                                 for r in pp["ranks"]]},
          "gloo_launch_s": gloo_s,
          "generate_batch_dp1": {"requests_s": SCALE_REQUESTS_S,
                                 "token_flips": gen_flips,
                                 "max_abs_err": gen_err},
          "rank_launches": {
              "nccl_dp1": [r["launches"] for r in nccl["ranks"]],
              "gloo_dp2": [r["launches"] for r in dp2["ranks"]],
              "gloo_tp2": [r["launches"] for r in tp2["ranks"]],
              "gloo_tp2_tokens": [r["launches"] for r in toks["ranks"]],
              "gloo_pp2": [r["launches"] for r in pp["ranks"]]},
          "rank_shapes": {
              "gloo_dp2": dp2["ranks"][0]["shapes"],
              "gloo_tp2": tp2["ranks"][0]["shapes"],
              "gloo_pp2": pp["ranks"][0]["shapes"]},
          "want": {"b": want_b, "b_rvq": want_rvq}, "card": smi})
    emit({"phase": "check", "path": "scale_out", "problems": problems})
    if problems:
        raise AssertionError(f"scale-out path failed: {problems}")
    return rows, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from gesture2vec_tpu_torch.ops import build

    # -- device -------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- build --------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    secs = time.perf_counter() - t0
    for name, (lib, log) in built.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if any(w in ln for w in ("registers", "spill", "smem",
                                          "Compiling entry"))]
        emit({"phase": "build", "kernel": name, "library": lib.name,
              "seconds": secs, "ptxas": ptxas})

    secs = {}
    t0 = time.perf_counter()
    kernels = [decode_path(smi)]
    secs["decode_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files, part_c_kernels = part_c_path(smi, tmp)
        kernels += part_c_kernels
        secs["part_c_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        exemplar_counts = exemplar_path(smi, tmp, files)
        secs["exemplar_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_counts = cli_path(smi, tmp, files)
        secs["cli_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve_counts = serve_path(smi, tmp, files)
        secs["serve_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tf_counts = tf_part_c_path(smi, tmp, files)
        secs["tf_part_c_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        audio_rows, audio_counts = audio_path(smi, tmp, files)
        secs["audio_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        analysis_rows, analysis_counts = analysis_path(smi, tmp, files)
        secs["analysis_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    policy_rows, policy_counts = policies_path(smi)
    secs["policies_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    recipe_counts = recipe_path(smi, files["rvq_bank"])
    secs["recipe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        done = {}
        train_entry, train_counts = train_path(smi, tmp, done)
        kernels.append(train_entry)
        secs["train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bf16_entries, _ = train_bf16_path(smi, done)
        secs["train_bf16_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stream_path(smi, done)
        secs["stream_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        misc_rows, misc_counts = misc_train_path(smi, done)
        secs["misc_train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tools_counts = tools_path(smi, done)
        secs["tools_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scale_rows, scale_counts = scale_out_path(smi)
    secs["scale_out_s"] = time.perf_counter() - t0
    emit({"phase": "paths", **secs,
          "total_s": time.perf_counter() - _T0})
    for k in kernels:
        # launches: the kernel's first path (decode, Part c or, for the
        # GRU backward, training); the later paths' counts beside it, and
        # its times at the new shapes
        k["launches_by_path"] = {
            "exemplar": exemplar_counts[k["name"]],
            "cli": {p: c[k["name"]] for p, c in cli_counts.items()},
            "serve": {p: c[k["name"]] for p, c in serve_counts.items()},
            "policies": {p: c[k["name"]] for p, c in policy_counts.items()},
            "tf_part_c": {p: c[k["name"]] for p, c in tf_counts.items()},
            "recipe": {p: c[k["name"]] for p, c in recipe_counts.items()},
            "audio": {p: c[k["name"]] for p, c in audio_counts.items()},
            "analysis": {p: c[k["name"]]
                         for p, c in analysis_counts.items()},
            "train": {p: c[k["name"]] for p, c in train_counts.items()},
            "misc_train": {p: c[k["name"]]
                           for p, c in misc_counts.items()},
            "tools": {p: c[k["name"]] for p, c in tools_counts.items()},
            "scale_out": {p: c[k["name"]]
                          for p, c in scale_counts.items()}}
        shapes = {**policy_rows.get(k["name"], {}),
                  **audio_rows.get(k["name"], {}),
                  **analysis_rows.get(k["name"], {}),
                  **misc_rows.get(k["name"], {}),
                  **scale_rows.get(k["name"], {})}
        if shapes:
            k["max_abs_err"] = max(k["max_abs_err"], *(
                r["max_abs_err"] for r in shapes.values()))
            k["by_shape"] = {**k.get("by_shape", {}), **{
                name: {key: r.get(key) for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "matmul_plus_kernel_ms", "max_abs_err", "tol")}
                for name, r in shapes.items()}}
    # the bf16 instantiations: launches on the bf16 training path
    emit({"kernels": kernels + bf16_entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # any failed phase: report and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
