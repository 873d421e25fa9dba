#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``), builds every kernel
of the main path from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
source, all at once), and exits non-zero — printing no result — when there
is no card, when a kernel fails to build or launch or disagrees with its
plain PyTorch version, or when any phase fails.  It aims to finish within
520 s, build included; to fit that, some paths run at a smaller depth than
before (before -> after, in the order taken; widths and shapes, every
check and every limit unchanged; the phase seconds before and after are
in PERF.md):

- phases 3 and 4: ``gk_means`` 20 -> 10 -> 5 iterations (``ITERS``);
  phases 4 and 7: the graph builds at SIFT1M's shape τ 10 -> 5 rounds; the
  PQ codecs' training (phase 3 at SIFT_SMALL, phase 5 over all live rows)
  8 -> 1 engine epochs a subspace (``PQ_ITERS``);
- phase 5: the sweeps' rounds 3 -> 1;
- phase 6 at SIFT1M's shape: KGraph + GK-means 20 -> 4 -> 2 iterations,
  full BKM and the probe source 10 -> 3 -> 2 epochs, closure k-means 10 ->
  3 -> 2 iterations (the SIFT_SMALL kernels-vs-plain runs keep 20, 10 and
  10);
- phase 7: ``gk_means`` with telemetry off and on 20 -> 3 -> 2
  iterations, the one-epoch on/off runs 12 -> 4;
- phase 9: the emulated ``engine.run`` 6 -> 2 epochs, the NCCL group's
  ``ShardedEngine.run`` against ``engine.run`` 6 -> 2 epochs;
- phase 12: (b)'s teacher-forced steps 8 -> 4;
- phase 13: Mamba2-2.7B 64 -> 32 -> 16 layers; phase 14: RecurrentGemma-9B
  38 -> 20 -> 11 layers (3 groups and the tail of 2); their long prompts
  kept;
- phase 16: (a)'s 2 Adafactor steps dropped ((c) trains with Adafactor at
  the same width);
- phases 11, 12 and 14: the card-against-CPU copies in bf16 dropped, their
  float32 copies kept (phase 11's copy, in bf16 until then, runs in
  float32); the CPU tests hold bf16 layer by layer against the JAX
  package.

Not cuts: the plain-version graph builds (phase 4's recall reference and
phase 9's emulation) refine ``REF_CHUNK`` = 131,072 rows a call (was
32,768 and 1,024; a row's refinement is independent of the others'),
traces are read from the profiler's raw results (``_device_events``), and
a kernel's device time is the median of three whole traces, a trace that
reads below the kernel's bound dropped (``kernel_device_us``).
Each log line carries the seconds since the start; the phases' own seconds
are printed as one ``{"phase_seconds": ...}`` line.  Phases:

1. build the kernels; print their build times, ptxas reports, and the
   card's name and power limit;
2. hold each kernel against its plain version on the card, at the shapes
   the main paths give it, and time kernel, plain version and a PyTorch
   yardstick:
   - ``gather_score`` in both modes at B=1024, C=50, d=128, k=16384 and at
     GIST1M's width (d=960, k=10,000), each with its row layout (lanes a
     row, rows a warp, samples a CTA), its byte bound beside the practical
     floor (the gathered rows at the L2 rate, measured in the run) and its
     device launches per call (must be 1), and ``refine_merge`` at B=1024,
     C=136, κ=50, d=128, N=1,048,576, on states a run reaches (consistent
     cluster sums with empty and one-row clusters; a build round's member
     table with phantom twins and old lists that share ids with the
     candidates); scores are held per element against the size of the
     terms that cancel in them;
   - ``probe_centroids`` at nq=10,000, k=16,384, d=128, p in {1, 16, 64},
     and at one served batch (64 queries, p=16), each with its split plan
     printed (row tile, centroids per chunk, chunks S, CTAs), and
     ``assign_centroids`` (3xTF32 on the tensor cores) at n=10,000 (an
     ``add`` batch), n=1,000,000 (a Lloyd assignment) and PQ training's
     shape (1,010,000 x 16, k=256), with k rows of the data as centroids:
     distances per slot within 1e-5·(||x||² + ||c||²), ids equal except at
     near-ties (counted), its split plan and both bounds (3xTF32 at 495/3
     TFLOP/s, FP32 at 67) printed, inputs rounded to TF32 as a planted
     fault, and S = 1 against the card's plan bit for bit; device time per
     call is the sum of a call's launches (the split kernels make two when
     their plan splits);
   - ``pairwise_sq``, which no path of the system calls, so one counted
     call per shape through ``ops.pairwise_sq`` is its path: SIFT1M's
     graph-build shape (phase 2's X as B=15,625 clusters of m=64, d=128),
     VLAD10M's width (B=2,048, m=64, d=512) in f32 and bf16, GIST1M's width
     (B=1,024, m=64, d=960) and m=128 at d=128: every element within
     1e-5·(||x_i||² + ||x_j||²), finite and non-negative, each D[b] exactly
     symmetric; timed beside ``torch.bmm`` and ``torch.baddbmm``
     yardsticks;
   planted faults in the plain versions must fail these limits;
3. parity on the card at the SIFT_SMALL shape (n=65,536, d=128, k=1,024,
   κ=32, ξ=64, τ=8): ``gk_means`` through the kernels and with
   ``force="ref"`` from the same generator seeds — distortion within 1%,
   graph recall@κ within 0.02; then the IVF index over that clustering:
   ``add`` of 4,096 rows through the kernels and the plain versions (same
   layout), ``exhaustive_search`` against brute force, ``search`` at
   nprobe 1, 8, 64 against the plain versions, and ``search`` with codec
   int8 and PQ nsub=8 (rerank at its default and 0; reranked d2 against
   the exact distance) and qgroup=8 (also against the per-query search);
4. the main path at SIFT1M's published shape (n=1,000,000, d=128,
   k=10,000 -> 16,384, κ=50, ξ=64, τ=5, 5 iterations, batch 1024) on
   ``sift_like`` data: stage seconds, distortion history, recall@κ on
   1,000 sampled rows against brute force, peak memory, host syncs (the
   run is under ``obs.syncs.sync_counter``: sync-debug mode "error", so a
   sync other than its counted reads raises) and each kernel's launches —
   every count is zeroed just before this run and read just after; the
   graph's recall must lie within 0.02 of the same build's (same draws)
   through the plain versions, on the same rows (that build refines
   ``REF_CHUNK`` rows a call, and also records its per-round telemetry
   for phase 7); then,
   outside the counted run, torch.profiler traces of one engine epoch and
   a two-round graph build at that shape (device-busy time, idle share,
   top kernels);
5. the serving path on phase 4's data and clustering (counts zeroed just
   before, read just after): ``build_ivf`` (block_rows=128), ``add`` of
   10,000 fresh rows, and ``serve_index.sweep`` of nq=10,000 queries at
   nprobe 1..64, topk=10, batch 64, 3 rounds — recall@10 against brute
   force over all 1,010,000 live rows, scan share, p50/p90/p99 ms per
   batch, QPS, host syncs inside the timed ``search`` calls (each under
   ``sync_counter``; must be 0);
   recall must not fall with nprobe and must lie within 0.002 of the plain
   versions' on the same queries; then ``ivf_scan`` against its plain
   version on that index (nq=10,000 at nprobe 16 and 64 with topk=10 and
   at nprobe 1 with topk=100, and one served batch of 64 queries at
   nprobe 16, topk=10), each with its split plan printed (chunks S of each
   query's live slots, CTAs) and its planted faults (for a split plan also
   each query's first chunk dropped), and a torch.profiler trace of an
   nprobe=16 batch loop; then three more sweeps on the same index and
   queries at nprobe 1, 4, 16, 64, each its own counted run: codec int8,
   codec PQ (nsub=8, trained on all live rows inside the run, ``PQ_ITERS``
   epochs a subspace) and qgroup=8
   — the same numbers plus bytes per scanned row and the codec's training
   seconds, the same gates (PQ's recall is reported, not held to rise with
   nprobe: see ``serve_codec_paths``); then ``ivf_scan_adc`` against its
   plain version at nprobe=16, topk=40 for int8 (M=128), PQ nsub=8 and PQ
   nsub=32 (a 32 KB table, codebooks from 65,536 sampled rows), and for
   one served batch of 64 queries in int8 and PQ nsub=8 (split plans, each
   with each query's first live-slot chunk dropped as a planted fault), and
   ``ivf_scan_grouped`` at G=8, nprobe=16, topk=10 for all 10,000 queries
   and for one served batch of 64 (8 groups, its split plan printed), each
   with planted faults (for the split kernels: the plan's last chunk
   dropped), and traces of a PQ, an int8 and a qgroup=8 batch loop;
6. the paper's baselines and graph search on phase 4's data, each path a
   counted run of its own (counts zeroed just before, read just after; its
   seconds on the host clock, device synchronised at the edges): NN-Descent
   (κ=50, 10 iterations, sample 100; recall@50 and recall_top1 on 1,000
   sampled rows), KGraph + GK-means over that graph (k=10,000 -> 16,384,
   2 iterations), Lloyd (k=10,000, k-means++ init timed apart, 30
   iterations with the early stop), Mini-Batch (k=10,000, batch 1,024,
   10·(n // 1,024) steps), full BKM over the dense source and the engine's
   probe source (p=16, bkm), both k=16,384 from the 2M tree for 2 epochs
   (the probe run's host syncs, under ``sync_counter``, must be epochs +
   1),
   closure k-means (k=10,000 -> 16,384, 3 trees of leaf 32, 2 iterations)
   and graph search over phase 4's GK-means graph (phase 5's 10,000
   queries, topk=10, ef=32, 24 rounds; recall@10 against the exact top 10
   of X); every kernel a path names must launch; then each kernel at these
   paths' shapes against its plain version (``assign_centroids`` at
   n=10^6, k=10,000; ``probe_centroids`` at B=1,024, k=16,384, p=16;
   ``gather_score`` at C=17 and C=93; ``refine_merge`` at NN-Descent's
   chunk, B=4,096, C=200), and at the SIFT_SMALL shape each path with a
   kernel twice from equal generators, through the kernels and with
   ``force="ref"``: NN-Descent's recall@κ within 0.02, final distortions
   within 1%, Mini-Batch's final assignment against the plain
   ``assign_centroids``;
7. the observability layer (``repro_torch.obs``) on phase 4's data:
   ``gk_means`` over phase 4's graph with telemetry off and on (same
   seed, 3 iterations), each under ``sync_counter`` (host syncs = epochs
   + 1), the rows
   held against the result (moves, distortion, proposed >= moves, hit
   rate, empty clusters, zero rows past the epochs run), the iter stage
   and one-epoch runs on against off (telemetry's cost); the main path's
   graph build through the kernels with telemetry (0 host syncs, rows
   equal to its diagnostics, mean list distance non-increasing, each
   round within 1% of phase 4's plain-version build, round 0's overflow
   equal); torch.profiler traces of 40 f32 served batches and an engine
   epoch, in which every kernel launch lies in a
   ``repro_torch.kernels.<name>`` range and the ranges equal the wrapper
   calls; and ``engine``, ``graph_build`` and ``kernels`` run records
   (``obs.emit``, in a temporary directory) read back by
   ``launch/obs_report.py`` (rc 0, all eight kernels, every achieved
   fraction of the roofline at most 1);
8. clustered-KV decode (``core.kv_cluster``) at Qwen2-72B's attention
   widths in ``benchmarks/kv_cluster_bench.py``'s full setting (B=16,
   S=32,768, Hkv=8, G=8, hd=128, bf16 caches, kc=512, top_c=8; counts
   zeroed just before, read just after: none of the eight kernels may
   launch): a build without refinement (every key in its table once) and
   one with two dense engine epochs at cap_factor 8 (keys dropped by the
   cap printed), each under ``sync_counter`` (0 host syncs); kernel
   launches of one ``run_slices`` epoch against one slice's ``engine.run``
   epoch (runtime calls in a trace); full and clustered attention, each
   call under ``sync_counter`` (0 host syncs), timed, with keys touched,
   cache bytes read a step and ``candidate_recall``; top_c = kc against
   ``decode_attention`` within rtol = atol = 1e-2, two batch rows at a
   time; peak memory; then the bench's quick shape (B=4, S=8,192, Hkv=4,
   G=4, hd=64, kc=128) built on the card and on the CPU from the same
   draws: per-slice distortion within 1%, candidate recall within 2/64;
9. the sharded topology (``core/distributed.py`` and the engine's R-way
   emulation) on phase 4's data, each stage a counted run: (a) the R = 4
   emulation at SIFT1M's shape — ``build_knn_graph(shards=4)`` (under
   ``sync_counter``: 0 host syncs), the 2M-tree init, ``engine.run(shards=4,
   sparse_updates=True)`` (epochs + 1 host syncs with the final read) and
   one epoch of the emulated probe source (p=16: ``probe_centroids`` and
   ``gather_score`` per shard), once through the kernels and once through
   the plain versions (cut: τ 2, 2 epochs): recall@κ within 0.02,
   distortions within 1%; (b) a world-size-1 NCCL group (NCCL takes one
   rank a card; ranks that exchange data run in the CPU tests):
   ``GraphBuilder`` at SIFT_SMALL against the one-device build (recall
   within 0.02, 0 host syncs), ``ShardedEngine.run`` on phase 4's graph
   against ``engine.run`` from the same init (1 epoch; rows counted n,
   distortion within 1%, host syncs epochs + 1) and ``ShardedIvf.search``
   on phase 5's index (10,000 queries, nprobe 16; f32, qgroup 8, int8 and
   PQ nsub=8 at rerank 0: ids equal to ``search``'s, 0 host syncs, the four
   telemetry slots equal to the host's counts; the codecs' default rerank
   recalls no less); each stage's seconds and launches printed;
10. the analysis layer, the autotune table and the clustering dry run
   (``repro_torch.analysis``, ``kernels/autotune.py``,
   ``launch/dryrun_cluster.py``): (a) the linter over the tree against
   ``analysis/baseline.json`` (0 new findings, 0 stale); (b) each
   ``autotune_table.json`` entry at its shape (the sweep's: SIFT1M-shaped
   rows, k = 16,384 cells, the probe at 10,000 queries, at one served
   batch of 64 and at the probe source's 1,024 rows, the scans at one
   served batch at nprobe 16), the table's knob against today's default:
   ``torch.equal`` outputs, both CUDA-event times; (c) the
   contract audit through an NCCL group of one (host syncs, collective
   budgets at R = 1, dtypes; sync-debug mode "error" inside each call);
   (d) the whole dry run on ``meta`` (24 cells: VLAD10M and SIFT1M, dense /
   sparse / sparse_bf16, bkm / lloyd, R = 256 / 512); (e) one rank's epoch
   for real at SIFT1M with R = 64, dense and sparse, through a
   ``RecordingComm`` on the card: ``torch.cuda.max_memory_allocated``
   within 10% of the dry run's argument + temporary bytes of the same
   cell, and the same recorded wire bytes;
11. the dense LM serving path (``launch/serve.py::serve`` over
   ``models/model.py``; plain PyTorch, none of the eight kernels may
   launch) at Qwen2-72B's published widths (d_model 8,192, 64 query and 8
   KV heads of 128, d_ff 29,568, vocab 152,064, QKV bias, rope_base 1e6),
   depth cut from 80 layers to 8: (a) ``serve`` at batch 4, prompt 1,024,
   32 greedy tokens — prefill and decode seconds, each decode step's
   CUDA-event ms beside its bytes bound (every weight but the embedding
   table once, at the data sheet's 3.35 TB/s), tokens a second, peak
   memory, host syncs inside ``decode_step`` (each under
   ``sync_counter``: must be 0); (d) the same run again: equal tokens;
   (b) the prompt plus 8 teacher-forced steps against one prefill of the
   longer sequence, within the reference test's limits (max|Δ| /
   max(max|want|, 1) < 0.15, top-1 >= 0.5), then a trace of 8 decode
   steps and one layer's prefill attention timed beside
   ``F.scaled_dot_product_attention`` (a yardstick); (c) a 2-layer copy of
   the same parameters in float32 at batch 2, prompt 64, prefill and 4
   teacher-forced steps on the card and on the CPU: logits within 0.03 of
   max|want|, top-1 equal but at near-ties; any failed check raises;
12. MoE serving (``models/moe.py`` through the same entry points; plain
   PyTorch, none of the eight kernels may launch) at Qwen1.5-MoE-A2.7B's
   published widths and all 24 layers (d_model 2,048, 16 heads of 128, 60
   experts top-4 of d_ff 1,408, 4 shared experts, vocab 151,936; 28.6 GB
   of bf16): (a) ``serve`` at batch 4, prompt 1,024, 32 greedy tokens —
   the same figures as phase 11, the step's bytes bound reading every
   expert (as the reference's dispatch does) and, beside it, the bytes
   the steps route to; (d) the same run again: equal tokens; (b) the
   prompt plus 4 teacher-forced steps against one prefill of the longer
   sequence at capacity factor 64 (two prefill lengths drop different
   pairs at the configured 1.25; the reference after each step is
   ``prefill`` of the prompt and the forced tokens), per step and row:
   each layer's MoE input up to the first layer where the token's experts
   differ (a router near-tie flipped by the two paths' bf16 sums; its
   margins are printed), the logits where no layer differs or the first
   difference is not a near-tie, within the reference test's limits, and
   at least a quarter of the (layer, pair) MoE inputs checked; every
   decode layer's MoE output against its experts run token by token in
   float32; the steps' distinct experts a layer counted; then a trace of
   4 steps; (c) a 2-layer copy at batch 2, prompt 64, at the configured
   capacity factor on the card and the CPU in float32, within phase 11's
   limits, every token routed alike (those routed differently printed
   with their margins); (e)
   Grok-1's widths (d_model 6,144, 48/8 heads, 8 experts top-2 of d_ff
   32,768, vocab 131,072) at 2 of 64 layers, batch 2, prompt 256, 8
   greedy tokens twice: equal tokens, 0 syncs, finite logits; any failed
   check raises;
13. Mamba-2 serving (``models/ssm.py``; plain PyTorch, none of the eight
   kernels may launch) at Mamba2-2.7B's published widths and 16 of its 64
   layers: ``serve`` at batch 4, prompt 1,024 (twice, equal tokens) and at
   batch 1, prompt 32,768; decode against one prefill of the longer
   sequence end to end and layer by layer (``ssm_decode_vs_prefill``), in
   bf16 and in float32; a 2-layer copy on the card and the CPU;
14. RecurrentGemma serving (``models/rglru.py``, the hybrid family; plain
   PyTorch, none of the eight kernels may launch) at RecurrentGemma-9B's
   published widths and 11 of its 38 layers (d_model and lru_width 4,096,
   16 query heads of 256 and one KV head, d_ff 12,288, vocab 256,000,
   pattern (rec, rec, attn), window 2,048, conv width 4; 3 groups and the
   tail of 2): (a) ``serve`` at batch 4, prompt 1,024, 32 greedy tokens, the
   step's bytes bound reading every weight but the embedding, the valid
   ring slots and the recurrent states; (d) the same run again: equal
   tokens; (e) batch 1 at an 8,192-token prompt: prefill seconds, peak
   memory, the step beside (a)'s, finite logits, 0 syncs, the cache the
   size of the 1,024-token one; (b) a 2,040-token prompt and 16
   teacher-forced steps across position 2,048 against one prefill of 2,056
   tokens, in bf16 and in a float32 copy, each layer on the prefill's own
   layer inputs (outputs, h, conv tails, rings: bf16 within 0.15, float32
   within 1e-3 of max|want|) and the float32 logits end to end (0.15,
   top-1 >= 0.5), with a trace of 8 batch-4 decode steps; (c) a 4-layer
   copy (one group and a tail layer) with the window cut to 64, prompt 200
   and 4 steps on the card and the CPU in float32, within phase 11's
   limits; any failed check raises;
15. Whisper and the VLM patch frontend (the audio and vlm families of
   ``models/model.py``; plain PyTorch, none of the eight kernels may
   launch) at their published widths and full depth: Whisper-base (6
   encoder and 6 decoder layers, d_model 512, 8 heads of 64, d_ff 2,048,
   vocab 51,865, layer norms, GELU, sinusoidal positions) and
   InternVL2-2B (24 layers, d_model 2,048, 16/8 heads of 128, d_ff 8,192,
   vocab 92,553, 256 patches of 1,024 features): (a) ``serve`` twice
   (Whisper: batch 16, prompt 448, as many frames; the VLM: batch 4, 256
   patches and 1,024 tokens; 32 greedy tokens each): equal tokens, each
   step's CUDA-event ms beside its bytes bound (Whisper's: the decoder's
   weights but the cross k/v projections, ``lm_head``, the valid
   self-attention slots and the cross-attention ``xk``/``xv`` read whole),
   0 host syncs, peak memory; (b) Whisper at the shape users run, one 30 s
   window of 1,500 frames and a 4-token prompt, through
   ``make_prefill``/``make_decode_step`` for 64 steps (0 syncs, finite,
   the ``xk``/``xv`` bytes printed); (c) the prompt plus 8 teacher-forced
   steps against one prefill of the longer sequence, in bf16 and in a
   float32 copy, at the reference test's limits, with a trace of 8 decode
   steps; (d) a 2-layer copy on the card and the CPU, bf16 and float32,
   within phase 11's limits; any failed check raises;
16. LM training (``Model.loss``, ``lm_loss``, remat, ``train/
   optimizer.py``, ``train/train_step.py``, ``train/checkpoint.py`` and
   the trainer loop ``launch/train.py``; plain PyTorch, none of the
   eight kernels may launch) at Qwen1.5-4B's published widths and all 40
   layers (d_model 2,560, 20 heads of 128, d_ff 6,912, vocab 151,936, QKV
   bias; 3,950,369,280 parameters): (a) bf16, remat ``full``, one fixed
   batch of 2 × 2,048 tokens (a repeating pattern), the config's AdamW at
   lr 3e-4 and warm-up 1: one warm-up and 6 timed steps (CUDA events, the
   timed ones under ``sync_counter``: 0 host syncs), ms a step against
   ``train_bounds``, tokens/s, peak memory, the state's bytes, the loss
   each step (finite, lower at the end) and the grad norm; a trace of one
   more step (busy, idle, matmul share, top kernels); a ``full`` and
   a ``dots`` step from the same parameters (loss within 1e-6, grad norm
   within 1e-4, both peaks); (b) a 2-layer full-width copy in float32 on
   the card and the CPU at batch 1 × 128: loss, grad norm, every clipped
   grad, and the parameters after one AdamW and one Adafactor step from
   the CPU's grads on both, within ``TRAIN_TOL``; (c) the trainer loop
   ``launch/train.py::train`` with Adafactor at the same width and batch
   (``log_every`` 1): U, 4 steps without a checkpoint (under
   ``sync_counter``: one host sync a step, the loss read); A, 2 steps into
   a fresh temporary directory (its final save the only one); B,
   ``resume=True`` there to 4 steps — the state B restores equal to A's
   final parameters and Adafactor state bit for bit, leaf by leaf, on the
   card, B's losses at steps 2-3 within 1e-3 of U's (the reference test's
   limit), every loss finite, the largest difference of U's and B's final
   parameters printed; each checkpoint's bytes, each save's and the
   restore's seconds and GB/s (their parts apart), the disk's free space
   (the phase raises without room for two checkpoints), the loop's ms a
   step and tokens/s beside (a)'s; beside A and B, ``python -m
   repro_torch.launch.train --preset smoke`` without ``--device``: a
   crash at step 3 (exit 42, latest step 2), then ``--resume`` (resumed
   from step 2, exit 0); the directories removed at the end; any failed
   check raises;
17. one JSON line of the sharded topology, one of the baselines (each
   path's seconds, quality and launches), one of clustered-KV decode, one
   of phase 10 (``{"dryrun": ...}``), one of the kernels (with each
   kernel's launches on the baselines' paths, its numbers at their shapes,
   its launches in phase 9 and its ``autotune`` field: the table's knob,
   its entries' shapes and knobs and phase 10's times, or "exempt" with
   the reason), one each of phases 11–16 (``{"lm_serve": ...}``,
   ``{"lm_moe": ...}``, ``{"lm_ssm": ...}``, ``{"lm_hybrid": ...}``,
   ``{"lm_audio_vlm": ...}``, ``{"lm_train": ...}``), the phases' seconds
   (``{"phase_seconds": ...}``, the build and the start-up included), the
   card's ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Every bound comes from ``launch/roofline.py``'s inventory and every
CUDA-event time from ``obs.timing.device_span``.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

T_START = time.perf_counter()   # the process's start, for phase_seconds
HERE = Path(__file__).resolve().parent

sys.path.insert(0, str(HERE / "src"))
from repro_torch.configs import gkmeans_paper as _paper  # noqa: E402


def _shape(c):
    """A ``configs.gkmeans_paper.ClusterConfig``'s shape as the dict the
    phases read."""
    return dict(n=c.n, d=c.d, k=c.k, kappa=c.kappa, xi=c.xi, tau=c.tau)


SIFT_SMALL = _shape(_paper.SIFT_SMALL)   # Table 1's CPU-scaled analogue
# Table 1; its graph builds (phases 4 and 7) run 5 of the table's τ = 10
# rounds, cut to fit the script's time
SIFT1M = dict(_shape(_paper.SIFT1M), tau=5)
# gk_means iterations of phases 3 and 4 (cut 20 -> 10 -> 5 to fit the
# script's time; the paper's SIFT1M setting runs 20)
ITERS = 5
# rows per refine call of phase 4's plain-version build: the plain merge
# is ~700 small ops per call, so at the build's default 1,024 rows the
# launches dominate (199.5-279.0 s for 10 rounds on the H100; 30.2 s at
# 32,768 rows a call); the rows of a call are independent, and a
# 131,072-row call gathers ~9.2 GB
REF_CHUNK = 131072
BATCH = 1024
COMPONENTS = 256        # mixture components of the synthetic data
# gather_score vs plain: |got - want| <= SCORE_RTOL * ref.score_scale, per
# element.  A d-term f32 dot rounds by at most d*2^-24 (7.6e-6 at d=128) of
# ||x||*||D_row||, a term of the scale; typical errors are far smaller.
SCORE_RTOL = 1e-5
EMPTY, SINGLE = 8, 4    # empty and one-row clusters of the check's state
RECALL_TOL = 0.02       # kernels vs plain build, recall@κ on the same rows
SEED = 0
DEV = "cuda"


def log(*a):
    """Print, each line stamped with the seconds since the process
    started."""
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, sets, reps=40):
    """Mean ms per call over ``reps`` calls cycling through ``sets``
    (``obs.timing.device_span``: CUDA events around the calls)."""
    import torch
    from repro_torch.obs.timing import device_span
    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    ms = {}
    with device_span("calls", ms):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    return ms["calls"] / reps


def _trace(fn):
    """Trace ``fn`` with torch.profiler (CPU and CUDA activity): (the
    profiler, wall seconds of fn)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


class _Interval(NamedTuple):
    start: float    # us
    end: float


class _Activity(NamedTuple):
    name: str
    time_range: _Interval


def _device_events(fn):
    """(the device activities of a trace of ``fn``, wall seconds of fn),
    each with its ``name`` and ``time_range`` (us): the kernel scopes'
    ranges, which the trace also shows on the device timeline, are left
    out.  Read from the profiler's raw results: building its per-event
    Python objects (``prof.events()``) took 19-42 s for one traced engine
    epoch or two-round graph build (34,000-69,000 device activities)."""
    import torch
    from repro_torch.obs.timing import SCOPE_PREFIX
    prof, wall = _trace(fn)
    cuda = torch.autograd.DeviceType.CUDA
    return [_Activity(ev.name(), _Interval(
        ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3))
        for ev in prof.profiler.kineto_results.events()
        if ev.device_type() == cuda
        and not ev.name().startswith(SCOPE_PREFIX + ".")], wall


WHOLE_TRACES = 3     # kernel_device_us: the median of this many traces


def kernel_device_us(fn, sets, names, reps=20, tries=8, *, launches=1,
                     bound_ms):
    """Mean device time (us) per call of ``fn``: the summed durations of
    the launches of the kernels ``names`` (one name or a tuple; a launch
    matches when one of them is in its kernel's name), ``launches`` of them
    per call, from torch.profiler traces of ``reps`` calls.

    On the H100 machines, from a minute or so into the process, a trace now
    and then loses the records of its first launches, all of them in a
    short trace (framing the window with spin kernels did not prevent it:
    the frame was lost with them); and a trace that keeps every launch can
    still read below ``bound_ms``, the least time the call can take
    (``ivf_scan`` at nq=10,000, nprobe 16: 1,313.75 us against 2.64 ms a
    call by CUDA events), which no run can reach.  Traces are taken, up to
    ``tries`` of them, until WHOLE_TRACES of them kept all ``launches *
    reps`` launches and read at least ``bound_ms`` a call; a whole trace
    that reads less is dropped, and the log counts it.  The result is the
    median per-call time of the whole traces kept, else the sum over the
    kernels of each one's mean time per launch over every launch the other
    traces kept, and None when none was.
    """
    if isinstance(names, str):
        names = (names,)

    def run():
        for i in range(reps):
            fn(*sets[i % len(sets)])
    kept = {name: [] for name in names}
    means, dropped = [], []
    label = "+".join(names)
    for t in range(1, tries + 1):
        events, _ = _device_events(run)
        ts = {name: [ev.time_range.end - ev.time_range.start
                     for ev in events if name in ev.name] for name in names}
        count = sum(len(v) for v in ts.values())
        log(f"kernel_device_us({label}): trace {t} kept {count} of "
            f"{launches * reps} launches")
        if count != launches * reps:
            for name, v in ts.items():
                kept[name] += v
            continue
        mean = sum(sum(v) for v in ts.values()) / reps
        (means if mean >= bound_ms * 1e3 else dropped).append(mean)
        if len(means) == WHOLE_TRACES:
            break
    if dropped:
        log(f"kernel_device_us({label}): dropped {len(dropped)} whole "
            f"trace(s) below the bound {bound_ms * 1e3:.3f} us a call: "
            f"{dropped}")
    if means:
        log(f"kernel_device_us({label}): per-call means of the whole traces "
            f"kept {means}")
        return statistics.median(means)
    partial = [sum(v) / len(v) for v in kept.values() if v]
    return sum(partial) if partial else None


def bound_ms(name, peak=None, **shape):
    """(ms, "bytes" | "operations"): kernel ``name``'s bound at ``shape``,
    its arguments in ``launch/roofline.py``'s inventory (``peak``
    overrides the inventory's rate)."""
    from repro_torch.launch.roofline import kernel_terms
    t = kernel_terms(name, peak=peak, **shape)
    return (t["bound_s"] * 1e3,
            "bytes" if t["bottleneck"] == "memory" else "operations")


# --------------------------------------------------------------- phase 2

def score_errors(got, want, scale):
    """(inf pattern equal, max |got - want| / (SCORE_RTOL * scale), max
    |got - want|) over the finite entries of ``want``."""
    import torch
    fin = torch.isfinite(want)
    same_inf = torch.equal(torch.isfinite(got), fin) and torch.equal(
        got[~fin], want[~fin])
    diff = (got - want).abs()[fin]
    return (same_inf, float((diff / (SCORE_RTOL * scale[fin])).max()),
            float(diff.max()))


def planted_faults(x, u, cand, D, cnt, want, scale, mode, k):
    """Share of entries over the limit for the plain version with a planted
    fault (the wrong D row; for bkm also the ``||x||²`` term dropped).  A
    limit that lets a fault through cannot catch it in the kernel either."""
    import torch
    from repro_torch.kernels import ref
    faults = {"wrong_row": ref.gather_score(x, u, (cand + 1) % k, D, cnt,
                                            mode=mode)}
    if mode == "bkm":
        rows = torch.cat([u[:, None], cand], 1).long()
        faults["xsq_dropped"] = ref.scores_from_dots(
            ref.gather_dots(x, rows, D), cnt[rows], (D * D).sum(-1)[rows],
            torch.zeros_like(x[:, 0]), mode)
    out = {}
    for name, bad in faults.items():
        both = torch.isfinite(want) & torch.isfinite(bad)
        r = (bad - want).abs()[both] / (SCORE_RTOL * scale[both])
        out[name] = dict(frac_over=float((r > 1).float().mean()),
                         median_ratio=float(r.median()))
    return out


def score_state(X, k, g):
    """A state the engine can reach: a random assignment in which clusters
    0..EMPTY-1 are empty and the next SINGLE clusters hold one row each (rows
    0..SINGLE-1); D and cnt follow from it."""
    import torch
    from repro_torch.core.objective import cluster_stats
    assign = torch.randint(EMPTY + SINGLE, k, (X.shape[0],), generator=g,
                           device=DEV, dtype=torch.int32)
    assign[:SINGLE] = torch.arange(EMPTY, EMPTY + SINGLE, device=DEV,
                                   dtype=torch.int32)
    D, cnt = cluster_stats(X, assign, k)
    return assign, D, cnt


def l2_rate(nbytes=16 << 20, copies=50, reps=20):
    """Bytes/s of ``dst.copy_(src)`` on an ``nbytes`` f32 buffer that stays
    in the 50 MB L2 (read + write bytes over CUDA-event time of a CUDA
    graph of ``copies`` copies, so no host launch gap counts): the L2 rate
    that sets ``gather_score``'s practical floor."""
    import torch
    src = torch.ones(nbytes // 4, device=DEV)
    dst = torch.empty_like(src)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            dst.copy_(src)
    ms = time_ms(graph.replay, [()], reps) / copies
    return 2 * nbytes / (ms * 1e-3)


def device_launches(fn, reps=10, tries=8):
    """(device activities per call of ``fn``, their names) from a
    torch.profiler trace of ``reps`` calls; a trace that lost records (see
    kernel_device_us) is taken again, and (None, names) is returned when
    none kept a whole number of activities per call."""
    names = set()
    for _ in range(tries):
        events, _ = _device_events(lambda: [fn() for _ in range(reps)])
        names |= {_short(ev.name) for ev in events}
        if events and len(events) % reps == 0:
            return len(events) // reps, sorted(names)
    return None, sorted(names)


GIST = dict(d=960, k=10_000, n=200_000)  # GIST1M's width and k


def check_gather_score(X, k, label="sift1m", C=SIFT1M["kappa"]):
    """gather_score vs its plain version at B=1024, C (default 50), X's
    width, k."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gather_score import layout
    B = BATCH
    n, d = X.shape
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    assign, D, cnt = score_state(X, k, g)
    sets = []
    for i in range(8):
        idx = torch.randint(0, n, (B,), generator=g, device=DEV)
        if i == 0:
            idx[:SINGLE] = torch.arange(SINGLE, device=DEV)  # singleton u
        cand = assign[torch.randint(0, n, (B, C), generator=g, device=DEV)]
        # a stale candidate list may name a cluster that has since emptied
        cand[::25, -1] = torch.randint(0, EMPTY, (cand[::25].shape[0],),
                                       generator=g, device=DEV,
                                       dtype=torch.int32)
        sets.append((X[idx].contiguous(), assign[idx].contiguous(),
                     cand.contiguous(), D, cnt))
    lay = layout(d)._asdict()
    log(f"gather_score[{label}] layout at d={d}: {lay['lanes']} lanes a "
        f"row, {lay['rows_per_warp']} rows a warp, {lay['samples_per_cta']} "
        f"samples a CTA of 8 warps, {lay['slices']} float4 slices of x a "
        "lane")
    out = {"layout": lay, "shape": f"B={B} C={C} d={d} k={k}"}
    for mode in ("bkm", "lloyd"):
        x, u, cand, _, _ = sets[0]
        got = ops.gather_score(x, u, cand, D, cnt, mode=mode)
        want = ops.gather_score(x, u, cand, D, cnt, mode=mode, force="ref")
        scale = ref.score_scale(x, u, cand, D, cnt, mode=mode)
        torch.cuda.synchronize()
        same_inf, ratio, err = score_errors(got, want, scale)
        faults = planted_faults(x, u, cand, D, cnt, want, scale, mode, k)
        caught = all(f["frac_over"] > 0.5 for f in faults.values())
        ok = same_inf and ratio <= 1.0 and caught
        ms = time_ms(lambda *a: ops.gather_score(*a, mode=mode), sets)
        plain = time_ms(lambda *a: ops.gather_score(*a, mode=mode,
                                                    force="ref"), sets)
        out[mode] = dict(max_abs_err=err, max_err_over_limit=ratio,
                         faults=faults, ok=ok, ms=ms, plain_ms=plain)
        log(f"gather_score[{label} {mode}] B={B} C={C} d={d} k={k}: "
            f"max_abs_err {err:.3e}, max err/limit {ratio:.3e} (limit "
            f"{SCORE_RTOL:g}*score_scale per element), inf pattern "
            f"{'equal' if same_inf else 'DIFFERS'}; planted faults in the "
            f"plain version {json.dumps(faults)} "
            f"{'OK' if ok else 'FAIL'}; kernel {ms:.4f} ms per wrapper call,"
            f" plain {plain:.4f} ms")
    # device time per launch and device launches per call, traced after
    # all the event timings above (a trace's teardown must not land inside
    # a timed window)
    from repro_torch.launch.roofline import kernel_terms
    shape = dict(B=B, C=C, d=d, k=k)
    nbytes = kernel_terms("gather_score", **shape)["hbm_bytes"]
    bms, by = bound_ms("gather_score", **shape)
    for mode in ("bkm", "lloyd"):
        fn = (lambda *a: ops.gather_score(*a, mode=mode))
        out[mode]["device_us"] = kernel_device_us(fn, sets,
                                                  "gather_score_kernel",
                                                  bound_ms=bms)
        per_call, names = device_launches(lambda: fn(*sets[0]))
        out[mode]["device_launches_per_call"] = per_call
        # a trace that lost records cannot count them, but one that shows
        # any other device activity fails
        one = names == ["gather_score_kernel"]
        out[mode]["ok"] = out[mode]["ok"] and one and per_call in (1, None)
        log(f"gather_score[{label} {mode}] kernel device time per launch: "
            f"{out[mode]['device_us']} us (torch.profiler); device "
            f"activities per wrapper call {per_call} ({names}) "
            f"{'OK' if one and per_call in (1, None) else 'FAIL'}")
    # yardstick: torch.bmm over pre-gathered rows computes the dots alone
    # (not the gather, not the scores) — no single PyTorch call computes
    # the whole function
    gsets = []
    for x, u, cand, _, _ in sets:
        rows = torch.cat([u[:, None], cand], 1).long()
        gsets.append((D[rows], x[:, :, None]))
    bmm = time_ms(torch.bmm, gsets)
    del gsets
    log(f"gather_score[{label}] yardstick: torch.bmm over pre-gathered "
        f"(B, C+1, d) rows, dots only: {bmm:.4f} ms")
    gathered = B * (C + 1) * d * 4
    rate = l2_rate()
    floor_us = gathered / rate * 1e6
    log(f"gather_score[{label}] bound: {nbytes / 1e6:.2f} MB unique bytes "
        f"-> {bms * 1e3:.3f} us at 3.35 TB/s ({by}; D stays in the 50 MB "
        f"L2); practical floor: gathered rows B*(C+1)*d*4 = "
        f"{gathered / 1e6:.2f} MB at the L2 rate {rate / 1e12:.3f} TB/s "
        f"(copy_ of an L2-resident 16 MiB buffer, read + write bytes, this "
        f"run) -> {floor_us:.3f} us")
    return dict(out, bound_ms=bms, bound_by=by, dots_bmm_ms=bmm,
                roof_shape=shape,
                l2_rate_tbs=rate / 1e12, l2_floor_us=floor_us,
                ok=all(out[m]["ok"] for m in ("bkm", "lloyd")))


def padded_copy(X):
    """(X_pad, real_id): X padded to the partition build's k0·ξ rows at
    SIFT1M's ξ, the phantom rows copies of random real rows."""
    import torch
    n, xi = X.shape[0], SIFT1M["xi"]
    n_pad = (1 << (-(-n // xi) - 1).bit_length()) * xi
    g = torch.Generator(device=DEV).manual_seed(SEED + 5)
    real_id = torch.cat([torch.arange(n, device=DEV), torch.randint(
        0, n, (n_pad - n,), generator=g, device=DEV)])
    return X[real_id], real_id


def refine_inputs(X_pad, real_id, n, ysq, g, B, kappa, xi=64, spill=8,
                  twins=16):
    """One chunk of a build round's refine, made the way a round makes it.

    B consecutive rows, each in its own cluster of xi members (itself,
    ``twins`` phantom rows together with the real rows they copy, so a
    candidate id comes twice, and random real rows).  A row's candidates
    are its cluster's member-table column (2*xi slots, xi filled) plus
    ``spill`` shared spill rows, self and phantoms of self masked; its old
    list, from an earlier round, already holds κ/2 ids of its co-members.
    """
    import torch
    from repro_torch.kernels import ref
    N = X_pad.shape[0]
    own = torch.randint(0, N - B, (1,), generator=g, device=DEV) + \
        torch.arange(B, device=DEV)
    ph = torch.randint(n, N, (B, twins), generator=g, device=DEV)
    other = torch.randint(0, n, (B, xi - 1 - 2 * twins), generator=g,
                          device=DEV)
    mine = torch.cat([own[:, None], ph, real_id[ph], other], 1)  # (B, xi)
    spill_rows = torch.randint(0, N, (spill,), generator=g, device=DEV)
    cand_rows = torch.cat([mine, torch.full_like(mine, -1),
                           spill_rows[None].expand(B, -1)], 1)
    own_id = real_id[own][:, None]
    cand = torch.where(cand_rows >= 0, real_id[cand_rows.clamp(min=0)], -1)
    cand = torch.where(cand == own_id, -1, cand).to(torch.int32)
    x = X_pad[own].contiguous()
    # the earlier round's list: the plain merge of κ/2 co-members and κ/2
    # random rows into an empty list
    cols = torch.randperm(xi, generator=g, device=DEV)[:kappa // 2]
    prev_rows = torch.cat([mine[:, cols], torch.randint(
        0, N, (B, kappa - kappa // 2), generator=g, device=DEV)], 1)
    prev = real_id[prev_rows]
    prev = torch.where(prev == own_id, -1, prev).to(torch.int32)
    old_ids, old_d = ref.refine_merge(
        x, prev_rows.to(torch.int32).contiguous(), prev.contiguous(),
        torch.full((B, kappa), -1, dtype=torch.int32, device=DEV),
        torch.full((B, kappa), float("inf"), device=DEV), X_pad, ysq=ysq)
    return (x, cand_rows.clamp(min=0).to(torch.int32).contiguous(),
            cand.contiguous(), old_ids, old_d, X_pad)


def refine_ids_ok(gi, wi, wd, tol):
    """Ids equal except at near-ties: every row lists distinct ids, and an id
    that differs from the plain version's stands in the plain version's row
    at a distance within ``tol`` of the one at its own position."""
    import torch
    s = gi.sort(1).values
    distinct = not bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any())
    same_id = gi[:, :, None] == wi[:, None, :]
    near = (wd[:, None, :] - wd[:, :, None]).abs() <= tol[:, :, None]
    explained = (same_id & near).any(-1)
    return distinct and bool(((gi == wi) | explained).all())


def check_refine_merge(X_pad, real_id, n, B=BATCH, C=136):
    """refine_merge vs its plain version at B (default 1024), C (default
    136: a member-table column of 2ξ slots plus 8 spill rows), κ=50, N."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.refine_merge import source_norms
    kappa = SIFT1M["kappa"]
    N, d = X_pad.shape
    g = torch.Generator(device=DEV).manual_seed(SEED + 2)
    ysq = source_norms(X_pad)
    sets = [refine_inputs(X_pad, real_id, n, ysq, g, B, kappa,
                          xi=(C - 8) // 2) for _ in range(8)]
    x, rows, cand, oi, od, _ = sets[0]
    gi, gd = ops.refine_merge(x, rows, cand, oi, od, X_pad, ysq=ysq)
    wi, wd = ops.refine_merge(x, rows, cand, oi, od, X_pad, ysq=ysq,
                              force="ref")
    torch.cuda.synchronize()
    scale = float((x * x).sum(1).max()) + float(ysq.max())
    tol = 1e-5 * wd.abs() + 1e-6 * scale
    fin = torch.isfinite(wd)
    same_fin = torch.equal(torch.isfinite(gd), fin)
    err = float((gd[fin] - wd[fin]).abs().max())
    tol_ok = bool(((gd[fin] - wd[fin]).abs() <= tol[fin]).all())
    ids_ok = refine_ids_ok(gi, wi, wd, tol)
    frac = float((gi != wi).float().mean())
    # how often the merge had to retire more than one copy of the id it took
    ent = torch.cat([oi, cand], 1)
    copies = (wi[:, :, None] == ent[:, None, :]).sum(-1)
    multi = int(((copies > 1) & (wi >= 0)).sum())
    ok = same_fin and tol_ok and ids_ok and multi > 0
    ms = time_ms(lambda *a: ops.refine_merge(*a, ysq=ysq), sets)
    plain = time_ms(lambda *a: ops.refine_merge(*a, ysq=ysq, force="ref"),
                    sets, reps=8)
    valid = cand >= 0
    uniq = int(torch.unique(rows[valid]).numel())
    pairs = int(valid.sum())
    from repro_torch.launch.roofline import HBM_BYTES_PER_S, kernel_terms
    shape = dict(B=B, C=C, kappa=kappa, d=d, uniq_rows=uniq, pairs=pairs)
    nbytes = kernel_terms("refine_merge", **shape)["hbm_bytes"]
    bms, by = bound_ms("refine_merge", **shape)
    dev_us = kernel_device_us(lambda *a: ops.refine_merge(*a, ysq=ysq), sets,
                              "refine_merge_kernel", bound_ms=bms)
    log(f"refine_merge B={B} C={C} kappa={kappa} d={d} N={N}: max_abs_err "
        f"{err:.3e} (tol rtol 1e-5 + 1e-6*{scale:.3e}); ids differing "
        f"{frac:.2e}, all at near-ties and distinct per row: {ids_ok}; "
        f"selected ids retired with more than one copy: {multi} of "
        f"{wi.numel()} {'OK' if ok else 'FAIL'}; "
        f"kernel {ms:.4f} ms per wrapper call ({dev_us} us device time per "
        f"launch), plain {plain:.4f} ms")
    gsets = [(s[5][s[1].long()], s[0][:, :, None]) for s in sets]
    bmm = time_ms(torch.bmm, gsets)
    log(f"refine_merge yardstick: torch.bmm over pre-gathered (B, C, d) rows,"
        f" dots only: {bmm:.4f} ms")
    log(f"refine_merge bound: {nbytes / 1e6:.2f} MB ({uniq} unique valid "
        f"rows of Xsrc) -> {bms * 1e3:.2f} us at 3.35 TB/s ({by}); "
        f"B*C*d*4 = {B * C * d * 4 / 1e6:.2f} MB -> "
        f"{B * C * d * 4 / HBM_BYTES_PER_S * 1e6:.2f} us")
    return dict(max_abs_err=err, ok=ok, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, dots_bmm_ms=bmm, id_mismatch_frac=frac,
                device_us=dev_us, roof_shape=shape)


# --------------------------------------------------------------- phase 3/4

def sampled_truth(X, kappa, count, seed):
    """(rows, their exact κ nearest neighbours) for ``count`` sampled rows."""
    import torch
    from repro_torch.core.recall import brute_force_knn
    g = torch.Generator(device=DEV).manual_seed(seed)
    rows = torch.randperm(X.shape[0], generator=g, device=DEV)[:count]
    return rows, brute_force_knn(X, kappa, chunk=256, rows=rows)


def recall_on(ids, truth, kappa):
    from repro_torch.core.recall import recall_at
    rows, gt = truth
    return float(recall_at(ids[rows], gt, kappa))


def parity_small():
    import torch
    from repro_torch.core.gkmeans import gk_means
    from repro_torch.data import sift_like
    c = SIFT_SMALL
    X = sift_like(c["n"], c["d"], COMPONENTS,
                  generator=torch.Generator(device=DEV).manual_seed(SEED))
    truth = sampled_truth(X, c["kappa"], 2000, SEED + 3)
    res, runs = {}, {}
    for force in (None, "ref"):
        t0 = time.perf_counter()
        r = gk_means(X, c["k"], kappa=c["kappa"], xi=c["xi"], tau=c["tau"],
                     iters=ITERS, batch_size=BATCH, force=force,
                     generator=torch.Generator().manual_seed(SEED),
                     device=DEV)
        rec = recall_on(r.graph.ids, truth, c["kappa"])
        res[force or "kernel"] = (r.distortion, rec)
        runs[force or "kernel"] = r
        log(f"SIFT_SMALL {'kernels' if force is None else 'force=ref'}: "
            f"distortion {r.distortion:.6f}, recall@{c['kappa']} {rec:.4f}, "
            f"epochs {len(r.history)}, {time.perf_counter() - t0:.1f} s")
    (dk, rk), (dr, rr) = res["kernel"], res["ref"]
    ok = abs(dk - dr) <= 0.01 * dr and abs(rk - rr) <= RECALL_TOL
    log(f"SIFT_SMALL parity: distortion rel diff {abs(dk - dr) / dr:.2e} "
        f"(limit 1e-2), recall diff {abs(rk - rr):.4f} (limit {RECALL_TOL}) "
        f"{'OK' if ok else 'FAIL'}")
    return ok, X, runs["kernel"]


def main_path(X):
    """Phase 4: the counted run, then the recall reference.  Returns (ok,
    launches, result, the plain-version build's per-round telemetry)."""
    import torch
    from repro_torch.core.gkmeans import gk_means
    from repro_torch.core.knn_graph import build_knn_graph
    from repro_torch.kernels import _build
    from repro_torch.obs import telemetry as obs_tel
    from repro_torch.obs.syncs import sync_counter
    c = SIFT1M
    log(f"main path: gk_means n={c['n']} d={c['d']} k={c['k']} "
        f"kappa={c['kappa']} xi={c['xi']} tau={c['tau']} iters={ITERS} "
        f"batch={BATCH}; cuts: iterations 20 -> 10 -> {ITERS}, tau 10 -> "
        f"{c['tau']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    # sync-debug mode "error": a sync other than gk_means' counted reads
    # raises
    with sync_counter() as sc:
        r = gk_means(X, c["k"], kappa=c["kappa"], xi=c["xi"],
                     tau=c["tau"], iters=ITERS, batch_size=BATCH,
                     generator=torch.Generator().manual_seed(SEED),
                     device=DEV)
    launches = dict(_build.launch_counts)
    syncs = sc.syncs
    peak = torch.cuda.max_memory_allocated()
    truth = sampled_truth(X, c["kappa"], 1000, SEED + 4)
    rec = recall_on(r.graph.ids, truth, c["kappa"])
    log(f"stage seconds: {json.dumps(r.seconds)}")
    log(f"distortion history: {r.history}")
    log(f"moves per epoch: {r.moves}")
    log(f"guided moves per round: {r.graph_diag.guided_moves.tolist()}; "
        f"member-table overflow per round: {r.graph_diag.overflow.tolist()}")
    log(f"final distortion {r.distortion:.6f}; recall@{c['kappa']} on 1000 "
        f"sampled rows vs brute force {rec:.4f}")
    # the same build (same draws) through the plain versions, outside the
    # counted run: the recall the kernels must match on the same rows, and
    # the per-round telemetry phase 7 holds the kernels' build against
    t0 = time.perf_counter()
    g_ref, d_ref = build_knn_graph(
        X, c["kappa"], xi=c["xi"], tau=c["tau"], chunk=REF_CHUNK,
        generator=torch.Generator().manual_seed(SEED), force="ref",
        device=DEV, telemetry=True, return_diagnostics=True)
    ref_tel = obs_tel.to_dict(d_ref.telemetry)
    rec_ref = recall_on(g_ref.ids, truth, c["kappa"])
    log(f"plain-version graph build (force='ref', {REF_CHUNK} rows a "
        f"refine call): recall@{c['kappa']} {rec_ref:.4f} on the same rows, "
        f"diff {abs(rec - rec_ref):.4f} (limit {RECALL_TOL}), "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"peak device memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    log(f"plain-version build telemetry per round: {json.dumps(ref_tel)}")
    log(f"host syncs: {syncs} counted by obs.syncs.sync_counter (any other "
        f"sync raises), {r.host_syncs} documented (epochs {len(r.history)} "
        "+ 1)")
    log(f"kernel launches on the main path: {json.dumps(launches)}")
    n, k2 = c["n"], r.k
    checks = {
        "launches": launches["gather_score"] > 0
        and launches["refine_merge"] > 0,
        "syncs": syncs == r.host_syncs,
        "assign": tuple(r.assign.shape) == (n,) and bool(
            ((r.assign >= 0) & (r.assign < k2)).all()),
        "centroids": tuple(r.centroids.shape) == (k2, c["d"]) and bool(
            torch.isfinite(r.centroids).all()),
        "distortion": r.distortion == r.distortion and
        r.history[-1] <= r.history[0],
        "recall": abs(rec - rec_ref) <= RECALL_TOL,
    }
    log(f"main-path checks: {json.dumps(checks)}")
    return all(checks.values()), launches, r, ref_tel

# --------------------------------------------------------------- IVF phases

# the serving path at SIFT1M's shape (repro.launch.serve_index's sweep)
SERVE = dict(nq=10_000, topk=10, probes=(1, 2, 4, 8, 16, 32, 64), batch=64,
             rounds=1, block_rows=128, add=10_000)   # rounds cut 3 -> 1
RECALL_GAP = 0.002      # kernels vs plain, recall@10 at each nprobe
DIST_RTOL = 1e-5        # |d2 - plain| <= DIST_RTOL*(||x||² + ||c||²) per slot
FAULT_Q = 1_024         # queries of the planted-fault scans


def sel_check(got, want, scale):
    """A selection (ids, d2) held against the plain version's: the -1/+inf
    pattern exact; per slot |d2 - plain| <= DIST_RTOL * scale (scale: the
    size of the terms that cancel, ||x||² + ||c||² of the plain version's
    pair); ids equal except where the two selected distances agree within
    that limit (the plain version's own margin is below the tolerance)."""
    import torch
    gi, gd = got
    wi, wd = want
    lim = DIST_RTOL * scale
    fin = torch.isfinite(wd)
    pattern = torch.equal(torch.isfinite(gd), fin) and torch.equal(
        gi[~fin], wi[~fin])
    gap = torch.where(fin, (gd - wd).abs(), torch.zeros_like(wd))
    within = fin & (gap <= lim)
    diff = gi != wi
    has = bool(fin.any())
    return dict(
        ok=pattern and bool((within == fin).all()) and not bool(
            (diff & ~within).any()),
        near_tie_slots=int((diff & within).sum()),
        max_abs_err=float(gap[fin].max()) if has else 0.0,
        max_err_over_limit=float((gap / lim)[fin].max()) if has else 0.0)


def _probe_fault(X, C, p, *, csq=True, keep=None):
    """The plain probe with a planted fault: ``||c||²`` dropped, or only the
    first ``keep`` centroids scanned (a merge that loses the split plan's
    last chunk)."""
    import torch
    from repro_torch.kernels import ref
    Ck = C if keep is None else C[:keep]
    part = -2.0 * (X @ Ck.T)
    if csq:
        part = (Ck * Ck).sum(-1)[None, :] + part
    cols = torch.arange(Ck.shape[0], dtype=torch.int32, device=DEV)
    d, ids = ref.stable_topk(part, cols.expand(X.shape[0], -1), p)
    return ids, torch.clamp(d + (X * X).sum(-1)[:, None], min=0.0)


def probe_plan(n, k, p):
    """The probe's split plan on this card (the autotune table's knob), as
    a dict."""
    from repro_torch.kernels import _build, autotune
    from repro_torch.kernels.centroid_assign import split_plan
    knob = autotune.resolve("probe_centroids", "cuda",
                            {"n": n, "k": k, "p": p}, None)
    return split_plan(n, k, p, _build.sm_count(0), knob)._asdict()


def assign_plan(n, k):
    """assign_centroids' split plan on this card, as a dict."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.assign_centroids import split_plan
    return split_plan(n, k, _build.sm_count(0))._asdict()


def assign_at_sms(sms, X, C):
    """ops.assign_centroids with its split plan computed for ``sms`` SMs
    (1: a single chunk)."""
    from repro_torch.kernels import _build, ops
    real = _build.sm_count
    _build.sm_count = lambda index: sms
    try:
        return ops.assign_centroids(X, C)
    finally:
        _build.sm_count = real


def tf32_round(a):
    """f32 rounded to TF32's 10 mantissa bits (to nearest, ties away): the
    planted fault of the 3xTF32 kernel, products of the hi parts alone."""
    import torch
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


PROBE_KERNELS = ("probe_partial_kernel", "probe_merge_kernel")
ASSIGN_KERNELS = ("assign_tc_kernel", "assign_merge_kernel")
PAIR_KERNELS = ("pairwise_sq_f32_kernel", "pairwise_sq_bf16_kernel")
GROUPED_KERNELS = ("ivf_scan_grouped_kernel", "ivf_scan_grouped_merge_kernel")


def check_centroid_kernels(X, k):
    """probe_centroids at nq=10,000, k, d=128, p in {1, 16, 64} and one
    served batch (64 queries, p=16), and assign_centroids at n=10,000,
    n=1,000,000 and PQ training's shape (1,010,000 x 16, k=256), against
    their plain versions; the centroids are k distinct rows of X.  Planted
    faults in the plain probe: ``||c||²`` dropped, and the split plan's last
    centroid chunk dropped (the merge losing a list); in the plain assign at
    n=10,000: ``||c||²`` dropped, and the inputs rounded to TF32 (what the
    3xTF32 kernel would give without its lo terms); and the kernel's own
    split plan against a single chunk, bit for bit."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve_index import make_queries
    n, d = X.shape
    nq = SERVE["nq"]
    g = torch.Generator(device=DEV).manual_seed(SEED + 8)
    C = X[torch.randperm(n, generator=g, device=DEV)[:k]].contiguous()
    Q = make_queries(X, nq, SEED + 9)
    csq = (C * C).sum(-1)
    out = {"probe": {}, "assign": {}}

    def probe_check(Qp, p, reps):
        plan = probe_plan(Qp.shape[0], k, p)
        got = ops.probe_centroids(Qp, C, p)
        want = ops.probe_centroids(Qp, C, p, force="ref")
        scale = (Qp * Qp).sum(-1)[:, None] + csq[want[0].long()]
        chk = sel_check(got, want, scale)
        faults = {"csq_dropped": _probe_fault(Qp, C, p, csq=False),
                  "last_chunk_dropped": _probe_fault(
                      Qp, C, p, keep=(plan["splits"] - 1) * plan["chunk"])}
        for name, bad in faults.items():
            chk[f"fault_{name}_fails"] = not sel_check(bad, want, scale)["ok"]
        chk["ok"] = chk["ok"] and all(chk[f"fault_{f}_fails"] for f in faults)
        chk["plan"] = plan
        chk["ms"] = time_ms(lambda: ops.probe_centroids(Qp, C, p), [()], 20)
        chk["plain_ms"] = time_ms(
            lambda: ops.probe_centroids(Qp, C, p, force="ref"), [()], reps)
        m = Qp.shape[0]
        chk["roof_shape"] = dict(n=m, k=k, d=d, p=p)
        chk["bound_ms"], chk["bound_by"] = bound_ms("probe_centroids",
                                                    **chk["roof_shape"])
        log(f"probe_centroids nq={m} k={k} d={d} p={p}: split plan "
            f"{json.dumps(plan)} (row tile, centroids per chunk, chunks S, "
            "pass-1 CTAs)")
        return chk

    for p in (1, 16, 64):
        out["probe"][p] = probe_check(Q, p, 4)
    # the serving path's own launch: one batch of queries at p=16
    b, pb = SERVE["batch"], 16
    Qb = Q[:b].contiguous()
    out["probe_batch"] = probe_check(Qb, pb, 20)
    out["probe_batch"]["mm_ms"] = time_ms(lambda: torch.matmul(Qb, C.T),
                                          [()], 20)
    # assign_centroids: an add batch (n=10^4), a Lloyd assignment (n=10^6)
    # and PQ training's shape (nsub=8 over the 1,010,000 live rows: 16
    # features, k=256), each against its plain version
    Xpq = torch.cat([X, Q])[:, :16].contiguous()
    gq = torch.Generator(device=DEV).manual_seed(SEED + 21)
    Cpq = Xpq[torch.randperm(Xpq.shape[0], generator=gq, device=DEV)[:256]]
    cases = {"n10k": (Q, C), "n1m": (X, C), "pq": (Xpq, Cpq.contiguous())}
    for key, (A, Ck) in cases.items():
        m, dd = A.shape
        kk = Ck.shape[0]
        plan = assign_plan(m, kk)
        ga, gd = ops.assign_centroids(A, Ck)
        wa, wd = ops.assign_centroids(A, Ck, force="ref")
        scale = ((A * A).sum(-1) + (Ck * Ck).sum(-1)[wa.long()])[:, None]
        want = (wa[:, None], wd[:, None])
        chk = sel_check((ga[:, None], gd[:, None]), want, scale)
        if key == "n10k":
            # planted faults: ||c||² dropped, and the inputs rounded to
            # TF32 (the products without their lo terms)
            ti, td = ref.assign_centroids(tf32_round(A), tf32_round(Ck))
            faults = {"csq_dropped": _probe_fault(A, Ck, 1, csq=False),
                      "tf32_inputs": (ti[:, None], td[:, None])}
            for name, bad in faults.items():
                chk[f"fault_{name}_fails"] = not sel_check(bad, want,
                                                           scale)["ok"]
            # the card's plan against one chunk (S = 1), bit for bit
            si, sd = assign_at_sms(1, A, Ck)
            chk["s1_bit_equal"] = torch.equal(si, ga) and torch.equal(sd, gd)
            chk["ok"] = chk["ok"] and chk["s1_bit_equal"] and all(
                chk[f"fault_{f}_fails"] for f in faults)
        chk["plan"] = plan
        reps = 3 if key == "n1m" else 20
        chk["ms"] = time_ms(lambda: ops.assign_centroids(A, Ck), [()], reps)
        chk["plain_ms"] = time_ms(
            lambda: ops.assign_centroids(A, Ck, force="ref"), [()],
            max(1, reps // 3))
        # the f32 products at the 3xTF32 rate (three TF32 products each,
        # the least time for them at f32 accuracy) and at the FP32 rate
        from repro_torch.launch.roofline import FP32_FLOPS, TF32X3_FLOPS
        chk["roof_shape"] = dict(n=m, k=kk, d=dd)
        chk["bound_ms"], chk["bound_by"] = bound_ms("assign_centroids",
                                                    **chk["roof_shape"])
        chk["bound_fp32_ms"], _ = bound_ms("assign_centroids",
                                           peak=FP32_FLOPS,
                                           **chk["roof_shape"])
        log(f"assign_centroids {key} n={m} k={kk} d={dd}: split plan "
            f"{json.dumps(plan)} (row tile, centroids per chunk, chunks S, "
            f"pass-1 CTAs); bounds {chk['bound_ms']:.4f} ms (3xTF32 at "
            f"{TF32X3_FLOPS / 1e12:.0f} TFLOP/s, {chk['bound_by']}), "
            f"{chk['bound_fp32_ms']:.4f} ms (FP32)")
        out["assign"][key] = chk
    # device time per call (both passes), traced after the event timings
    for p, chk in out["probe"].items():
        chk["device_us"] = kernel_device_us(
            lambda: ops.probe_centroids(Q, C, p), [()], PROBE_KERNELS,
            launches=1 + (chk["plan"]["splits"] > 1),
            bound_ms=chk["bound_ms"])
    pbc = out["probe_batch"]
    pbc["device_us"] = kernel_device_us(
        lambda: ops.probe_centroids(Qb, C, pb), [()], PROBE_KERNELS,
        launches=1 + (pbc["plan"]["splits"] > 1), bound_ms=pbc["bound_ms"])
    for key, (A, Ck) in cases.items():
        ac = out["assign"][key]
        ac["device_us"] = kernel_device_us(
            lambda: ops.assign_centroids(A, Ck), [()], ASSIGN_KERNELS,
            reps=3 if key == "n1m" else 20,
            launches=1 + (ac["plan"]["splits"] > 1),
            bound_ms=ac["bound_ms"])
    # yardstick: the (rows, k) product alone, no selection; at n=10^6 the
    # (n, k) output is 65 GB, so one 131,072-row chunk is timed and scaled
    mm = time_ms(lambda: torch.matmul(Q, C.T), [()], 10)
    rows = 131_072
    mm_1m = time_ms(lambda: torch.matmul(X[:rows], C.T), [()], 3) * n / rows
    out["mm_ms"], out["mm_1m_ms"] = mm, mm_1m
    out["assign"]["pq"]["mm_ms"] = time_ms(
        lambda: torch.matmul(Xpq, cases["pq"][1].T), [()], 10)
    del Xpq
    for p, chk in out["probe"].items():
        log(f"probe_centroids nq={nq} k={k} d={d} p={p}: {json.dumps(chk)}")
    log(f"probe_centroids nq={b} (one served batch) k={k} d={d} p={pb}: "
        f"{json.dumps(out['probe_batch'])}")
    for key, chk in out["assign"].items():
        log(f"assign_centroids {key}: {json.dumps(chk)}")
    log(f"centroid yardstick: torch.matmul(X, C.T) alone (no selection): "
        f"{mm:.4f} ms at n={nq}; {mm_1m:.3f} ms at n={n} (one {rows}-row "
        f"chunk timed, scaled by n/{rows})")
    out["ok"] = out["probe_batch"]["ok"] and all(
        c["ok"] for c in out["probe"].values()) and all(
        c["ok"] for c in out["assign"].values())
    return out


def _vsq_dropped(Q, vecs, pids, tm, block_rows, topk):
    """The plain scan with a planted fault: ``||v||²`` dropped."""
    import torch
    from repro_torch.kernels import ref
    c, T = tm.shape
    pos = (tm.long()[:, :, None] * block_rows
           + torch.arange(block_rows, device=DEV)).reshape(c, -1)
    cids = pids[pos]
    part = torch.full(cids.shape, float("inf"), device=DEV)
    qi, li = torch.nonzero(cids >= 0, as_tuple=True)
    part[qi, li] = -2.0 * (vecs[pos[qi, li]] * Q[qi]).sum(-1)
    d, ids = ref.stable_topk(part, cids, topk)
    return ref.finalize_d2(ids, d, Q)


def scan_plan(nq, T, topk):
    """The per-query scan's split plan on this card, as a dict."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_scan import split_plan
    return split_plan(nq, T, topk, _build.sm_count(0))._asdict()


def first_chunk_dropped(tm, index, splits):
    """A planted fault for the per-query scans (``ivf_scan``,
    ``ivf_scan_adc``): the tile map with each query's first live-slot chunk
    of the split plan pointed at the null tile (a merge that loses that
    chunk's list; the first holds the nearest cell's tiles)."""
    import torch
    from repro_torch.kernels import ivf_scan as kivf
    live = kivf.live_slots(tm, index.ids, index.block_rows)
    bounds = kivf.slot_chunks(live, splits)
    rank = live.long().cumsum(1) - 1
    drop = live & (rank < bounds[:, 1:2])
    return torch.where(drop, index.null_tile, tm).to(torch.int32)


def _scan_first_chunk_dropped(Q, index, tm, topk, splits):
    """The plain scan on ``first_chunk_dropped``'s map."""
    from repro_torch.kernels import ref
    return ref.ivf_scan(Q, index.vecs, index.ids,
                        first_chunk_dropped(tm, index, splits),
                        block_rows=index.block_rows, topk=topk)


SCAN_KERNELS = ("ivf_scan_kernel", "ivf_scan_merge_kernel")


def check_scan_kernel(index, Q, X_all):
    """ivf_scan on the SIFT1M index against its plain version, on one tile
    map per case (the plain probe's cells): nq=10,000 at nprobe 16 and 64
    (topk=10) and nprobe 1 (topk=100, lists exhausted), and one served
    batch of 64 queries at nprobe 16, topk=10 (a split plan), each with its
    split plan printed."""
    import torch
    from repro_torch import index as ivf
    from repro_torch.kernels import ops, ref
    bl = index.block_rows
    xsq = (X_all * X_all).sum(-1)
    live_per_tile = (index.ids.view(-1, bl) >= 0).sum(1)
    n_tiles = index.n_rows // bl
    out, traced = {}, []
    for key, nq, nprobe, topk in ((16, Q.shape[0], 16, 10),
                                  (64, Q.shape[0], 64, 10),
                                  (1, Q.shape[0], 1, 100),
                                  ("batch", SERVE["batch"], 16, 10)):
        q = Q[:nq].contiguous()
        d = q.shape[1]
        cids, _ = ops.probe_centroids(q, index.centroids, nprobe,
                                      force="ref")
        tm = ivf.build_tile_map(cids, index.starts, index.caps,
                                max_tiles=index.max_list_tiles,
                                block_rows=bl, null_tile=index.null_tile)
        plan = scan_plan(nq, tm.shape[1], topk)
        args = (q, index.vecs, index.ids, tm)
        kw = dict(block_rows=bl, topk=topk)
        got = ops.ivf_scan(*args, **kw)
        want = ops.ivf_scan(*args, force="ref", **kw)
        scale = (q * q).sum(-1)[:, None] + xsq[want[0].long().clamp(min=0)]
        chk = sel_check(got, want, scale)
        chk["plan"] = plan
        chk["exhausted_slots"] = int((want[0] < 0).sum())
        sub = slice(0, min(FAULT_Q, nq))
        wsub = (want[0][sub], want[1][sub])
        faults = {
            "vsq_dropped": _vsq_dropped(q[sub], index.vecs, index.ids,
                                        tm[sub], bl, topk),
            "tile_map_off_by_one": ref.ivf_scan(
                q[sub], index.vecs, index.ids,
                torch.clamp(tm[sub] + 1, max=n_tiles - 1), **kw)}
        if plan["splits"] > 1:
            faults["first_chunk_dropped"] = _scan_first_chunk_dropped(
                q[sub], index, tm[sub], topk, plan["splits"])
        for name, bad in faults.items():
            chk[f"fault_{name}_fails"] = not sel_check(bad, wsub,
                                                       scale[sub])["ok"]
        chk["ok"] = chk["ok"] and all(chk[f"fault_{f}_fails"] for f in faults)
        chk["ms"] = time_ms(lambda: ops.ivf_scan(*args, **kw), [()], 10)
        chk["plain_ms"] = time_ms(
            lambda: ops.ivf_scan(*args, force="ref", **kw), [()], 2)
        traced.append((chk, args, kw))
        R = int(live_per_tile[tm.long()].sum())        # live rows scanned
        chk["rows_per_query"] = R / nq
        chk["tile_slots"] = tm.shape[1]
        chk["roof_shape"] = dict(nq=nq, rows=R, d=d, topk=topk)
        chk["bound_ms"], chk["bound_by"] = bound_ms("ivf_scan",
                                                    **chk["roof_shape"])
        if nprobe == 16:
            # yardstick: torch.bmm over rows gathered beforehand (dots only,
            # no selection) for up to FAULT_Q queries, padded to the longest
            # query's live rows, scaled to nq
            m = sub.stop
            pos = (tm[sub].long()[:, :, None] * bl
                   + torch.arange(bl, device=DEV)).reshape(m, -1)
            live = index.ids[pos] >= 0
            width = int(live.sum(1).max())
            order = torch.argsort((~live).to(torch.int8), dim=1,
                                  stable=True)[:, :width]
            G = index.vecs[torch.gather(pos, 1, order)]
            chk["bmm_ms"] = time_ms(torch.bmm, [(G, q[sub, :, None])],
                                    10) * nq / m
            del G
        out[key] = chk
        log(f"ivf_scan nq={nq} nprobe={nprobe} topk={topk} T={tm.shape[1]} "
            f"(max_list_tiles {index.max_list_tiles}): split plan "
            f"{json.dumps(plan)} (chunks S of each query's live slots, "
            f"pass-1 CTAs); {json.dumps(chk)}")
    # device time per call (both launches when the plan splits), traced
    # after all the event timings above
    for chk, args, kw in traced:
        launches = 1 + (chk["plan"]["splits"] > 1)
        chk["device_us"] = kernel_device_us(
            lambda: ops.ivf_scan(*args, **kw), [()], SCAN_KERNELS, 5,
            launches=launches, bound_ms=chk["bound_ms"])
        log(f"ivf_scan nq={args[0].shape[0]} topk={kw['topk']} "
            f"T={args[3].shape[1]} kernel device time per call: "
            f"{chk['device_us']} us ({launches} launch(es) a call; "
            "torch.profiler)")
    log("ivf_scan yardstick: torch.bmm over pre-gathered live rows (dots "
        f"only), nprobe=16: {out[16]['bmm_ms']:.4f} ms for {Q.shape[0]} "
        f"queries (timed on {FAULT_Q}, scaled), "
        f"{out['batch']['bmm_ms']:.4f} ms for the served batch")
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def brute_topk(Q, X, topk, chunk=64):
    """Exact top-k of X for each query by ``sum((q - x)²)`` (independent of
    the partial-distance form the index uses), ties to the lower row."""
    import torch
    from repro_torch.kernels import ref
    cols = torch.arange(X.shape[0], dtype=torch.int32, device=DEV)
    outs = []
    for a in range(0, Q.shape[0], chunk):
        q = Q[a:a + chunk]
        d2 = ((q[:, None, :] - X[None]) ** 2).sum(-1)
        d, i = ref.stable_topk(d2, cols.expand(q.shape[0], -1), topk)
        outs.append((i, d))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


LAYOUT = ("starts", "caps", "ids", "vecs")


def host_add_layout(base, X_new, assign):
    """The layout the reference's ``add`` loop (``repro/index/ivf.py``)
    leaves for rows X_new assigned to ``assign``, computed on the host with
    numpy, independently of the port's device code: each row in input
    order takes the first hole of its list; if any row finds none, the live
    rows (packed order) plus the overflowed ones are packed anew."""
    import numpy as np
    br = base.block_rows
    starts, caps = base.starts.cpu().numpy(), base.caps.cpu().numpy()
    ids, vecs = base.ids.cpu().numpy().copy(), base.vecs.cpu().numpy().copy()
    a, xn = assign.cpu().numpy().astype(np.int64), X_new.cpu().numpy()
    new_ids = ids.max() + 1 + np.arange(len(a), dtype=np.int32)
    over = []
    for i, c in enumerate(a):
        holes = np.nonzero(ids[starts[c]:starts[c] + caps[c]] < 0)[0]
        if len(holes):
            ids[starts[c] + holes[0]], vecs[starts[c] + holes[0]] = (
                new_ids[i], xn[i])
        else:
            over.append(i)
    if not over:
        return dict(starts=starts, caps=caps, ids=ids, vecs=vecs)
    live = np.nonzero(ids[:len(ids) - br] >= 0)[0]
    lists = np.searchsorted(starts + caps, live, side="right")
    a_all = np.concatenate([lists, a[over]])
    x_all = np.concatenate([vecs[live], xn[over]])
    id_all = np.concatenate([ids[live], new_ids[over]])
    counts = np.bincount(a_all, minlength=len(starts))
    caps = (counts + br - 1) // br * br
    starts = np.cumsum(caps) - caps
    order = np.argsort(a_all, kind="stable")
    rows = (starts[a_all[order]] + np.arange(len(order))
            - (np.cumsum(counts) - counts)[a_all[order]])
    ids = np.full(caps.sum() + br, -1, np.int32)
    vecs = np.zeros((caps.sum() + br, xn.shape[1]), np.float32)
    ids[rows], vecs[rows] = id_all[order], x_all[order]
    return dict(starts=starts.astype(np.int32), caps=caps.astype(np.int32),
                ids=ids, vecs=vecs)


def ivf_parity_small(X, r):
    """The IVF path through the kernels vs the plain versions at the
    SIFT_SMALL shape, on phase 3's clustering."""
    import numpy as np
    import torch
    from repro_torch import index as ivf
    from repro_torch.data import sift_like
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_index import make_queries
    base = ivf.build_ivf(X, r, block_rows=128, device=DEV)
    X_new = sift_like(4096, X.shape[1], COMPONENTS,
                      generator=torch.Generator(device=DEV).manual_seed(
                          SEED + 12))
    ak, _ = ops.assign_centroids(X_new, base.centroids)
    ar, _ = ops.assign_centroids(X_new, base.centroids, force="ref")
    moved = int((ak != ar).sum())
    built = {f: ivf.add(base, X_new, force=f) for f in (None, "ref")}
    a, b = built[None], built["ref"]
    same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in LAYOUT)
    # the layout through the kernels against the reference's loop given the
    # kernel's own assignment: compared whatever near-ties decide
    host = host_add_layout(base, X_new, ak)
    host_same = all(np.array_equal(getattr(a, f).cpu().numpy(), host[f])
                    for f in LAYOUT)
    # a near-tie may send a row to another list; then the two device
    # layouts differ, and only in the rows of those lists
    layout_ok = host_same and (same or moved > 0)
    if not same:
        rows_differ = (int((a.ids != b.ids).sum())
                       if a.ids.shape == b.ids.shape else "shapes differ")
        log(f"add layouts through the kernels and the plain versions differ: "
            f"{moved} rows assigned differently (lists "
            f"{ak[ak != ar].tolist()[:8]} vs {ar[ak != ar].tolist()[:8]}), "
            f"ids differ in {rows_differ} rows")
    X_all = torch.cat([X, X_new])
    xsq = (X_all * X_all).sum(-1)
    Q = make_queries(X, 1000, SEED + 13)
    qsq = (Q * Q).sum(-1)[:, None]
    want = brute_topk(Q, X_all, 10)
    ex = sel_check(ivf.exhaustive_search(a, Q, topk=10), want,
                   qsq + xsq[want[0].long()])
    res = {"layout_identical": same, "layout_equals_host_loop": host_same,
           "add_overflowed": a.n_rows != base.n_rows,
           "add_rows_assigned_differently": moved, "exhaustive_vs_brute": ex}
    ok = layout_ok and ex["ok"]
    for nprobe in (1, 8, 64):
        got = ivf.search(a, Q, topk=10, nprobe=nprobe)
        w = ivf.search(a, Q, topk=10, nprobe=nprobe, force="ref")
        chk = sel_check(got, w, qsq + xsq[w[0].long().clamp(min=0)])
        res[f"search_nprobe{nprobe}"] = chk
        ok = ok and chk["ok"]
    log(f"SIFT_SMALL IVF parity (n={X.shape[0]} + 4096 added, k={r.k}): "
        f"{json.dumps(res)} {'OK' if ok else 'FAIL'}")
    return ivf_codec_parity_small(a, X_all, Q) and ok


# engine epochs a subspace of the PQ codecs' training, phase 3's (SIFT_SMALL)
# and phase 5's (all 1,010,000 live rows): cut 8 -> 1; at 8 (64 epochs in
# all) the host-bound training took 52-148 s in phase 5 and ~20 s in phase
# 3, and the checks hold the kernels against the plain versions on the
# same codec
PQ_ITERS = 1


def ivf_codec_parity_small(index, X_all, Q, nprobe=8, topk=10):
    """The compressed-list and grouped searches through the kernels vs the
    plain versions at the SIFT_SMALL shape: codec int8 and PQ (nsub=8),
    rerank at its default and at 0, the reranked d2 held against the exact
    distance to the returned rows; qgroup=8 vs the plain versions and vs
    the per-query search."""
    import torch
    from repro_torch import index as ivf
    xsq = (X_all * X_all).sum(-1)
    qsq = (Q * Q).sum(-1)[:, None]
    res, ok = {}, True
    for kind in ("int8", "pq"):
        t0 = time.perf_counter()
        ix = ivf.quantize_index(index, kind, nsub=8, iters=PQ_ITERS,
                                generator=torch.Generator().manual_seed(
                                    SEED + 14))
        torch.cuda.synchronize()
        res[f"{kind}_train_s"] = time.perf_counter() - t0
        for rerank in (None, 0):
            kw = dict(topk=topk, nprobe=nprobe, codec=kind, rerank=rerank)
            got = ivf.search(ix, Q, **kw)
            want = ivf.search(ix, Q, force="ref", **kw)
            scale = qsq + xsq[want[0].long().clamp(min=0)]
            if rerank == 0:       # distances to the reconstructions
                scale = scale + want[1].abs().nan_to_num(posinf=0.0)
            chk = sel_check(got, want, scale)
            if rerank is None:    # reranked d2 is the exact distance
                gi, gd = got
                rows = X_all[gi.long().clamp(min=0)]
                exact = ((Q[:, None, :] - rows) ** 2).sum(-1)
                chk["d2_vs_exact"] = sel_check(
                    (gi, gd), (gi, torch.where(gi < 0, float("inf"), exact)),
                    qsq + xsq[gi.long().clamp(min=0)])
                chk["ok"] = chk["ok"] and chk["d2_vs_exact"]["ok"]
            res[f"{kind}_rerank{rerank}"] = chk
            ok = ok and chk["ok"]
    got = ivf.search(index, Q, topk=topk, nprobe=nprobe, qgroup=8)
    want = ivf.search(index, Q, topk=topk, nprobe=nprobe, qgroup=8,
                      force="ref")
    scale = qsq + xsq[want[0].long().clamp(min=0)]
    chk = sel_check(got, want, scale)
    per = sel_check(got, ivf.search(index, Q, topk=topk, nprobe=nprobe),
                    scale)
    chk["vs_per_query"] = per
    chk["ok"] = chk["ok"] and per["ok"]
    res["qgroup8"] = chk
    ok = ok and chk["ok"]
    log(f"SIFT_SMALL codec / grouped parity (nprobe={nprobe}, topk={topk}, "
        f"{Q.shape[0]} queries): {json.dumps(res)} {'OK' if ok else 'FAIL'}")
    return ok


def serve_path(X, r):
    """The serving path at SIFT1M's shape, on phase 4's data and clustering:
    build_ivf, add 10,000 fresh rows, then the nprobe sweep — the counted
    run of probe_centroids, assign_centroids and ivf_scan."""
    import torch
    from repro_torch import index as ivf
    from repro_torch.data import sift_like
    from repro_torch.kernels import _build
    from repro_torch.launch import serve_index as si
    s, c = SERVE, SIFT1M
    X_new = sift_like(s["add"], c["d"], COMPONENTS,
                      generator=torch.Generator(device=DEV).manual_seed(
                          SEED + 11))
    X_all = torch.cat([X, X_new])          # row i holds id i after the add
    Q = si.make_queries(X, s["nq"], SEED + 9)
    gt = si.ground_truth(Q, X_all, s["topk"])
    log(f"serving path: build_ivf (block_rows={s['block_rows']}) over "
        f"n={c['n']}, k={r.k}; add {s['add']} rows; sweep nq={s['nq']} "
        f"topk={s['topk']} probes={list(s['probes'])} batch={s['batch']} "
        f"rounds={s['rounds']}; cuts: rounds 3 -> {s['rounds']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    index = ivf.build_ivf(X, r, block_rows=s["block_rows"], device=DEV)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    live0, cap0, rows0 = index.size, index.capacity_rows, index.n_rows
    t0 = time.perf_counter()
    index = ivf.add(index, X_new)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    rows = si.sweep(index, Q, gt, topk=s["topk"], probes=s["probes"],
                    batch=s["batch"], rounds=s["rounds"])
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    log(f"pack {pack_s:.3f} s: n_rows {rows0}, "
        f"hole share {1 - live0 / cap0:.4f}, max_list_tiles "
        f"{index.max_list_tiles}; add {add_s:.3f} s -> n_rows "
        f"{index.n_rows}, live {index.size}, hole share "
        f"{1 - index.size / index.capacity_rows:.4f}")
    log(f"serving sweep rows: {json.dumps(rows)}")
    log(f"peak device memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated, build + add + sweep)")
    log(f"kernel launches on the serving path: {json.dumps(launches)}")
    # outside the counted run: the same queries through the plain versions
    rec_ref = {}
    for p in s["probes"]:
        ids, _ = ivf.search(index, Q, topk=s["topk"], nprobe=p, force="ref")
        rec_ref[p] = si.recall(ids, gt)
    gaps = {p: abs(row["recall"] - rec_ref[p])
            for p, row in zip(s["probes"], rows)}
    log(f"recall@{s['topk']} through the plain versions: "
        f"{json.dumps(rec_ref)}; |kernels - plain| {json.dumps(gaps)} "
        f"(limit {RECALL_GAP})")
    recs = [row["recall"] for row in rows]
    checks = {
        "launches": all(launches[k] > 0 for k in
                        ("probe_centroids", "assign_centroids", "ivf_scan")),
        "recall_monotone": all(b >= a for a, b in zip(recs, recs[1:])),
        "recall_vs_plain": all(g <= RECALL_GAP for g in gaps.values()),
        "host_syncs_in_search": all(row["host_syncs"] == 0 for row in rows),
        "live_rows": index.size == c["n"] + s["add"],
    }
    log(f"serving-path checks: {json.dumps(checks)}")
    return all(checks.values()), launches, index, Q, X_all, gt


# the compressed-list and grouped serving paths on the same index and queries
CODEC_PROBES = (1, 4, 16, 64)
CODEC_PATHS = (("int8", "int8", None), ("pq", "pq", None),
               ("qgroup8", "f32", 8))
PQ32_SAMPLE = 65_536    # live rows that train the nsub=32 check's codebooks


def serve_codec_paths(index, Q, gt):
    """Three more sweeps on phase 5's index and queries: codec int8, codec
    PQ (nsub=8, the reference's default) and qgroup=8, each at nprobe 1, 4,
    16, 64, rerank at its default.  Each is a counted run of its own: the
    counts are zeroed just before (the codec's training included) and read
    just after.  Gates: recall within RECALL_GAP of the plain versions at
    every nprobe, 0 host syncs in ``search``, the path's kernels launched
    (and ``ivf_scan`` not), and, but for PQ, recall not falling with
    nprobe."""
    import torch
    from repro_torch import index as ivf
    from repro_torch.kernels import _build
    from repro_torch.launch import serve_index as si
    s = SERVE
    out, ok = {}, True
    for label, codec, qgroup in CODEC_PATHS:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        ix = index if codec == "f32" else ivf.quantize_index(
            index, codec, nsub=8, iters=PQ_ITERS,
            generator=torch.Generator().manual_seed(SEED + 15))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        log(f"serving sweep {label}: codec {codec}, qgroup {qgroup}, "
            f"nq={s['nq']} topk={s['topk']} probes={list(CODEC_PROBES)} "
            f"batch={s['batch']} rounds={s['rounds']}; codec training "
            f"{train_s:.3f} s on {ix.size} live rows; cuts: rounds 3 -> "
            f"{s['rounds']}"
            + (f", PQ training 8 -> {PQ_ITERS} epochs a subspace"
               if codec == "pq" else ""))
        rows = si.sweep(ix, Q, gt, topk=s["topk"], probes=CODEC_PROBES,
                        batch=s["batch"], rounds=s["rounds"], qgroup=qgroup,
                        codec=codec)
        launches = dict(_build.launch_counts)
        rec_ref = {}
        for p in CODEC_PROBES:
            ids, _ = ivf.search(ix, Q, topk=s["topk"], nprobe=p,
                                qgroup=qgroup, codec=codec, force="ref")
            rec_ref[p] = si.recall(ids, gt)
        gaps = {p: abs(row["recall"] - rec_ref[p])
                for p, row in zip(CODEC_PROBES, rows)}
        recs = [row["recall"] for row in rows]
        kern = "ivf_scan_grouped" if qgroup else "ivf_scan_adc"
        checks = {
            "launches": launches["probe_centroids"] > 0 and launches[kern] > 0
            and launches["ivf_scan"] == 0
            and (codec != "pq" or launches["assign_centroids"] > 0),
            "recall_monotone": all(b >= a for a, b in zip(recs, recs[1:])),
            "recall_vs_plain": all(g <= RECALL_GAP for g in gaps.values()),
            "host_syncs_in_search": all(r["host_syncs"] == 0 for r in rows),
        }
        # PQ's recall is reported, not held to rise with nprobe: a
        # non-residual 8-subspace PQ spends its 256 codes per subspace on
        # this data's mixture means and ranks the rows of one component
        # almost at random, so at a fixed rerank depth more candidates only
        # crowd the shortlist (the reference's own BENCH_anns_ivf_pq.json
        # is flat across nprobe at the default rerank)
        gated = {c: v for c, v in checks.items()
                 if not (codec == "pq" and c == "recall_monotone")}
        log(f"serving sweep {label} rows: {json.dumps(rows)}")
        log(f"serving sweep {label}: kernel launches {json.dumps(launches)}; "
            f"recall@{s['topk']} through the plain versions "
            f"{json.dumps(rec_ref)}; |kernels - plain| {json.dumps(gaps)} "
            f"(limit {RECALL_GAP}); checks {json.dumps(checks)}, gated "
            f"{sorted(gated)}")
        out[label] = dict(index=ix, rows=rows, launches=launches,
                          train_s=train_s, recall_plain=rec_ref)
        if codec == "pq":     # what the shortlist depth buys (not counted)
            sub = slice(0, 2000)
            depth = {r: si.recall(ivf.search(
                ix, Q[sub], topk=s["topk"], nprobe=16, codec="pq",
                rerank=r)[0], gt[sub]) for r in (0, 40, 160, 640)}
            log(f"PQ recall@{s['topk']} at nprobe=16 by rerank depth, first "
                f"2000 queries: {json.dumps(depth)}")
        ok = ok and all(gated.values())
    return ok, out


def adc_scale(lut, qc, vnorm, codes, pos):
    """vnorm + Σ_m |lut[m, code[m]]| + |qconst| of each selected row: the
    size of the terms an ADC partial sums (its limit is DIST_RTOL times
    it)."""
    import torch
    p = pos.long().clamp(min=0)
    c = codes[p].long()                                   # (q, k, M)
    if lut.shape[2] == 1:
        terms = lut[:, None, :, 0] * c.float()
    else:
        terms = torch.gather(lut[:, None].expand(-1, c.shape[1], -1, -1), 3,
                             c[..., None])[..., 0]
    return vnorm[p].abs() + terms.abs().sum(-1) + qc.abs()[:, None]


ADC_KERNELS = ("ivf_scan_adc_kernel", "ivf_scan_adc_merge_kernel")


def check_adc_kernel(label, ix, Q, tm, live_per_tile, topk):
    """ivf_scan_adc vs its plain version on one tile map, with its split
    plan printed (the per-query scan's: chunks S of each query's live
    slots, CTAs) and planted faults in the plain version: vnorm dropped,
    every code read one entry off, the tile map off by one, and for a split
    plan each query's first live-slot chunk dropped."""
    import torch
    from repro_torch.index import quantize
    from repro_torch.kernels import ops, ref
    bl = ix.block_rows
    nq = Q.shape[0]
    n_tiles = ix.n_rows // bl
    lut, qc = quantize.build_lut(ix.codec, Q)
    args = (lut, qc, ix.vnorm, ix.codes, ix.ids, tm)
    kw = dict(block_rows=bl, topk=topk)
    plan = scan_plan(nq, tm.shape[1], topk)
    gi, gp, gd = ops.ivf_scan_adc(*args, **kw)
    wi, wp, wd = ops.ivf_scan_adc(*args, force="ref", **kw)
    scale = adc_scale(lut, qc, ix.vnorm, ix.codes, wp)
    chk = sel_check((gp, gd), (wp, wd), scale)
    by_id = sel_check((gi, gd), (wi, wd), scale)
    chk["ids_ok"] = by_id["ok"]
    sub = slice(0, FAULT_Q)
    faults = {
        "vnorm_dropped": (lut[sub], qc[sub], torch.zeros_like(ix.vnorm),
                          ix.codes, ix.ids, tm[sub]),
        "lut_one_code_off": (lut[sub], qc[sub], ix.vnorm, ix.codes + 1,
                             ix.ids, tm[sub]),
        "tile_map_off_by_one": (lut[sub], qc[sub], ix.vnorm, ix.codes, ix.ids,
                                torch.clamp(tm[sub] + 1, max=n_tiles - 1))}
    if plan["splits"] > 1:
        faults["first_chunk_dropped"] = (
            lut[sub], qc[sub], ix.vnorm, ix.codes, ix.ids,
            first_chunk_dropped(tm[sub], ix, plan["splits"]))
    for name, fargs in faults.items():
        _, bp, bd = ref.ivf_scan_adc(*fargs, **kw)
        chk[f"fault_{name}_fails"] = not sel_check(
            (bp, bd), (wp[sub], wd[sub]), scale[sub])["ok"]
    chk["ok"] = chk["ok"] and by_id["ok"] and all(
        chk[f"fault_{f}_fails"] for f in faults)
    chk["ms"] = time_ms(lambda: ops.ivf_scan_adc(*args, **kw), [()], 10)
    chk["plain_ms"] = time_ms(
        lambda: ops.ivf_scan_adc(*args, force="ref", **kw), [()], 2)
    _, M, W = lut.shape
    R = int(live_per_tile[tm.long()].sum())            # live rows scanned
    chk["rows_per_query"] = R / nq
    chk["lut_bytes"] = M * W * 4
    chk["roof_shape"] = dict(nq=nq, rows=R, M=M, W=W, topk=topk)
    chk["bound_ms"], chk["bound_by"] = bound_ms("ivf_scan_adc",
                                                **chk["roof_shape"])
    chk["plan"] = plan
    log(f"ivf_scan_adc[{label}] nq={nq} M={M} W={W} topk={topk} "
        f"T={tm.shape[1]}: split plan {json.dumps(plan)} (chunks S of each "
        f"query's live slots, pass-1 CTAs); {json.dumps(chk)}")
    return chk, args, kw


def _grouped_tile_maps(union, qmask, G, null_tile):
    """Each grouped row's own tile map: its group's union slots where its
    mask is set, else the null tile (the same candidates in the same
    order as the grouped scan gives it)."""
    import torch
    return torch.where(qmask > 0, union.repeat_interleave(G, 0),
                       null_tile).to(torch.int32)


def grouped_plan(qmask, G, topk):
    """The grouped scan's split plan on this card for these groups, as a
    dict, with the live chunks the kernel cuts (``slot_chunks``)."""
    from repro_torch.kernels import _build, autotune
    from repro_torch.kernels.ivf_scan_grouped import slot_chunks, split_plan
    ngroups, U = qmask.shape[0] // G, qmask.shape[1]
    knob = autotune.resolve("ivf_scan_grouped", "cuda",
                            {"q": qmask.shape[0], "U": U, "topk": topk}, None)
    plan = split_plan(ngroups, U, topk, _build.sm_count(0), knob)._asdict()
    bounds = slot_chunks(qmask, G, plan["splits"])
    live = (bounds[:, 1:] > bounds[:, :-1]).sum(1).float()
    plan["live_span_mean"] = float(bounds[:, -1].float().mean())
    plan["live_chunks_per_group_mean"] = float(live.mean())
    return plan, bounds


def _last_chunk_dropped(qmask, bounds, G):
    """qmask with each group's last live slot chunk cleared (a merge that
    loses that chunk's lists)."""
    import torch
    live = bounds[:, 1:] > bounds[:, :-1]
    start = torch.where(live, bounds[:, :-1], -1).max(1).values
    start = torch.where(start < 0, qmask.shape[1], start)
    slots = torch.arange(qmask.shape[1], device=qmask.device)
    drop = slots[None, :] >= start.repeat_interleave(G)[:, None]
    return torch.where(drop, 0, qmask)


def check_grouped_kernel(index, Q, X_all, tm, live_per_tile, G=8, topk=10):
    """ivf_scan_grouped vs its plain version at G queries per group, with
    planted faults in the plain version: each query given the next group
    member's qmask, the union tiles off by one, ||v||² dropped, and each
    group's last live slot chunk of the split plan dropped."""
    import torch
    from repro_torch import index as ivf
    from repro_torch.kernels import ops, ref
    bl = index.block_rows
    nq, d = Q.shape
    n_tiles = index.n_rows // bl
    xsq = (X_all * X_all).sum(-1)
    order, union, qmask = ivf.build_group_map(tm, group=G,
                                              null_tile=index.null_tile)
    Qg = Q[order.clamp(max=nq - 1).long()].contiguous()
    args = (Qg, index.vecs, index.ids, union, qmask)
    kw = dict(block_rows=bl, topk=topk)
    plan, bounds = grouped_plan(qmask, G, topk)
    got = ops.ivf_scan_grouped(*args, **kw)
    want = ops.ivf_scan_grouped(*args, force="ref", **kw)
    scale = (Qg * Qg).sum(-1)[:, None] + xsq[want[0].long().clamp(min=0)]
    chk = sel_check(got, want, scale)
    gs = min(FAULT_Q // G, union.shape[0])
    rs, us = slice(0, gs * G), slice(0, gs)
    wsub = (want[0][rs], want[1][rs])
    faults = {
        "qmask_of_next_member": ref.ivf_scan_grouped(
            Qg[rs], index.vecs, index.ids, union[us],
            qmask[rs].view(gs, G, -1).roll(1, dims=1).reshape(gs * G, -1),
            **kw),
        "union_off_by_one": ref.ivf_scan_grouped(
            Qg[rs], index.vecs, index.ids,
            torch.clamp(union[us] + 1, max=n_tiles - 1), qmask[rs], **kw),
        "vsq_dropped": _vsq_dropped(
            Qg[rs], index.vecs, index.ids,
            _grouped_tile_maps(union[us], qmask[rs], G, index.null_tile),
            bl, topk),
        "last_chunk_dropped": ref.ivf_scan_grouped(
            Qg[rs], index.vecs, index.ids, union[us],
            _last_chunk_dropped(qmask[rs], bounds[us], G), **kw)}
    for name, bad in faults.items():
        chk[f"fault_{name}_fails"] = not sel_check(bad, wsub,
                                                   scale[rs])["ok"]
    chk["ok"] = chk["ok"] and all(chk[f"fault_{f}_fails"] for f in faults)
    chk["plan"] = plan
    chk["ms"] = time_ms(lambda: ops.ivf_scan_grouped(*args, **kw), [()], 10)
    chk["plain_ms"] = time_ms(
        lambda: ops.ivf_scan_grouped(*args, force="ref", **kw), [()], 2)
    union_rows = int(live_per_tile[union.long()].sum())
    pairs = int(live_per_tile[tm.long()].sum())
    chk["union_rows_per_group"] = union_rows / union.shape[0]
    chk["rows_per_query"] = pairs / nq
    chk["union_slots"] = union.shape[1]
    chk["roof_shape"] = dict(nq=nq, union_rows=union_rows, pairs=pairs, d=d,
                             topk=topk)
    chk["bound_ms"], chk["bound_by"] = bound_ms("ivf_scan_grouped",
                                                **chk["roof_shape"])
    # yardstick: torch.bmm of each group's queries against its union's live
    # rows gathered beforehand (dots only, no mask, no selection), for
    # up to FAULT_Q // G groups, padded to the widest, scaled to all groups
    pos = (union[us].long()[:, :, None] * bl
           + torch.arange(bl, device=DEV)).reshape(gs, -1)
    live = index.ids[pos] >= 0
    width = int(live.sum(1).max())
    first = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
    rows = index.vecs[torch.gather(pos, 1, first[:, :width])]
    chk["bmm_ms"] = time_ms(torch.bmm, [(Qg[rs].view(gs, G, d),
                                         rows.transpose(1, 2))],
                            10) * union.shape[0] / gs
    del rows
    log(f"ivf_scan_grouped nq={nq} G={G} topk={topk} U={union.shape[1]}: "
        f"split plan {json.dumps(plan)} (chunks S, slots per chunk of U, "
        f"pass-1 CTAs; the kernel cuts each group's live span); "
        f"{json.dumps(chk)}")
    return chk, args, kw


def check_codec_kernels(index, runs, Q, X_all):
    """ivf_scan_adc at nq=10,000, nprobe=16, topk=40 (the default rerank
    depth) for int8 (M=128, W=1), PQ nsub=8 (the served codec) and PQ
    nsub=32 (a 32 KB table; its codebooks trained on PQ32_SAMPLE live
    rows, 2 epochs), and ivf_scan_grouped at G=8, nprobe=16, topk=10,
    against their plain versions on phase 5's index."""
    import torch
    from repro_torch import index as ivf
    from repro_torch.kernels import ops
    bl = index.block_rows
    live_per_tile = (index.ids.view(-1, bl) >= 0).sum(1)
    cids, _ = ops.probe_centroids(Q, index.centroids, 16, force="ref")
    tm = ivf.build_tile_map(cids, index.starts, index.caps,
                            max_tiles=index.max_list_tiles, block_rows=bl,
                            null_tile=index.null_tile)
    g = torch.Generator(device=DEV).manual_seed(SEED + 16)
    live = torch.nonzero(index.ids >= 0, as_tuple=True)[0]
    sample = live[torch.randperm(live.numel(), generator=g,
                                 device=DEV)[:PQ32_SAMPLE]]
    t0 = time.perf_counter()
    pq32 = ivf.train_pq(index.vecs[sample], 32, iters=2,
                        generator=torch.Generator().manual_seed(SEED + 17))
    ix32 = ivf.attach_codec(index, pq32)
    torch.cuda.synchronize()
    log(f"PQ nsub=32 codec for the kernel check: trained on {PQ32_SAMPLE} "
        f"sampled live rows, 2 epochs, {time.perf_counter() - t0:.2f} s")
    out, traced = {"adc": {}}, []
    b = SERVE["batch"]
    for label, ix, rows in (
            ("int8", runs["int8"]["index"], slice(None)),
            ("pq8", runs["pq"]["index"], slice(None)), ("pq32", ix32,
                                                        slice(None)),
            # one served batch of 64 queries: a split plan
            ("int8_batch", runs["int8"]["index"], slice(0, b)),
            ("pq8_batch", runs["pq"]["index"], slice(0, b))):
        chk, args, kw = check_adc_kernel(label, ix, Q[rows].contiguous(),
                                         tm[rows].contiguous(),
                                         live_per_tile, 40)
        out["adc"][label] = chk
        traced.append((chk, ops.ivf_scan_adc, args, kw, ADC_KERNELS))
    for key, rows in (("grouped", slice(None)),
                      ("grouped_batch", slice(0, SERVE["batch"]))):
        # nq=10,000, and one served batch of 64 queries (8 groups)
        chk, args, kw = check_grouped_kernel(
            index, Q[rows].contiguous(), X_all, tm[rows].contiguous(),
            live_per_tile)
        out[key] = chk
        traced.append((chk, ops.ivf_scan_grouped, args, kw, GROUPED_KERNELS))
    # device time per call, traced after all the event timings above
    for chk, fn, args, kw, names in traced:
        launches = 1 + (chk.get("plan", {}).get("splits", 1) > 1)
        chk["device_us"] = kernel_device_us(lambda: fn(*args, **kw), [()],
                                            names, 5, launches=launches,
                                            bound_ms=chk["bound_ms"])
        log(f"{names} device time per call: {chk['device_us']} us "
            f"({launches} launch(es) a call; torch.profiler)")
    return out


# --------------------------------------------------------------- pairwise_sq

# pairwise_sq vs plain: |got - want| <= PAIR_RTOL·(||x_i||² + ||x_j||²) per
# element, the size of the terms that cancel in each distance.  A d-term f32
# dot rounds by at most d·2^-24 of it (7.6e-6 at d=128) and in practice by
# about √d·2^-24; the two sides sum in different orders.
PAIR_RTOL = 1e-5
TAIL_FROM = 512         # the reference's d_tile: the GIST-width fault drops
                        # the features past it


def pairwise_shapes(X):
    """{label: Xb} at the shapes the paper's configurations give the kernel:
    SIFT1M's graph build (phase 2's X as 15,625 clusters of ξ=64 rows,
    d=128), VLAD10M's width (the JAX bench's B=2,048, m=64, d=512) in f32
    and bf16, GIST1M's width (B=1,024, m=64, d=960: a partial last chunk at
    any chunk size) and m=128 (the JAX tests' largest capacity) at d=128 on
    phase 2's X."""
    import torch
    from repro_torch.data import sift_like
    g = torch.Generator(device=DEV).manual_seed(SEED + 20)
    n, d = X.shape
    xi = SIFT1M["xi"]
    vlad = sift_like(2048 * 64, 512, COMPONENTS, generator=g)
    gist = sift_like(1024 * 64, 960, COMPONENTS, generator=g)
    return {"sift1m": X.view(n // xi, xi, d),
            "vlad_f32": vlad.view(2048, 64, 512),
            "vlad_bf16": vlad.view(2048, 64, 512).to(torch.bfloat16),
            "gist": gist.view(1024, 64, 960),
            "m128": X[:n // 128 * 128].view(-1, 128, d)}


def _pair_plain(Xi, Xj, j_norm=True):
    """The plain version's arithmetic on rows Xi against rows Xj (the
    planted faults pass shifted rows, or drop the j norm)."""
    import torch
    sq_i = (Xi * Xi).sum(-1)[:, :, None]
    sq_j = (Xj * Xj).sum(-1)[:, None, :] if j_norm else 0.0
    return torch.clamp(sq_i + sq_j - 2.0 * torch.einsum("bid,bjd->bij", Xi, Xj),
                       min=0.0)


def pair_errors(got, want, Xb):
    """(max |got - want| / limit, max |got - want|, share of entries over
    the limit), limit = PAIR_RTOL·(||x_i||² + ||x_j||²)."""
    sq = (Xb.float() ** 2).sum(-1)
    lim = PAIR_RTOL * (sq[:, :, None] + sq[:, None, :])
    diff = (got - want).abs()
    r = diff / lim.clamp(min=1e-30)
    return float(r.max()), float(diff.max()), float((r > 1).float().mean())


def check_pairwise_sq(X):
    """pairwise_sq through ``ops.pairwise_sq`` at the shapes of
    ``pairwise_shapes``: one counted call per shape (no path of the system
    calls the kernel, so this is its path), then the kernel against its plain
    version with planted faults, and times of kernel, plain version and two
    yardsticks."""
    import torch
    from repro_torch.kernels import _build, ops, ref
    shapes = pairwise_shapes(X)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = {key: ops.pairwise_sq(Xb) for key, Xb in shapes.items()}
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    out = {"launches": launches["pairwise_sq"], "shapes": {}}
    path_ok = launches["pairwise_sq"] == len(shapes) and not any(
        v for key, v in launches.items() if key != "pairwise_sq")
    log(f"pairwise_sq counted calls through ops.pairwise_sq: "
        f"{json.dumps(launches)} ({'OK' if path_ok else 'FAIL'})")
    for key, Xb in shapes.items():
        B, m, d = Xb.shape
        g = got.pop(key)
        want = ops.pairwise_sq(Xb, force="ref")
        ratio, err, _ = pair_errors(g, want, Xb)
        sane = bool(torch.isfinite(g).all()) and bool((g >= 0).all())
        Xf = Xb.float()
        faults = {"norm_dropped": _pair_plain(Xf, Xf, j_norm=False),
                  "j_shifted": _pair_plain(Xf, Xf.roll(-1, 1))}
        if d > TAIL_FROM:
            faults["tail_dropped"] = ref.pairwise_sq(Xb[..., :TAIL_FROM])
        caught = {name: pair_errors(bad, want, Xb)[2]
                  for name, bad in faults.items()}
        del faults, Xf
        sym = torch.equal(g, g.mT)
        chk = dict(shape=f"B={B} m={m} d={d} {str(Xb.dtype)[6:]}",
                   max_abs_err=err, max_err_over_limit=ratio,
                   finite_nonneg=sane, symmetric_exact=sym,
                   fault_frac_over=caught,
                   ok=ratio <= 1.0 and sane and sym and all(
                       v > 0.5 for v in caught.values()))
        del g, want
        chk["ms"] = time_ms(lambda: ops.pairwise_sq(Xb), [()], 40)
        chk["plain_ms"] = time_ms(
            lambda: ops.pairwise_sq(Xb, force="ref"), [()], 10)
        # yardsticks the port never calls: no PyTorch call computes the
        # function (torch.cdist returns roots); bmm gives the dots alone,
        # baddbmm adds precomputed norms (no clamp), in the input's dtype
        sq = (Xb.float() ** 2).sum(-1).to(Xb.dtype)
        chk["bmm_ms"] = time_ms(lambda: torch.bmm(Xb, Xb.mT), [()], 20)
        chk["baddbmm_ms"] = time_ms(lambda: torch.baddbmm(
            sq[:, :, None] + sq[:, None, :], Xb, Xb.mT, alpha=-2), [()], 20)
        # the function needs one triangle of each symmetric D[b], diagonal
        # included (the norms): B·m(m+1)/2 dots of d FMAs.  A bf16×bf16
        # product is exact in f32, so bf16 input is held to the tensor-core
        # rate with f32 accumulation, f32 input to the FP32 rate (no TF32)
        chk["roof_shape"] = dict(B=B, m=m, d=d, itemsize=Xb.element_size())
        chk["bound_ms"], chk["bound_by"] = bound_ms("pairwise_sq",
                                                    **chk["roof_shape"])
        out["shapes"][key] = chk
    # device time per launch, traced after all the event timings above
    for key, Xb in shapes.items():
        out["shapes"][key]["device_us"] = kernel_device_us(
            lambda: ops.pairwise_sq(Xb), [()], PAIR_KERNELS,
            bound_ms=out["shapes"][key]["bound_ms"])
    for key, chk in out["shapes"].items():
        log(f"pairwise_sq[{key}]: {json.dumps(chk)}")
    out["ok"] = path_ok and all(c["ok"] for c in out["shapes"].values())
    return out


def profile_serving(index, Q, label="f32", **search_kw):
    """One nprobe=16 batch loop (40 batches of 64, each synchronised, as
    served), traced (after the counted runs)."""
    import torch
    from repro_torch import index as ivf
    b = SERVE["batch"]

    def loop():
        for b0 in range(0, min(40 * b, Q.shape[0] - b + 1), b):
            ivf.search(index, Q[b0:b0 + b], topk=SERVE["topk"], nprobe=16,
                       **search_kw)
            torch.cuda.synchronize()
    loop()
    profile_window(f"IVF serving {label} nprobe=16, 40 batches of 64", loop)


# the device kernels of the eight wrappers, as a trace names them
KERNEL_MARKERS = ("gather_score_kernel", "refine_merge_kernel",
                  *PROBE_KERNELS, *ASSIGN_KERNELS, *SCAN_KERNELS,
                  *ADC_KERNELS, *GROUPED_KERNELS, *PAIR_KERNELS)


def _short(name: str) -> str:
    for key in KERNEL_MARKERS:
        if key in name:
            return key
    return name if len(name) <= 70 else name[:67] + "..."


def profile_window(label, fn):
    """Trace ``fn`` with torch.profiler: wall time, device-busy time (union
    of the card's activity intervals), idle share and the top kernels, each
    with its share of the busy time.
    Informational: prints "not measured" where the trace shows no device
    activity.  A trace may lose its first records (see kernel_device_us),
    so a kernel's count can come up short; its time per launch holds.
    Returns {"wall_s", "busy_s", "idle", "activities", "by_name": {name:
    (us, count)}}, or None where the trace holds no device activity."""
    t0 = time.perf_counter()
    events, wall = _device_events(fn)
    log(f"profile[{label}]: traced and read back in "
        f"{time.perf_counter() - t0:.1f} s")
    spans, by_name = [], {}
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        n = _short(ev.name)
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + (b - a), c + 1)
    if not spans:
        log(f"profile[{label}]: wall {wall:.3f} s; device time not measured "
            "(the trace holds no device activity)")
        return None
    spans.sort()
    busy, cur_a, cur_b = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy = (busy + cur_b - cur_a) / 1e6
    log(f"profile[{label}]: wall {wall:.3f} s (profiled), device busy "
        f"{busy:.3f} s, idle share {1 - busy / wall:.3f}, "
        f"{len(spans)} device activities")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for n, (t, c) in top:
        log(f"  {t / 1e3:10.2f} ms  {c:7d}x  {t / 1e6 / busy:6.3f} of busy"
            f"  {n}")
    return dict(wall_s=wall, busy_s=busy, idle=1 - busy / wall,
                activities=len(spans), by_name=by_name)


def profile_main_path(X, r):
    """One engine epoch and a two-round graph build at the main path's
    shape, traced (after the counted run; its launches are not counted)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.knn_graph import build_knn_graph
    from repro_torch.core.permute import draw_words
    c = SIFT1M
    st = engine.init_state(X, r.assign, r.k)
    src = engine.graph_source(r.graph.ids)
    words = draw_words(torch.Generator().manual_seed(SEED + 6))
    cfg = engine.EngineConfig(batch_size=BATCH)
    profile_window("engine epoch, SIFT1M shape",
                   lambda: engine.epoch(X, st, src, words, cfg))
    profile_window("graph build tau=2, SIFT1M shape", lambda: build_knn_graph(
        X, c["kappa"], xi=c["xi"], tau=2, device=DEV,
        generator=torch.Generator().manual_seed(SEED + 7)))


# --------------------------------------------------------------- phase 6

# the paper's baselines (Fig. 4-6, Table 2) and graph search (§4.3) at
# SIFT1M's shape, with the iteration counts of its figure scripts
# (benchmarks/fig5_quality.py at full size) rather than the reference's
# defaults
# cut to fit the script's time: GK-means 20 -> 4 -> 2 iterations, BKM and
# the probe source 10 -> 3 -> 2 epochs, closure 10 -> 3 -> 2 iterations
# (each path's kernels still launch, its quality is still reported and
# held at SIFT_SMALL)
BASE = dict(k=10_000, kappa=50, nnd_iters=10, nnd_sample=100,
            nnd_chunk=4096, gk_iters=2, lloyd_iters=30, mb_batch=1024,
            epochs=2, probe_p=16, trees=3, leaf=32, closure_iters=2,
            topk=10, ef=32, search_iters=24)
# the SIFT_SMALL kernels-vs-plain runs keep the uncut counts: at 4
# GK-means iterations the kernels-vs-plain distortion gap of KGraph +
# GK-means read 0.0096 and 0.0109 against the 1% limit (0.0075 at 20)
BASE_SMALL = dict(BASE, gk_iters=20, epochs=10, closure_iters=10)
DIST_TOL = 0.01         # kernels vs plain, final distortion (PERF.md §2)
# each path's kernels: each must launch at least once in its counted run
BASE_KERNELS = {"nn_descent": ("refine_merge",),
                "kgraph_gk_means": ("gather_score",),
                "lloyd": ("assign_centroids",),
                "minibatch": ("assign_centroids",),
                "bkm_dense": (),
                "probe_source": ("probe_centroids", "gather_score"),
                "closure": ("gather_score",),
                "graph_search": ()}


def counted(fn, syncs=False):
    """One counted run of a path: (result, seconds, launches, host syncs).

    Every launch count is zeroed just before ``fn`` and read just after;
    seconds are host-clock with the device synchronised at both edges; with
    ``syncs``, ``fn`` runs under ``obs.syncs.sync_counter`` (a sync other
    than a counted read raises) and the count is its reads, else None."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.obs.syncs import sync_counter
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    if syncs:
        with sync_counter() as sc:
            out = fn()
    else:
        out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    return out, secs, launches, sc.syncs if syncs else None


def probe_run(X, assign0, k, force=None, seed=34, b=BASE):
    """The probe source's path: ``engine.run`` in bkm mode from ``assign0``
    with ``probe_source(p)``, all of ``b``'s epochs, then the final
    distortion read (its last host sync).  Returns (history, final, host
    syncs the run documents)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.obs import syncs
    cfg = engine.EngineConfig(batch_size=BATCH, mode="bkm", iters=b["epochs"],
                              min_move_frac=-1.0, force=force)
    res = engine.run(X, engine.init_state(X, assign0, k),
                     engine.probe_source(b["probe_p"]), cfg,
                     generator=torch.Generator().manual_seed(SEED + seed))
    return res.history, float(syncs.read(res.final)), res.host_syncs + 1


def baselines_small():
    """Each baseline path with a kernel, at the SIFT_SMALL shape, twice from
    equal generators: through the kernels and with ``force="ref"``.
    NN-Descent's recall@κ within RECALL_TOL, every final distortion within
    DIST_TOL, and Mini-Batch's final assignment against the plain
    ``assign_centroids`` on the same centroids (``sel_check``)."""
    import torch
    from repro_torch.core import (closure_kmeans, gk_means, lloyd,
                                  minibatch_kmeans, nn_descent)
    from repro_torch.core.gkmeans import _tree_init
    from repro_torch.core.objective import distortion
    from repro_torch.data import sift_like
    from repro_torch.kernels import ops, ref
    c, b = SIFT_SMALL, BASE_SMALL
    n, k, kappa = c["n"], c["k"], c["kappa"]
    X = sift_like(n, c["d"], COMPONENTS,
                  generator=torch.Generator(device=DEV).manual_seed(SEED))
    truth = sampled_truth(X, kappa, 2000, SEED + 3)
    a0 = _tree_init(X, k, torch.Generator().manual_seed(SEED + 40))

    def gen(s):
        return torch.Generator().manual_seed(SEED + s)
    runs, mb, graph = {}, None, None
    for force in (None, "ref"):
        t0 = time.perf_counter()
        q = {}
        g = nn_descent(X, kappa, iters=b["nnd_iters"], generator=gen(30),
                       force=force, device=DEV)
        q["nn_descent"] = recall_on(g.ids, truth, kappa)
        # both GK-means runs take the kernels' graph: this path's kernel is
        # gather_score (NN-Descent's is held on recall just above)
        graph = g if force is None else graph
        q["kgraph_gk_means"] = gk_means(
            X, k, graph=graph, iters=b["gk_iters"], batch_size=BATCH,
            generator=gen(31), force=force, device=DEV).distortion
        q["lloyd"] = lloyd(X, k, iters=b["lloyd_iters"], generator=gen(32),
                           force=force, device=DEV)[2][-1]
        a, C = minibatch_kmeans(X, k, steps=10 * (n // b["mb_batch"]),
                                batch_size=b["mb_batch"], generator=gen(33),
                                force=force, device=DEV)
        q["minibatch"] = float(distortion(X, a, k))
        mb = (a, C) if force is None else mb
        q["probe_source"] = probe_run(X, a0, k, force, b=b)[1]
        q["closure"] = closure_kmeans(
            X, k, iters=b["closure_iters"], trees=b["trees"], leaf=b["leaf"],
            batch_size=BATCH, generator=gen(35), force=force,
            device=DEV)[2][-1]
        runs[force or "kernels"] = q
        log(f"baselines SIFT_SMALL {force or 'kernels'}: {json.dumps(q)}, "
            f"{time.perf_counter() - t0:.1f} s")
    kq, rq = runs["kernels"], runs["ref"]
    gaps = {p: abs(kq[p] - rq[p]) / (1.0 if p == "nn_descent" else rq[p])
            for p in kq}
    # Mini-Batch's final assignment (the kernel's) against the plain
    # version on the kernel run's centroids
    a, C = mb
    ga = ops.assign_centroids(X, C)
    wa = ref.assign_centroids(X, C)
    scale = ((X * X).sum(-1) + (C * C).sum(-1)[wa[0].long()])[:, None]
    sel = sel_check((ga[0][:, None], ga[1][:, None]),
                    (wa[0][:, None], wa[1][:, None]), scale)
    sel["same_as_path"] = torch.equal(ga[0], a)
    checks = {p: gaps[p] <= (RECALL_TOL if p == "nn_descent" else DIST_TOL)
              for p in gaps}
    checks["minibatch_assign_vs_plain"] = sel["ok"] and sel["same_as_path"]
    log(f"baselines SIFT_SMALL kernels vs plain: gaps {json.dumps(gaps)} "
        f"(recall@{kappa} limit {RECALL_TOL}, distortion limit {DIST_TOL} "
        f"relative); Mini-Batch assignment vs plain {json.dumps(sel)}; "
        f"checks {json.dumps(checks)}")
    return all(checks.values()), dict(kernels=kq, ref=rq, gaps=gaps,
                                      minibatch_sel=sel)


def check_path_shapes(X):
    """The centroid kernels at the baselines' own shapes against their
    plain versions: ``assign_centroids`` at n=10^6, k=10,000 (Lloyd's and
    Mini-Batch's assignment, 3xTF32 bound) and ``probe_centroids`` at one
    engine batch of the probe source (B=1,024, k=16,384, p=16)."""
    import torch
    from repro_torch.kernels import ops
    n, d = X.shape
    g = torch.Generator(device=DEV).manual_seed(SEED + 32)
    out = {}
    k = BASE["k"]
    C = X[torch.randperm(n, generator=g, device=DEV)[:k]].contiguous()
    ga = ops.assign_centroids(X, C)
    wa = ops.assign_centroids(X, C, force="ref")
    scale = ((X * X).sum(-1) + (C * C).sum(-1)[wa[0].long()])[:, None]
    chk = sel_check((ga[0][:, None], ga[1][:, None]),
                    (wa[0][:, None], wa[1][:, None]), scale)
    del ga, wa, scale
    chk["plan"] = assign_plan(n, k)
    chk["shape"] = f"n={n} k={k} d={d}"
    chk["ms"] = time_ms(lambda: ops.assign_centroids(X, C), [()], 3)
    chk["plain_ms"] = time_ms(lambda: ops.assign_centroids(X, C,
                                                           force="ref"),
                              [()], 1)
    from repro_torch.launch.roofline import FP32_FLOPS
    chk["bound_ms"], chk["bound_by"] = bound_ms("assign_centroids", n=n, k=k,
                                                d=d)
    chk["bound_fp32_ms"], _ = bound_ms("assign_centroids", peak=FP32_FLOPS,
                                       n=n, k=k, d=d)
    out["assign"] = chk
    k2, p, B = 1 << (SIFT1M["k"] - 1).bit_length(), BASE["probe_p"], BATCH
    Cp = X[torch.randperm(n, generator=g, device=DEV)[:k2]].contiguous()
    xb = X[torch.randint(0, n, (B,), generator=g, device=DEV)].contiguous()
    got = ops.probe_centroids(xb, Cp, p)
    want = ops.probe_centroids(xb, Cp, p, force="ref")
    scale = (xb * xb).sum(-1)[:, None] + (Cp * Cp).sum(-1)[want[0].long()]
    chk = sel_check(got, want, scale)
    chk["plan"] = probe_plan(B, k2, p)
    chk["shape"] = f"B={B} k={k2} d={d} p={p}"
    chk["ms"] = time_ms(lambda: ops.probe_centroids(xb, Cp, p), [()], 20)
    chk["plain_ms"] = time_ms(lambda: ops.probe_centroids(xb, Cp, p,
                                                          force="ref"),
                              [()], 10)
    chk["mm_ms"] = time_ms(lambda: torch.matmul(xb, Cp.T), [()], 20)
    chk["bound_ms"], chk["bound_by"] = bound_ms("probe_centroids", n=B,
                                                k=k2, d=d, p=p)
    out["probe"] = chk
    # device time per call, traced after the event timings
    out["assign"]["device_us"] = kernel_device_us(
        lambda: ops.assign_centroids(X, C), [()], ASSIGN_KERNELS, reps=3,
        launches=1 + (out["assign"]["plan"]["splits"] > 1),
        bound_ms=out["assign"]["bound_ms"])
    out["probe"]["device_us"] = kernel_device_us(
        lambda: ops.probe_centroids(xb, Cp, p), [()], PROBE_KERNELS,
        launches=1 + (out["probe"]["plan"]["splits"] > 1),
        bound_ms=out["probe"]["bound_ms"])
    for key, chk in out.items():
        log(f"{key} at the baselines' shape: {json.dumps(chk)}")
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def baselines_phase(X, r, Q):
    """The paper's baselines and graph search at SIFT1M's shape, on phase
    4's data (and its GK-means graph, for graph search), each path a
    counted run of its own; then each kernel at these paths' shapes
    against its plain version, and the SIFT_SMALL kernels-vs-plain runs."""
    import torch
    from repro_torch.core import (closure_kmeans, gk_means, graph_search,
                                  init_kmeanspp, lloyd, minibatch_kmeans,
                                  nn_descent, recall_top1, run_bkm)
    from repro_torch.core.gkmeans import _tree_init
    from repro_torch.core.objective import distortion
    from repro_torch.launch import serve_index as si
    b = BASE
    n = X.shape[0]
    k, k2 = b["k"], 1 << (b["k"] - 1).bit_length()
    steps = 10 * (n // b["mb_batch"])
    log(f"baselines: n={n} d={X.shape[1]} sift_like; NN-Descent "
        f"kappa={b['kappa']} iters={b['nnd_iters']} sample={b['nnd_sample']}"
        f"; KGraph + GK-means k={k} -> {k2}, {b['gk_iters']} iterations; "
        f"Lloyd k={k}, k-means++, {b['lloyd_iters']} iterations with the "
        f"early stop; Mini-Batch k={k}, batch {b['mb_batch']}, {steps} "
        f"steps; full BKM (dense) and the probe source (p={b['probe_p']}, "
        f"bkm) k={k2} from the 2M tree, {b['epochs']} epochs; closure "
        f"k={k} -> {k2}, trees={b['trees']} leaf={b['leaf']}, "
        f"{b['closure_iters']} iterations; graph search over phase 4's "
        f"graph, nq={Q.shape[0]} topk={b['topk']} ef={b['ef']} "
        f"iters={b['search_iters']}; cuts: GK-means 20 -> 4 -> "
        f"{b['gk_iters']} iterations, BKM and probe source 10 -> 3 -> "
        f"{b['epochs']} epochs, closure 10 -> 3 -> {b['closure_iters']} "
        f"iterations")

    def gen(s):
        return torch.Generator().manual_seed(SEED + s)
    paths = {}

    def record(name, secs, launches, **quality):
        mine = {key: launches[key] for key in BASE_KERNELS[name]}
        paths[name] = dict(seconds=secs, launches=mine, **quality)
        log(f"baselines[{name}]: {json.dumps(paths[name])}")

    truth = sampled_truth(X, b["kappa"], 1000, SEED + 4)
    g, secs, lc, _ = counted(lambda: nn_descent(
        X, b["kappa"], iters=b["nnd_iters"], sample=b["nnd_sample"],
        chunk=b["nnd_chunk"], generator=gen(30), device=DEV))
    rows, gt = truth
    record("nn_descent", secs, lc,
           recall_at_kappa=recall_on(g.ids, truth, b["kappa"]),
           recall_top1=float(recall_top1(g.ids[rows], gt)))
    res, secs, lc, _ = counted(lambda: gk_means(
        X, k, graph=g, iters=b["gk_iters"], batch_size=BATCH,
        generator=gen(31), device=DEV))
    record("kgraph_gk_means", secs, lc, distortion=res.distortion,
           history=res.history, stage_seconds=res.seconds)
    del g, res

    def lloyd_path():
        t0 = time.perf_counter()
        C0 = init_kmeanspp(X, k, generator=gen(32), device=DEV)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        _, _, hist = lloyd(X, k, iters=b["lloyd_iters"], centroids=C0,
                           device=DEV)
        return t_init, hist
    (t_init, hist), secs, lc, _ = counted(lloyd_path)
    record("lloyd", secs, lc, init_seconds=t_init,
           iter_seconds=secs - t_init, iterations=len(hist),
           distortion=hist[-1], history=hist)
    (a, _), secs, lc, _ = counted(lambda: minibatch_kmeans(
        X, k, steps=steps, batch_size=b["mb_batch"], generator=gen(33),
        device=DEV))
    record("minibatch", secs, lc, steps=steps,
           distortion=float(distortion(X, a, k)))
    del a
    a0 = _tree_init(X, k2, gen(40))
    (st, hist), secs, lc, _ = counted(lambda: run_bkm(
        X, a0, k2, iters=b["epochs"], batch_size=BATCH, generator=gen(36),
        device=DEV))
    record("bkm_dense", secs, lc, distortion=hist[-1], history=hist)
    del st
    (hist, final, documented), secs, lc, syncs = counted(
        lambda: probe_run(X, a0, k2), syncs=True)
    record("probe_source", secs, lc, distortion=final, history=hist,
           host_syncs=syncs, host_syncs_documented=documented)
    (_, _, hist), secs, lc, _ = counted(lambda: closure_kmeans(
        X, k, iters=b["closure_iters"], trees=b["trees"], leaf=b["leaf"],
        batch_size=BATCH, generator=gen(35), device=DEV))
    record("closure", secs, lc, distortion=hist[-1], history=hist)
    # closure's candidate graph alone, one tree (outside the counted run):
    # its κ = trees·(leaf−1) = 93 refine goes through merge_topk's sorts
    from repro_torch.core.closure import _leafmate_graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _leafmate_graph(X, 1, b["leaf"], gen(37), None)
    torch.cuda.synchronize()
    paths["closure"]["leafmate_seconds_per_tree"] = time.perf_counter() - t0
    gt_q = si.ground_truth(Q, X, b["topk"])
    (ids, _), secs, lc, syncs = counted(lambda: graph_search(
        X, r.graph.ids, Q, b["topk"], b["ef"], b["search_iters"],
        generator=gen(38), device=DEV), syncs=True)
    record("graph_search", secs, lc, recall_at_10=si.recall(ids, gt_q),
           ms_per_10k_queries=secs * 1e3 * 1e4 / Q.shape[0],
           host_syncs=syncs)
    checks = {
        "launches": all(v["launches"][key] > 0 for v in paths.values()
                        for key in v["launches"]),
        "probe_host_syncs": paths["probe_source"]["host_syncs"]
        == b["epochs"] + 1 == paths["probe_source"]["host_syncs_documented"],
        "finite": all(v.get("distortion", 0.0) == v.get("distortion", 0.0)
                      for v in paths.values()),
    }
    log(f"baselines checks at SIFT1M's shape: {json.dumps(checks)}")
    shapes = check_path_shapes(X)
    X_pad, real_id = padded_copy(X)
    rm = check_refine_merge(X_pad, real_id, n, B=b["nnd_chunk"],
                            C=2 * b["nnd_sample"])
    del X_pad, real_id
    gs = {key: check_gather_score(X, k2, label, C=C) for key, label, C in (
        ("probe", "probe source", b["probe_p"] + 1),
        ("closure", "closure", b["trees"] * (b["leaf"] - 1)))}
    ok_small, small = baselines_small()
    checks.update(path_shapes=shapes["ok"], refine_merge_nnd=rm["ok"],
                  gather_score_probe=gs["probe"]["ok"],
                  gather_score_closure=gs["closure"]["ok"],
                  sift_small=ok_small)
    return all(checks.values()), dict(paths=paths, checks=checks,
                                      shapes=shapes, refine_merge=rm,
                                      gather_score=gs, sift_small=small)


# --------------------------------------------------------------- phase 7

OBS_EPOCHS = 4          # one-epoch runs, telemetry on and off in turns
OBS_ITERS = 2           # gk_means with telemetry off and on (cut 20 -> 3 -> 2)
ENGINE_SLOTS = ("moves", "proposed", "empty_clusters", "distortion",
                "hit_rate")
BUILD_SLOTS = ("overflow", "guided_moves", "graph_updates",
               "graph_mean_dist")


def engine_telemetry(X, r):
    """Phase 7.1: ``gk_means`` over phase 4's graph, telemetry off and then
    on (same generator seed, so the same work), each under the strict sync
    counter; the rows held against the result; then one-epoch
    ``engine.run`` calls from one state, on and off in turns, for the
    per-epoch cost."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.gkmeans import gk_means
    from repro_torch.core.permute import draw_words
    from repro_torch.kernels import _build
    from repro_torch.obs import telemetry as obs_tel
    from repro_torch.obs.syncs import sync_counter
    c = SIFT1M
    runs = {}
    for tel in (False, True):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with sync_counter() as sc:
            rr = gk_means(X, c["k"], kappa=c["kappa"], iters=OBS_ITERS,
                          batch_size=BATCH, graph=r.graph, telemetry=tel,
                          generator=torch.Generator().manual_seed(SEED + 50),
                          device=DEV)
        runs[tel] = dict(res=rr, syncs=sc.syncs,
                         launches=dict(_build.launch_counts))
    on, off = runs[True], runs[False]
    rr = on["res"]
    ep = len(rr.history)
    d = obs_tel.to_dict(rr.telemetry)          # CPU rows: no device read
    moves, prop = d["moves"][:ep], d["proposed"][:ep]
    hist32 = [float(torch.tensor(h, dtype=torch.float32)) for h in rr.history]
    checks = {
        "syncs": on["syncs"] == rr.host_syncs == ep + 1,
        "syncs_off": off["syncs"] == off["res"].host_syncs
        == len(off["res"].history) + 1,
        "moves": moves == rr.moves,
        "distortion": d["distortion"][:ep] == hist32,
        "proposed_ge_moves": all(p >= m for p, m in zip(prop, moves)),
        "hit_rate": all(abs(h - m / max(p, 1)) <= 1e-6 for h, m, p in zip(
            d["hit_rate"][:ep], moves, prop)),
        "empty_clusters": all(0 <= e < rr.k
                              for e in d["empty_clusters"][:ep]),
        "rows_past_epochs_zero": all(v == 0 for vals in d.values()
                                     for v in vals[ep:]),
        "gather_score_launched": on["launches"]["gather_score"] > 0,
        "off_has_no_rows": off["res"].telemetry is None,
    }
    log(f"engine telemetry (gk_means over phase 4's graph, k={c['k']} -> "
        f"{rr.k}, {OBS_ITERS} iterations), rows per epoch:")
    for t in range(ep):
        log("  " + json.dumps({s: d[s][t] for s in ENGINE_SLOTS}))
    # the cost: one-epoch runs from one state with the same words, in turns
    src = engine.graph_source(r.graph.ids)
    words = [draw_words(torch.Generator().manual_seed(SEED + 51))]
    epoch_s = {True: [], False: []}
    for tel in (True, False, False, True) * (OBS_EPOCHS // 4):
        st = engine.init_state(X, r.assign, r.k)
        cfg = engine.EngineConfig(batch_size=BATCH, iters=1, telemetry=tel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(X, st, src, cfg, epoch_words=words)
        torch.cuda.synchronize()
        epoch_s[tel].append(time.perf_counter() - t0)
    # the work telemetry adds to an epoch, alone: one pre-guard sum and add
    # a batch (the per-epoch row is a handful of ops more)
    nb = c["n"] // BATCH
    moved = torch.rand(BATCH, device=DEV) < 0.5
    prop = torch.zeros((), dtype=torch.int32, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(nb):
        prop.add_(moved.sum(dtype=torch.int32))
    torch.cuda.synchronize()
    added_s = time.perf_counter() - t0
    med = {tel: sorted(v)[len(v) // 2] for tel, v in epoch_s.items()}
    out = dict(
        iter_s_on=rr.seconds["iter"], iter_s_off=off["res"].seconds["iter"],
        epochs_on=ep, epochs_off=len(off["res"].history),
        epoch_s_on=epoch_s[True], epoch_s_off=epoch_s[False],
        epoch_s_on_mean=sum(epoch_s[True]) / len(epoch_s[True]),
        epoch_s_off_mean=sum(epoch_s[False]) / len(epoch_s[False]),
        epoch_s_on_median=med[True], epoch_s_off_median=med[False],
        added_work_s=added_s, host_syncs=on["syncs"], distortion=rr.distortion,
        distortion_off=off["res"].distortion,
        gather_score_launches=on["launches"]["gather_score"],
        rows={s: d[s][:ep] for s in ENGINE_SLOTS}, checks=checks)
    log(f"engine telemetry cost: iter stage {out['iter_s_on']:.3f} s on, "
        f"{out['iter_s_off']:.3f} s off ({ep} and {out['epochs_off']} "
        f"epochs); one-epoch run {out['epoch_s_on_mean']:.4f} s on, "
        f"{out['epoch_s_off_mean']:.4f} s off, medians {med[True]:.4f} and "
        f"{med[False]:.4f} (each of {OBS_EPOCHS // 2}: on {epoch_s[True]}, "
        f"off {epoch_s[False]}); the added work alone ({nb} pre-guard sums "
        f"and adds) {added_s:.4f} s; host syncs "
        f"{on['syncs']} (epochs + 1 = {ep + 1}); checks {json.dumps(checks)}")
    return all(checks.values()), out


def build_telemetry(X, ref_tel):
    """Phase 7.2: the main path's graph build (phase 4's seed) through the
    kernels with telemetry, under the strict sync counter (a build reads
    nothing back); its rows against its own diagnostics, round to round,
    and against the plain versions' build of phase 4 (``ref_tel``)."""
    import torch
    from repro_torch.core.knn_graph import build_knn_graph
    from repro_torch.kernels import _build
    from repro_torch.obs import telemetry as obs_tel
    from repro_torch.obs.syncs import sync_counter
    c = SIFT1M
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with sync_counter() as sc:
        _, diag = build_knn_graph(
            X, c["kappa"], xi=c["xi"], tau=c["tau"],
            generator=torch.Generator().manual_seed(SEED), device=DEV,
            telemetry=True, return_diagnostics=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    d = obs_tel.to_dict(diag.telemetry)
    md, md_ref = d["graph_mean_dist"], ref_tel["graph_mean_dist"]
    checks = {
        "syncs": sc.syncs == 0,
        "overflow": d["overflow"] == diag.overflow.tolist(),
        "guided_moves": d["guided_moves"] == diag.guided_moves.tolist(),
        "mean_dist_non_increasing": all(
            b <= a * (1 + 1e-6) for a, b in zip(md, md[1:])),
        "updates_round0": d["graph_updates"][0] > 0,
        "mean_dist_vs_plain": len(md) == len(md_ref) and all(
            abs(a - b) <= 0.01 * b for a, b in zip(md, md_ref)),
        "overflow_round0_vs_plain": d["overflow"][0] == ref_tel["overflow"][0],
        "refine_merge_launched": launches["refine_merge"] > 0,
    }
    gaps = [abs(a - b) / b for a, b in zip(md, md_ref)]
    log(f"graph-build telemetry (n={c['n']} kappa={c['kappa']} xi={c['xi']} "
        f"tau={c['tau']}, {secs:.3f} s, {sc.syncs} host syncs), rows per "
        "round:")
    for t in range(c["tau"]):
        log("  " + json.dumps({s: d[s][t] for s in BUILD_SLOTS}))
    log(f"graph_mean_dist through the kernels vs the plain versions, "
        f"relative gap per round {gaps} (limit 0.01); launches "
        f"{json.dumps(launches)}; checks {json.dumps(checks)}")
    return all(checks.values()), dict(seconds=secs, host_syncs=sc.syncs,
                                      rows={s: d[s] for s in BUILD_SLOTS},
                                      mean_dist_gap=gaps, checks=checks)


def scope_check(label, fn):
    """Phase 7.3: trace ``fn`` (launch counts zeroed just before).  The
    ranges of each ``repro_torch.kernels.<name>`` must equal its wrapper
    calls, each range must hold at least one kernel launch of the CUDA
    runtime, and every device launch of the eight kernels that the trace
    kept must come from a launch inside a range.  (A trace loses some
    device records, see ``kernel_device_us``; the host's it keeps.)"""
    from repro_torch.kernels import _build
    from repro_torch.obs.timing import scope_coverage
    _build.reset_launch_counts()
    events = _trace(fn)[0].events()
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    cov = scope_coverage(events, KERNEL_MARKERS)
    ok = (bool(launches) and cov["ranges"] == launches
          and all(cov["range_launches"].get(k, 0) >= v
                  for k, v in launches.items())
          and cov["in_range"] == cov["device_launches"] > 0)
    log(f"kernel scopes[{label}]: ranges {cov['ranges']}, wrapper calls "
        f"{launches}, runtime launches inside the ranges "
        f"{cov['range_launches']}, device launches the trace kept "
        f"{cov['device_launches']}, of them launched in a range "
        f"{cov['in_range']} {'OK' if ok else 'FAIL'}")
    return ok, dict(cov, launches=launches)


def kernel_entries(gs, rm, ca, sc, cc, pw):
    """Each kernel's device us per call at its main shape from phase 2 (the
    kernels line's), with its inventory arguments; CUDA-event time of a
    wrapper call where the trace kept no device time."""
    picks = (("gather_score", gs, gs["bkm"]), ("refine_merge", rm, rm),
             ("probe_centroids", ca["probe"][16], ca["probe"][16]),
             ("assign_centroids", ca["assign"]["n10k"], ca["assign"]["n10k"]),
             ("ivf_scan", sc[16], sc[16]),
             ("ivf_scan_adc", cc["adc"]["pq8"], cc["adc"]["pq8"]),
             ("ivf_scan_grouped", cc["grouped"], cc["grouped"]),
             ("pairwise_sq", pw["shapes"]["sift1m"], pw["shapes"]["sift1m"]))
    out = []
    for name, shaped, timed in picks:
        us, how = timed.get("device_us"), "torch.profiler device time a call"
        if us is None:
            us, how = timed["ms"] * 1e3, "CUDA events a wrapper call"
        out.append({"kernel": name, "shape": shaped["roof_shape"], "us": us,
                    "us_from": how})
    return out


def obs_phase(X, r, ref_tel, index, Q, entries):
    """Phase 7, the observability layer on phase 4's data: engine and
    graph-build telemetry, the kernel scopes in two traces, and the run
    records read back by ``launch/obs_report.py``."""
    import os
    import tempfile
    import torch
    from repro_torch import index as ivf
    from repro_torch.core import engine
    from repro_torch.core.permute import draw_words
    from repro_torch.kernels import _build
    from repro_torch.launch import obs_report
    from repro_torch.obs import emit
    t_phase = time.perf_counter()
    c = SIFT1M
    ok_eng, eng = engine_telemetry(X, r)
    ok_build, build = build_telemetry(X, ref_tel)
    b = SERVE["batch"]

    def served():
        for b0 in range(0, 40 * b, b):
            ivf.search(index, Q[b0:b0 + b], topk=SERVE["topk"], nprobe=16)
            torch.cuda.synchronize()
    st = engine.init_state(X, r.assign, r.k)
    src = engine.graph_source(r.graph.ids)
    words = draw_words(torch.Generator().manual_seed(SEED + 6))
    ok_s1, sc_served = scope_check("f32 served batches, nprobe=16", served)
    ok_s2, sc_epoch = scope_check("engine epoch", lambda: engine.epoch(
        X, st, src, words, engine.EngineConfig(batch_size=BATCH)))
    kernels = [e["kernel"] for e in entries]
    krec = emit.run_record(
        "kernels", metrics={"kernels": entries},
        notes=["device us per call at each kernel's main shape, phase 2"])
    erec = emit.run_record(
        "engine", shapes=dict(n=c["n"], d=c["d"], k=r.k),
        config=dict(iters=OBS_ITERS, batch_size=BATCH, kappa=c["kappa"],
                    telemetry=True),
        metrics={key: eng[key] for key in (
            "iter_s_on", "iter_s_off", "epochs_on", "epoch_s_on_median",
            "epoch_s_off_median", "added_work_s", "host_syncs",
            "distortion")},
        telemetry=eng["rows"])
    grec = emit.run_record(
        "graph_build", shapes=dict(n=c["n"], d=c["d"]),
        config=dict(kappa=c["kappa"], xi=c["xi"], tau=c["tau"],
                    telemetry=True),
        metrics=dict(seconds=build["seconds"],
                     host_syncs=build["host_syncs"]),
        telemetry=build["rows"])
    with tempfile.TemporaryDirectory() as tmp:
        for rec in (krec, erec, grec):
            emit.write_json(os.path.join(tmp, f"BENCH_{rec['name']}.json"),
                            rec)
        rc = obs_report.main(["--dir", tmp, "--require", "kernels", "engine",
                              "graph_build", *kernels])
        fracs = {row["kernel"]: row["achieved_frac"]
                 for row in obs_report.kernel_rows(krec)}
    checks = dict(engine=ok_eng, graph_build=ok_build, scopes_served=ok_s1,
                  scopes_epoch=ok_s2, obs_report_rc0=rc == 0,
                  every_kernel=sorted(kernels) == sorted(_build.KERNELS),
                  achieved_at_most_1=all(f <= 1.0 for f in fracs.values()))
    secs = time.perf_counter() - t_phase
    log(f"obs phase: achieved fractions {json.dumps(fracs)}; checks "
        f"{json.dumps(checks)}; {secs:.1f} s")
    return all(checks.values()), dict(
        seconds=secs, engine=eng, graph_build=build, achieved_frac=fracs,
        scopes={"served": sc_served, "epoch": sc_epoch}, checks=checks)


# --------------------------------------------------------------- phase 8

# clustered-KV decode at Qwen2-72B's attention widths
# (src/repro/configs/qwen2_72b.py: n_kv_heads=8, n_heads=64, head_dim=128)
# in the full setting of benchmarks/kv_cluster_bench.py (B=16, S=32,768, bf16
# caches, kc = S/64, top_c=8), and the bench's quick shape for the card
# against the port's own CPU run
KV = dict(B=16, S=32_768, Hkv=8, G=8, hd=128, top_c=8)
KV_QUICK = dict(B=4, S=8_192, Hkv=4, G=4, hd=64, top_c=8)
KV_TOL = 1e-2           # the reference test's rtol = atol at top_c = kc
KV_DIST_TOL = 0.01      # card vs CPU: per-slice distortion, relative
KV_RECALL_TOL = 2 / 64  # card vs CPU: candidate recall over 64 heads


def kv_data(c, seed, device):
    """(q, k_cache, v_cache) in bf16, kv_cluster_bench.py's recipe: keys
    around 64 centres per batch row, queries twice a cached key of their kv
    head."""
    import torch
    B, S, H, G, hd = (c[key] for key in ("B", "S", "Hkv", "G", "hd"))
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn(B, 64, H, hd, generator=g, device=device) * 2.0
    which = torch.randint(0, 64, (B, S), generator=g, device=device)
    bi = torch.arange(B, device=device)[:, None]
    k = (centers[bi, which] + 0.3 * torch.randn(
        B, S, H, hd, generator=g, device=device)).to(torch.bfloat16)
    v = torch.randn(B, S, H, hd, generator=g, device=device).to(
        torch.bfloat16)
    tgt = torch.randint(0, S, (B, H * G), generator=g, device=device)
    picked = k[bi, tgt, torch.arange(H * G, device=device)[None] // G]
    return (2.0 * picked.float())[:, None].to(torch.bfloat16), k, v


def kv_assign(table, S):
    """(P, S) cluster ids of every key from a (B, Hkv, kc, cap) member
    table; -1 for a key the cap dropped."""
    import torch
    B, H, kc, cap = table.shape
    t = table.reshape(B * H, kc * cap).long()
    cid = torch.arange(kc, device=t.device).repeat_interleave(cap)
    a = torch.full((B * H, S + 1), -1, dtype=torch.long, device=t.device)
    a.scatter_(1, torch.where(t >= 0, t, S), cid.expand_as(t))
    return a[:, :S]


def kv_distortion(k, table):
    """Per-slice mean squared distance of the tabled keys to their
    cluster's mean (float64 sums), (P,) on the host."""
    import torch
    B, S, H, hd = k.shape
    X = k.permute(0, 2, 1, 3).reshape(B * H, S, hd).double()
    a = kv_assign(table, S)
    kc = table.shape[2]
    keep = a >= 0
    flat = torch.where(keep, a + torch.arange(B * H, device=a.device)[
        :, None] * kc, 0).reshape(-1)
    w = keep.reshape(-1).double()
    D = torch.zeros(B * H * kc, hd, dtype=torch.float64,
                    device=X.device).index_add_(0, flat,
                                                X.reshape(-1, hd) * w[:, None])
    n = torch.zeros(B * H * kc, dtype=torch.float64,
                    device=X.device).index_add_(0, flat, w)
    cent = D / n.clamp(min=1.0)[:, None]
    d2 = ((X.reshape(-1, hd) - cent[flat]) ** 2).sum(-1) * w
    return (d2.view(B * H, S).sum(1) / keep.sum(1)).cpu()


def runtime_launches(fn):
    """(kernel launches, wall seconds) of ``fn`` from the CUDA runtime and
    driver calls of a torch.profiler trace (host records, which a trace
    keeps whole)."""
    import torch
    prof, wall = _trace(fn)
    cpu = torch.autograd.DeviceType.CPU
    return sum(1 for ev in prof.events() if ev.device_type == cpu
               and "LaunchKernel" in ev.name), wall


def kv_quick_parity():
    """The bench's quick shape, built on the card and on the CPU from the
    same draws (tree seeds and epoch words from one CPU generator): per-
    slice distortion within 1%, candidate recall within 2/64."""
    import torch
    from repro_torch.core import kv_cluster as kv
    from repro_torch.core.permute import draw_words
    from repro_torch.core.two_means import draw_tree_seeds
    c = KV_QUICK
    B, S, H = c["B"], c["S"], c["Hkv"]
    kc, P = S // 64, B * H
    q, k, _ = kv_data(c, SEED + 42, DEV)
    g = torch.Generator().manual_seed(SEED + 43)
    drawn = [draw_tree_seeds(S, kc, g) for _ in range(P)]
    seeds = tuple(torch.stack([d[j] for d in drawn]) for j in (0, 1))
    words = draw_words(g, P * 2 * 4).view(P, 2, 4)
    out = {}
    for name, refine, cap_factor in (("plain", 0, 2), ("refined", 2, 8)):
        res = {}
        for dev, qq, kk in ((DEV, q, k), ("cpu", q.cpu(), k.cpu())):
            t0 = time.perf_counter()
            cl = kv.build_kv_clusters(kk, kc, cap_factor=cap_factor,
                                      refine_epochs=refine, tree_seeds=seeds,
                                      epoch_words=words, device=dev)
            rec = float(kv.candidate_recall(qq, kk, cl, S, c["top_c"]))
            res[dev] = dict(dist=kv_distortion(kk, cl.table), recall=rec,
                            seconds=time.perf_counter() - t0)
        gap = float(((res[DEV]["dist"] - res["cpu"]["dist"]).abs()
                     / res["cpu"]["dist"]).max())
        dr = abs(res[DEV]["recall"] - res["cpu"]["recall"])
        out[name] = dict(max_dist_gap=gap, recall_card=res[DEV]["recall"],
                         recall_cpu=res["cpu"]["recall"],
                         mean_dist_card=float(res[DEV]["dist"].mean()),
                         mean_dist_cpu=float(res["cpu"]["dist"].mean()),
                         cpu_build_s=res["cpu"]["seconds"],
                         ok=gap <= KV_DIST_TOL and dr <= KV_RECALL_TOL)
    return out


def kv_cluster_phase():
    """Phase 8: clustered-KV decode at the full shape — two builds (no
    refinement; two dense engine epochs at cap_factor 8) and the attention,
    each under ``sync_counter`` (0 host syncs); tables, top_c = kc against
    full attention, times, launches, bytes, recall, peak memory — then the
    quick shape against the port's CPU run.  None of the eight kernels may
    launch."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core import kv_cluster as kv
    from repro_torch.kernels import _build
    from repro_torch.models import decode_attention
    from repro_torch.obs.syncs import sync_counter
    from repro_torch.obs.timing import device_span
    t_phase = time.perf_counter()
    c = KV
    B, S, H, G, hd, top_c = (c[key] for key in
                             ("B", "S", "Hkv", "G", "hd", "top_c"))
    kc, P = S // 64, B * H
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    q, k, v = kv_data(c, SEED + 40, DEV)
    ln = torch.tensor(S, device=DEV)
    checks, builds, clusters = {}, {}, {}
    for name, refine, cap_factor in (("plain", 0, 2), ("refined", 2, 8)):
        ms = {}
        with device_span("build", ms):
            with sync_counter() as sc:
                cl = kv.build_kv_clusters(
                    k, kc, cap_factor=cap_factor, refine_epochs=refine,
                    generator=torch.Generator().manual_seed(SEED + 41),
                    device=DEV)
        t = cl.table.reshape(P, -1).long()
        seen = torch.zeros(P, S + 1, dtype=torch.int32, device=DEV)
        seen.scatter_add_(1, torch.where(t >= 0, t, S),
                          torch.ones_like(t, dtype=torch.int32))
        held = int((t >= 0).sum())
        once = bool((seen[:, :S] <= 1).all())
        builds[name] = dict(
            seconds=ms["build"] / 1e3, host_syncs=sc.syncs,
            cap=cl.table.shape[-1], refine_epochs=refine,
            dropped_by_cap=P * S - held, at_most_once=once,
            empty_clusters=int((cl.table[..., 0] < 0).sum()),
            largest_cluster=int((cl.table >= 0).sum(-1).max()))
        checks[f"{name}_build_0_syncs"] = sc.syncs == 0
        checks[f"{name}_keys_at_most_once"] = once
        clusters[name] = cl
    checks["plain_every_key_once"] = builds["plain"]["dropped_by_cap"] == 0
    log(f"kv build: {json.dumps(builds)}")

    # the refine epochs' launches: one run_slices epoch against one slice's
    # engine.run epoch (a Python loop over the slices makes P of those)
    flat = k.permute(0, 2, 1, 3).reshape(P, S, hd).float()
    a0 = kv_assign(clusters["plain"].table, S).to(torch.int32)
    cfg = engine.EngineConfig(batch_size=min(1024, S), iters=1,
                              min_move_frac=-1.0)
    words = torch.randint(0, 2 ** 32, (P, 1, 4),
                          generator=torch.Generator().manual_seed(SEED + 44))
    batched, b_wall = runtime_launches(lambda: engine.run_slices(
        flat, a0, kc, cfg, epoch_words=words))
    st0 = engine.init_state(flat[0], a0[0], kc)
    single, s_wall = runtime_launches(lambda: engine.run(
        flat[0], st0, engine.dense_source(), cfg, epoch_words=words[0]))
    ms = {}
    with device_span("epoch", ms):
        engine.run_slices(flat, a0, kc, cfg, epoch_words=words)
    epoch = dict(run_slices_launches=batched, one_slice_launches=single,
                 python_loop_launches=P * single,
                 run_slices_epoch_ms=ms["epoch"], traced_wall_s=b_wall,
                 one_slice_traced_wall_s=s_wall)
    log(f"kv refine epoch: {json.dumps(epoch)}")
    del flat, a0, st0

    # attention: syncs, time, keys and bytes a step
    attn = {}
    qf = q.float().reshape(B, H, G, hd)
    best = (qf @ k.float().permute(0, 2, 3, 1)).argmax(-1)   # (B, H, G)
    with sync_counter() as sc:
        decode_attention(q, k, v, ln)
    full_syncs = sc.syncs
    full_ms = time_ms(lambda: decode_attention(q, k, v, ln), [()], reps=10)
    bytes_full = B * H * S * hd * 2 * 2
    attn["full"] = dict(us=full_ms * 1e3, host_syncs=full_syncs,
                        keys_touched=S, cache_bytes=bytes_full)
    checks["full_0_syncs"] = full_syncs == 0
    for name, cl in clusters.items():
        with sync_counter() as sc:
            kv.clustered_decode_attention(q, k, v, cl, ln, top_c=top_c)
            rec_t = kv.candidate_recall(q, k, cl, ln, top_c)
        cms = time_ms(lambda: kv.clustered_decode_attention(
            q, k, v, cl, ln, top_c=top_c), [()], reps=20)
        cap = cl.table.shape[-1]
        top = kv._select_clusters(qf * hd ** -0.5, cl, top_c)
        valid = (kv._candidates(top, cl.table) >= 0).sum(-1).float()
        # where the ball bound ranks the cluster of each head's best key
        # (0 = first), and the spread of the radii behind that rank
        bc = kv_assign(cl.table, S).view(B, H, S).gather(2, best)
        bound = (qf @ cl.centroids.mT + torch.linalg.vector_norm(
            qf, dim=-1)[..., None] * cl.radii[:, :, None, :])
        rank = (bound > bound.gather(3, bc.clamp(min=0)[..., None])).sum(-1)
        rq = torch.quantile(cl.radii.flatten(),
                            torch.tensor([0.5, 0.9, 0.99], device=DEV))
        touched = top_c * cap
        attn[name] = dict(
            us=cms * 1e3, host_syncs=sc.syncs, keys_touched=touched,
            keys_attended_mean=float(valid.mean()),
            cache_bytes=B * H * G * touched * hd * 2 * 2,
            bytes_ratio=bytes_full / (B * H * G * touched * hd * 2 * 2),
            candidate_recall=float(rec_t), top_c=top_c, cap=cap,
            best_cluster_rank_median=float(rank.float().median()),
            best_cluster_rank_max=int(rank.max()),
            radius_p50_p90_p99=[float(x) for x in rq])
        checks[f"{name}_attention_0_syncs"] = sc.syncs == 0
    # top_c = kc is full attention (every key in one cluster), two batch
    # rows at a time: the gathered candidates are 2·S per q head
    err, ok_all = 0.0, True
    cl = clusters["plain"]
    for b0 in range(0, B, 2):
        sl = slice(b0, b0 + 2)
        part = kv.KVClusters(cl.centroids[sl], cl.table[sl], cl.radii[sl])
        got = kv.clustered_decode_attention(q[sl], k[sl], v[sl], part, ln,
                                            top_c=kc).float()
        want = decode_attention(q[sl], k[sl], v[sl], ln).float()
        err = max(err, float((got - want).abs().max()))
        ok_all &= bool(torch.isfinite(got).all()) and bool(
            ((got - want).abs() <= KV_TOL + KV_TOL * want.abs()).all())
        del got, want
    checks["top_c_kc_is_full"] = ok_all
    attn["top_c_kc_max_abs_err"] = err
    peak = torch.cuda.max_memory_allocated()
    log(f"kv attention: {json.dumps(attn)}")
    launches = {key: n for key, n in _build.launch_counts.items() if n}
    checks["no_kernel_launch"] = not launches
    del q, k, v, qf, best, clusters, cl, part
    quick = kv_quick_parity()
    checks.update({f"quick_{key}": r["ok"] for key, r in quick.items()})
    secs = time.perf_counter() - t_phase
    out = dict(shape=dict(c, kc=kc, dtype="bfloat16"), builds=builds,
               refine_epoch=epoch, attention=attn, quick=quick,
               peak_gib=(peak - base_mem) / 2 ** 30,
               launches=launches, checks=checks, seconds=secs)
    log(f"kv phase: quick {json.dumps(quick)}; checks {json.dumps(checks)}; "
        f"{secs:.1f} s")
    return all(checks.values()), out


# --------------------------------------------------------------- phase 9

# the sharded topology (core/distributed.py, the engine's R-way emulation)
# at SIFT1M's shape on phase 4's data.  (a) The R = 4 emulation through the
# kernels and through the plain versions; cut: tau 2 and 6 epochs (the
# plain-version build's refine_merge takes ~16 s a round at this shape), one
# epoch of the probe source.  (b) A world-size-1 NCCL group: NCCL takes one
# rank a card and the machine has one, so ranks that exchange data run in
# the CPU tests (gloo) only.
SHARD = dict(R=4, tau=2, iters=2, probe_p=16, group_iters=2, nprobe=16)


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def sharded_init(X, k, seed):
    """The 2M-tree initialisation of gk_means (pad_plan's wrap rows, their
    assignments dropped): (assign (n,), k rounded to a power of two)."""
    import torch
    from repro_torch.core.two_means import pad_plan, two_means_tree
    n = X.shape[0]
    n2, k2 = pad_plan(n, k)
    Xi = X if n2 == n else torch.cat([X, X[:n2 - n]])
    return two_means_tree(Xi, k2, generator=torch.Generator().manual_seed(
        seed))[:n], k2


def emulation_pipeline(X, force, truth):
    """Phase 9(a), one pass: ``build_knn_graph(shards=4)`` (counted, under
    the sync counter), the tree init, ``engine.run(shards=4,
    sparse_updates=True)`` (its reads plus the final distortion's) and one
    epoch of the emulated probe source, each a counted run."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.knn_graph import build_knn_graph
    from repro_torch.obs import syncs
    c, s = SIFT1M, SHARD
    out = {}
    (g, diag), secs, launches, nsync = counted(lambda: build_knn_graph(
        X, c["kappa"], xi=c["xi"], tau=s["tau"], shards=s["R"], force=force,
        chunk=REF_CHUNK if force else 1024,
        generator=torch.Generator().manual_seed(SEED), device=DEV,
        return_diagnostics=True), syncs=True)
    out["build"] = dict(seconds=secs, launches=_nonzero(launches),
                        host_syncs=nsync,
                        recall=recall_on(g.ids, truth, c["kappa"]),
                        overflow=diag.overflow.tolist(),
                        guided_moves=diag.guided_moves.tolist())
    (a0, k2), secs, launches, _ = counted(
        lambda: sharded_init(X, c["k"], SEED + 1))
    out["init"] = dict(seconds=secs, launches=_nonzero(launches))
    cfg = engine.EngineConfig(batch_size=BATCH, iters=s["iters"],
                              min_move_frac=1e-4, shards=s["R"],
                              sparse_updates=True, force=force)

    def run():
        res = engine.run(X, engine.init_state(X, a0, k2),
                         engine.graph_source(g.ids), cfg,
                         generator=torch.Generator().manual_seed(SEED + 2))
        return res, float(syncs.read(res.final))
    (res, final), secs, launches, nsync = counted(run, syncs=True)
    out["run"] = dict(seconds=secs, launches=_nonzero(launches),
                      host_syncs=nsync, epochs=res.epochs,
                      history=res.history, moves=res.moves, final=final,
                      rows_counted=int(res.state.cnt.sum()))
    pcfg = cfg._replace(iters=1, min_move_frac=-1.0)

    def probe():
        res = engine.run(X, engine.init_state(X, a0, k2),
                         engine.probe_source(s["probe_p"]), pcfg,
                         generator=torch.Generator().manual_seed(SEED + 3))
        return float(syncs.read(res.final))
    pfinal, secs, launches, _ = counted(probe)
    out["probe_source"] = dict(seconds=secs, launches=_nonzero(launches),
                               final=pfinal)
    log(f"sharded (a) R={s['R']} emulation, "
        f"{'kernels' if force is None else 'plain versions'}: "
        f"{json.dumps(out)}")
    return out, (a0, k2)


def group_phase(X, r, init, index, runs, Q, gt):
    """Phase 9(b): a world-size-1 NCCL group on the card.  GraphBuilder at
    SIFT_SMALL against the one-device build; ShardedEngine.run on phase
    4's graph against engine.run from the same init; ShardedIvf.search on
    phase 5's index (f32, qgroup 8, int8 and PQ nsub=8 with rerank 0)
    against search — each a counted run, the engine's and the searches'
    under the sync counter."""
    import tempfile
    import torch
    from repro_torch import index as ivf
    from repro_torch.core import engine
    from repro_torch.core.distributed import (ShardedEngine, ShardedIvf,
                                              sharded_graph_builder)
    from repro_torch.core.graph_build import GraphBuildConfig, build_graph
    from repro_torch.data import sift_like
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_index as si
    from repro_torch.launch.mesh import close_group, init_group
    from repro_torch.obs import syncs
    from repro_torch.obs import telemetry as obs_tel
    c, s, cs = SIFT1M, SHARD, SIFT_SMALL
    out, checks = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init_group(DEV, rank=0, world_size=1, store_path=f"{tmp}/store")
        try:
            import torch.distributed as dist
            log(f"sharded (b): process group backend {dist.get_backend()}, "
                f"world size {dist.get_world_size()}")
            Xs = sift_like(cs["n"], cs["d"], COMPONENTS,
                           generator=torch.Generator(device=DEV).manual_seed(
                               SEED))
            truth = sampled_truth(Xs, cs["kappa"], 2000, SEED + 3)
            bcfg = GraphBuildConfig(kappa=cs["kappa"], xi=cs["xi"],
                                    tau=cs["tau"])
            (g1, _), s1, l1, y1 = counted(lambda: sharded_graph_builder(
                None, bcfg).build(Xs, generator=torch.Generator(
                ).manual_seed(SEED)), syncs=True)
            (g0, _), s0, l0, _ = counted(lambda: build_graph(
                Xs, bcfg, generator=torch.Generator().manual_seed(SEED)))
            rec1 = recall_on(g1.ids, truth, cs["kappa"])
            rec0 = recall_on(g0.ids, truth, cs["kappa"])
            out["graph_builder"] = dict(
                shape="SIFT_SMALL", seconds=s1, launches=_nonzero(l1),
                host_syncs=y1, recall=rec1, one_device_seconds=s0,
                one_device_recall=rec0)
            checks["builder_recall"] = abs(rec1 - rec0) <= RECALL_TOL
            checks["builder_syncs"] = y1 == 0
            checks["builder_launches"] = l1["refine_merge"] > 0
            del Xs, g1, g0

            a0, k2 = init
            st = engine.init_state(X, a0, k2)
            ecfg = engine.EngineConfig(batch_size=BATCH,
                                       iters=s["group_iters"],
                                       min_move_frac=1e-4,
                                       sparse_updates=True)

            def grun():
                res = ShardedEngine(None, ecfg).run(
                    X, r.graph.ids, st.assign, st.D, st.cnt,
                    generator=torch.Generator().manual_seed(SEED + 2))
                return res, float(syncs.read(res.final))

            def srun():
                res = engine.run(X, engine.init_state(X, a0, k2),
                                 engine.graph_source(r.graph.ids), ecfg,
                                 generator=torch.Generator().manual_seed(
                                     SEED + 2))
                return res, float(syncs.read(res.final))
            (res1, f1), sec1, la1, sy1 = counted(grun, syncs=True)
            (res0, f0), sec0, la0, sy0 = counted(srun, syncs=True)
            out["engine"] = dict(
                seconds=sec1, launches=_nonzero(la1), host_syncs=sy1,
                epochs=res1.epochs, history=res1.history, final=f1,
                rows_counted=int(res1.state.cnt.sum()),
                one_device=dict(seconds=sec0, launches=_nonzero(la0),
                                host_syncs=sy0, epochs=res0.epochs,
                                final=f0))
            checks["engine_rows"] = out["engine"]["rows_counted"] == c["n"]
            checks["engine_distortion"] = abs(f1 - f0) <= 0.01 * f0
            checks["engine_syncs"] = sy1 == res1.epochs + 1
            del res1, res0, st

            paths = (("f32", index, {}), ("qgroup8", index, {"qgroup": 8}),
                     ("int8", runs["int8"]["index"],
                      {"codec": "int8", "rerank": 0}),
                     ("pq8", runs["pq"]["index"],
                      {"codec": "pq", "rerank": 0}))
            out["ivf"] = {}
            for label, ix, kw in paths:
                sh = ShardedIvf(ix)
                sh.search(Q[:64], nprobe=s["nprobe"], **kw)    # warm-up
                (ids, d2, tel), sec, la, sy = counted(lambda: sh.search(
                    Q, topk=SERVE["topk"], nprobe=s["nprobe"],
                    telemetry=True, **kw), syncs=True)
                want, _ = ivf.search(ix, Q, topk=SERVE["topk"],
                                     nprobe=s["nprobe"], **kw)
                cids, _ = ops.probe_centroids(Q, ix.centroids, s["nprobe"])
                total = int(ix.caps.long()[cids.long()].sum())
                bpr = (4 * ix.dim if "codec" not in kw else
                       ivf.bytes_per_row(ix.codec, ix.dim))
                t = obs_tel.to_dict(tel)
                slots_ok = (
                    t["scanned_rows"] == [total]
                    and t["scanned_rows_max_shard"] == [total]
                    and abs(t["scan_frac"][0] - total / (
                        Q.shape[0] * ix.capacity_rows)) <= 1e-6
                    * t["scan_frac"][0]
                    and abs(t["scanned_bytes"][0] - total * bpr) <= 1e-6
                    * t["scanned_bytes"][0])
                diff = int((ids != want).any(1).sum())
                row = dict(seconds=sec, launches=_nonzero(la),
                           host_syncs=sy, queries=Q.shape[0],
                           queries_differing=diff,
                           recall=si.recall(ids, gt),
                           telemetry={k: t[k] for k in (
                               "scanned_rows", "scanned_rows_max_shard",
                               "scan_frac", "scanned_bytes")},
                           host_scanned_rows=total, slots_ok=slots_ok)
                if "codec" in kw:      # the default rerank, not counted
                    dflt = dict(kw, rerank=None)
                    row["recall_default_rerank"] = si.recall(sh.search(
                        Q, topk=SERVE["topk"], nprobe=s["nprobe"],
                        **dflt)[0], gt)
                    row["one_device_recall_default_rerank"] = si.recall(
                        ivf.search(ix, Q, topk=SERVE["topk"],
                                   nprobe=s["nprobe"], **dflt)[0], gt)
                    checks[f"ivf_{label}_rerank_recall"] = (
                        row["recall_default_rerank"]
                        >= row["one_device_recall_default_rerank"])
                out["ivf"][label] = row
                scan = ("ivf_scan_adc" if "codec" in kw else
                        "ivf_scan_grouped" if "qgroup" in kw else "ivf_scan")
                checks[f"ivf_{label}_launches"] = (
                    la["probe_centroids"] > 0 and la[scan] > 0)
                checks[f"ivf_{label}_ids"] = diff == 0
                checks[f"ivf_{label}_syncs"] = sy == 0
                checks[f"ivf_{label}_slots"] = slots_ok
                del sh
                log(f"sharded (b) ShardedIvf {label}: {json.dumps(row)}")
        finally:
            close_group()
    return checks, out


def sharded_phase(X, r, index, runs, Q, gt):
    """Phase 9: the sharded topology, (a) the R = 4 emulation through the
    kernels and the plain versions, (b) a world-size-1 NCCL group."""
    t_phase = time.perf_counter()
    c, s = SIFT1M, SHARD
    log(f"sharded phase: (a) R={s['R']} emulation n={c['n']} d={c['d']} "
        f"k={c['k']} kappa={c['kappa']} xi={c['xi']} tau={s['tau']} "
        f"iters={s['iters']} batch={BATCH}; cuts: tau {c['tau']} -> "
        f"{s['tau']}, iterations 20 -> {s['iters']}, the probe source "
        f"1 epoch; (b) a world-size-1 NCCL group; ranks that exchange data "
        "run only in the CPU tests")
    truth = sampled_truth(X, c["kappa"], 1000, SEED + 4)
    emu = {}
    for force in (None, "ref"):
        emu[force or "kernel"], init = emulation_pipeline(X, force, truth)
    k_, p_ = emu["kernel"], emu["ref"]
    checks = {
        "emu_build_syncs": k_["build"]["host_syncs"] == 0
        and p_["build"]["host_syncs"] == 0,
        "emu_run_syncs": all(e["run"]["host_syncs"] == e["run"]["epochs"] + 1
                             for e in (k_, p_)),
        "emu_recall": abs(k_["build"]["recall"] - p_["build"]["recall"])
        <= RECALL_TOL,
        "emu_distortion": abs(k_["run"]["final"] - p_["run"]["final"])
        <= 0.01 * p_["run"]["final"],
        "emu_probe_distortion": abs(k_["probe_source"]["final"]
                                    - p_["probe_source"]["final"])
        <= 0.01 * p_["probe_source"]["final"],
        "emu_rows": k_["run"]["rows_counted"] == c["n"],
        "emu_kernel_launches": k_["build"]["launches"].get(
            "refine_merge", 0) > 0 and all(
            k_["probe_source"]["launches"].get(n, 0) > 0
            for n in ("probe_centroids", "gather_score")),
        "emu_plain_launches_none": not any(
            p_[st]["launches"] for st in ("build", "run", "probe_source")),
    }
    gchecks, group = group_phase(X, r, init, index, runs, Q, gt)
    checks.update(gchecks)
    secs = time.perf_counter() - t_phase
    launches = {}
    for part in (k_["build"], k_["run"], k_["probe_source"],
                 group["graph_builder"], group["engine"],
                 *group["ivf"].values()):
        for name, v in part["launches"].items():
            launches[name] = launches.get(name, 0) + v
    log(f"sharded phase checks: {json.dumps(checks)}; kernel launches "
        f"{json.dumps(launches)}; {secs:.1f} s")
    return all(checks.values()), dict(
        seconds=secs, emulation={"kernels": k_, "plain": p_}, group=group,
        launches=launches, checks=checks)


# ---------------------------------------------------------------------------
# phase 10: the analysis layer, the autotune table and the clustering dry run
# ---------------------------------------------------------------------------

DRY_REAL = dict(workload="sift1m", ranks=64)  # (e): one rank's body on the card
DRY_MEM_TOL = 0.10      # card peak vs the meta tally, relative


def autotune_checks(smi):
    """(b): each table entry at its shape, the table's knob against the
    default: ``torch.equal`` outputs and both CUDA-event times."""
    import torch
    from repro_torch.kernels import autotune
    entries = autotune.load_table()
    cases = autotune.sweep_cases(DEV)
    out = []
    for kernel, shape, _, call in cases:
        hit = [e for e in entries if e["kernel"] == kernel
               and e["backend"] == "cuda" and e["shape"] == shape]
        if not hit:
            continue
        knob, default = hit[0]["tile"], autotune.DEFAULT_TILE[kernel]
        same = all(torch.equal(a, b) for a, b in zip(call(knob),
                                                     call(default)))
        t_knob = min(autotune.time_us(call, knob) for _ in range(3))
        t_def = min(autotune.time_us(call, default) for _ in range(3))
        row = dict(kernel=kernel, knob=autotune.KNOBS[kernel], shape=shape,
                   table=knob, default=default, equal=same,
                   us_table=t_knob, us_default=t_def, card=smi)
        log(f"autotune check: {json.dumps(row)}")
        out.append(row)
    covered = {r["kernel"] for r in out}
    return out, covered == set(autotune.SWEEP_TILES) and all(
        r["equal"] for r in out)


def audit_on_card(tmp):
    """(c): the contract audit through an NCCL group of one (sync-debug
    mode "error" inside every audited call)."""
    from repro_torch.analysis import contracts
    from repro_torch.core.comm import Comm
    from repro_torch.launch.mesh import close_group, init_group
    init_group(DEV, rank=0, world_size=1, store_path=f"{tmp}/audit_store")
    try:
        res = contracts.run_audit(device=DEV, comm=Comm())
    finally:
        close_group()
    rows = {r.name: dict(ok=r.ok, syncs=r.syncs, collectives=r.collectives,
                         problems=r.problems) for r in res}
    for name, row in rows.items():
        log(f"audit on card: {name}: {json.dumps(row)}")
    return rows, len(rows) == 9 and all(r["ok"] for r in rows.values())


def dry_brief(rec):
    c = rec.get("collectives", {})
    return dict(
        workload=rec["workload"], mode=rec["mode"],
        cluster_mode=rec["cluster_mode"], ranks=rec["ranks"],
        status=rec["status"], steps=rec.get("steps"),
        per_step_wire_bytes=c.get("per_step_wire_bytes"),
        counts={k: c[k]["count"] for k in ("all-gather", "all-reduce",
                                           "all-to-all") if k in c},
        wire_bytes=c.get("total_wire_bytes"), memory=rec.get("memory"),
        fits_80gb=rec.get("fits_80gb"), roofline=rec.get("roofline"),
        flops_analytic=rec.get("flops_analytic"),
        hbm_bytes_analytic=rec.get("hbm_bytes_analytic"))


def dry_real(smi):
    """(e): one rank's epoch for real on the card at SIFT1M with R = 64,
    dense and sparse, through a RecordingComm: its peak memory against the
    meta tally of the same cell (argument + temporary bytes)."""
    import torch
    from repro_torch.launch import dryrun_cluster as dry
    out = {}
    for mode in ("dense", "sparse"):
        meta = dry.run_cell(DRY_REAL["workload"], mode, DRY_REAL["ranks"])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = dry.run_cell(DRY_REAL["workload"], mode, DRY_REAL["ranks"],
                           device=DEV, generator=torch.Generator(
                               device=DEV).manual_seed(SEED + 30))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        want = meta["memory"]["peak_bytes"]
        row = dict(mode=mode, status=rec["status"], seconds=secs,
                   card_peak_bytes=peak, meta_peak_bytes=want,
                   card_tally_bytes=rec.get("memory", {}).get("peak_bytes"),
                   rel_gap=(peak - want) / want,
                   counts_equal=(rec.get("collectives", {}).get(
                       "total_wire_bytes") == meta["collectives"][
                       "total_wire_bytes"]), card=smi)
        row["ok"] = (rec["status"] == "ok" and row["counts_equal"]
                     and abs(row["rel_gap"]) <= DRY_MEM_TOL)
        log(f"dry run on the card ({DRY_REAL}): {json.dumps(row)}")
        if rec["status"] != "ok":
            log(rec.get("traceback"))
        out[mode] = row
        del rec
    return out, all(r["ok"] for r in out.values())


def analysis_phase(smi):
    """Phase 10: (a) lint against the baseline, (b) the autotune table's
    knobs against the defaults, (c) the contract audit over an NCCL group
    of one, (d) the whole dry run on meta, (e) one rank's body on the
    card against the dry run's memory tally."""
    import tempfile
    from repro_torch.analysis import astlint
    from repro_torch.launch import dryrun_cluster as dry
    t_phase = time.perf_counter()
    secs = {}
    t0 = time.perf_counter()
    findings, problems = astlint.check(str(HERE), log=log)
    secs["lint"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tuned, ok_tune = autotune_checks(smi)
    secs["autotune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        audit, ok_audit = audit_on_card(tmp)
        secs["audit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cells = dry.run_all(out=f"{tmp}/dryrun_cluster.json", quiet=True)
    secs["dryrun"] = time.perf_counter() - t0
    brief = [dry_brief(r) for r in cells]
    for b in brief:
        log(f"dry run cell: {json.dumps(b)}")
    t0 = time.perf_counter()
    real, ok_real = dry_real(smi)
    secs["real_body"] = time.perf_counter() - t0
    checks = {"lint_clean": not findings and not problems,
              "autotune_equal": ok_tune, "audit_nccl": ok_audit,
              "dryrun_cells": len(cells) == 24 and all(
                  r["status"] == "ok" for r in cells),
              "dryrun_real_memory": ok_real}
    secs["phase"] = time.perf_counter() - t_phase
    log(f"analysis phase checks: {json.dumps(checks)}; seconds "
        f"{json.dumps(secs)}")
    return all(checks.values()), dict(
        checks=checks, seconds=secs, autotune=tuned, audit=audit,
        cells=brief, real_body=real, card=smi)


LM = dict(arch="qwen2-72b", n_layers=8, batch=4, prompt_len=1024, gen=32,
          extra=8)                      # (a), (b), (d): depth cut 80 -> 8
LM_CPU = dict(n_layers=2, batch=2, prompt_len=64, steps=4)   # (c)
# (b) decode against prefill: the reference's own limits (tests/
# test_serve.py): max|Δ| / max(max|want|, 1) < 0.15, top-1 agreement >= 0.5
LM_DECODE_TOL, LM_DECODE_TOP1 = 0.15, 0.5
# (c) card against CPU, logits max|Δ| / max|want| <= 0.03: the CPU-test aim
# against the JAX package (tests/test_torch_lm.py), set for bf16 (cuBLAS and
# oneDNN sum the bf16 products in other orders, so activations move by a
# bf16 ulp); the copies run in float32, far inside it.
# Top-1 agrees row for row, but where the CPU's logits at the two argmaxes
# lie within that tolerance of each other (a near-tie, counted).
LM_CPU_TOL = 0.03
# phase 12 (b): a token whose experts differ between decode and prefill in
# some layer is a router near-tie when the smaller of its two K-th/(K+1)-th
# probability margins there is at most MOE_TIE, a quarter of the uniform
# router probability 1/60 (measured first flips: 1e-5 to 1.3e-3, PR 26);
# the MoE inputs must be checked in at least MOE_MIN_CELLS of the (layer,
# pair) cells (measured 0.47, PR 26); each decode MoE output lies within
# MOE_LAYER_TOL of max|want| of its experts run token by token in float32
# (bf16 products and SiLU rounded op for op against float32)
MOE_TIE = 0.25 / 60
MOE_MIN_CELLS = 0.25
MOE_LAYER_TOL = 0.03
HBM_TBS = 3.35          # H100 SXM data sheet, TB/s
BF16_TFLOPS = 989.0     # H100 SXM data sheet, dense bf16
FP32_TFLOPS = 67.0      # H100 SXM data sheet, FP32 outside the tensor cores


def lm_bounds(cfg, batch, prompt_len, gen, frames=None):
    """(decode step bytes bound ms, prefill operations bound ms, step
    bytes) from the model's own parameter inventory (built on ``meta``): a
    step reads every weight but the embedding table once (B of its rows;
    for MoE every expert, as the reference's dispatch does), the valid
    cache positions (mean over the run's steps) and writes one position;
    prefill does two operations per weight and token of the attention,
    MLP and shared-expert matrices (``lm_head`` for the last position
    only), the causal attention's two products and, per MoE layer, the
    dispatch's expert products over all E·C slots (2·3·E·C·D·F) and the
    router's (2·T·D·E, counted at the bf16 rate).  An ssm step also reads
    and writes each layer's SSD state and conv tail (``ssm_cache_bytes``,
    its ``n_kv_heads`` are 0), and its prefill adds the SSD scan's float32
    products (``ssd_ops``) at the FP32 rate, as TF32 is off.  A hybrid
    model's KV lives in its attention layers only, in rings of ``window``
    slots (a step reads the valid ones, at most ``window``); its recurrent
    layers' h and conv tails are read and written each step
    (``hybrid_state_bytes``), and its prefill's attention takes
    min(q + 1, window) keys a query.  Whisper's step reads the decoder's
    weights (not the encoder's, nor the cross k/v projections, which
    prefill applies to the frames once), ``lm_head`` and each layer's
    cross-attention ``xk``/``xv`` whole (``frames`` positions, default
    ``prompt_len`` as ``serve`` ties them); its prefill adds the encoder
    over the frames (its matrices and a full non-causal attention), the
    cross k/v projections of the frames and the decoder's attention over
    them.  A VLM's ``prompt_len`` counts its patches, and its prefill adds
    the patch projection."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.moe import capacity
    meta = Model(cfg, device="meta")
    # a decode step reads neither the embedding table, nor the encoder,
    # nor the patch projection, nor the cross k/v projections (applied to
    # the frames once, in prefill)
    xkv = (".xattn.wk", ".xattn.wv")
    w = sum(p.numel() * p.element_size()
            for n, p in meta.named_parameters()
            if not n.startswith(("embed", "enc_layers.", "patch_proj"))
            and not n.endswith(xkv))
    D, L_ = cfg.d_model, cfg.n_layers
    mean_len = prompt_len + gen / 2
    n_attn, keys = L_, prompt_len ** 2 / 2
    if cfg.family == "hybrid":     # a step reads min(pos + 1, W) slots
        W = cfg.window
        n_attn = (L_ // len(cfg.block_pattern)) \
            * cfg.block_pattern.count("attn")
        mean_len = min(mean_len + 1, W)
        keys = (min(prompt_len, W) * (min(prompt_len, W) + 1) / 2
                + max(prompt_len - W, 0) * W)
    kv_row = 2 * n_attn * batch * cfg.n_kv_heads * cfg.head_dim * 2
    step_bytes = w + batch * D * 2 + kv_row * (mean_len + 1) \
        + batch * cfg.vocab_padded * 4
    dense = sum(p.numel() for n, p in meta.named_parameters()
                if n.startswith(("layers.", "groups.", "tail.",
                                 "dec_layers."))
                and p.dtype == torch.bfloat16 and ".moe.we_" not in n
                and not n.endswith(xkv))
    T = batch * prompt_len
    ops = 2 * dense * T + 2 * D * cfg.vocab_padded * batch \
        + 2 * 2 * batch * cfg.n_heads * cfg.head_dim * keys * n_attn
    if cfg.family == "moe":
        E, K, Fe = cfg.n_experts, cfg.experts_per_token, cfg.moe_d_ff
        C = capacity(T, E, K, cfg.moe_capacity_factor)
        ops += L_ * (2 * 3 * E * C * D * Fe + 2 * T * D * E)
    if cfg.family == "audio":
        F_ = prompt_len if frames is None else frames
        Te = batch * F_
        qk = 2 * 2 * batch * cfg.n_heads * cfg.head_dim

        def count(pick):
            return sum(p.numel() for n, p in meta.named_parameters()
                       if pick(n) and p.dtype == torch.bfloat16)
        ops += 2 * Te * (count(lambda n: n.startswith("enc_layers."))
                         + count(lambda n: n.endswith(xkv))) \
            + qk * (F_ * F_ * cfg.enc_layers + prompt_len * F_ * L_)
        step_bytes += 2 * L_ * batch * F_ * cfg.n_kv_heads * cfg.head_dim * 2
    if cfg.family == "vlm":
        ops += 2 * batch * cfg.n_patches * cfg.frontend_dim * D
    f32_ops = 0
    if cfg.family == "ssm":
        step_bytes += 2 * ssm_cache_bytes(cfg, batch)
        f32_ops = ssd_ops(cfg, batch, prompt_len)
    if cfg.family == "hybrid":
        step_bytes += 2 * hybrid_state_bytes(cfg, batch)
    return (step_bytes / (HBM_TBS * 1e12) * 1e3,
            (ops / BF16_TFLOPS + f32_ops / FP32_TFLOPS) / 1e12 * 1e3,
            step_bytes)


def ssm_cache_bytes(cfg, batch):
    """Bytes of a Mamba-2 cache: each layer's float32 SSD state (B, H, P,
    N) and bf16 conv tail (B, W-1, d_inner), whatever the prompt."""
    return cfg.n_layers * batch * (
        cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        + (cfg.conv_width - 1) * cfg.d_inner * 2)


def hybrid_state_bytes(cfg, batch):
    """Bytes of a hybrid cache's recurrent part: each recurrent layer's
    float32 h (B, lru_width) and bf16 conv tail (B, W-1, lru_width)."""
    n_rec = cfg.n_layers - (cfg.n_layers // len(cfg.block_pattern)) \
        * cfg.block_pattern.count("attn")
    return n_rec * batch * cfg.lru_width * (4 + (cfg.conv_width - 1) * 2)


def cache_bytes(cache):
    """Bytes of every tensor in a cache (nested dicts and tuples)."""
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if isinstance(cache, (tuple, list)):
        return sum(cache_bytes(v) for v in cache)
    return cache.numel() * cache.element_size() if hasattr(
        cache, "numel") else 0


def ssd_ops(cfg, batch, prompt_len):
    """The float32 products of ``ssm.ssd_chunked`` over a prompt, every
    layer: per (padded) chunk of Q the scores C·Bᵀ (2·Q²·N), the diagonal
    term (2·H·Q²·P), the chunk states and the off-diagonal term (2·H·Q·P·N
    each)."""
    Q = min(cfg.ssd_chunk, prompt_len)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    per_chunk = 2 * Q * Q * N + 2 * H * Q * Q * P + 2 * 2 * H * Q * P * N
    return per_chunk * -(-prompt_len // Q) * batch * cfg.n_layers


@contextlib.contextmanager
def routing_log():
    """While open, every ``moe.route`` call (``moe_ffn`` looks it up at
    call time, so these are the routes the layer used) records its input
    (T, D), the expert ids (T, K) and gates (T, K) it returns and the
    margin between each token's K-th and (K+1)-th router probabilities;
    each ``moe.moe_ffn`` call adds its output (T, D) and its expert
    weights to its route's record."""
    from repro_torch.models import moe
    calls, route, ffn = [], moe.route, moe.moe_ffn

    def logged_route(xt, router, top_k):
        probs, gate, idx = route(xt, router, top_k)
        top = probs.topk(top_k + 1, dim=-1).values
        calls.append(dict(x=xt, idx=idx, gate=gate,
                          margin=top[:, top_k - 1] - top[:, top_k]))
        return probs, gate, idx

    def logged_ffn(x, w_gate, w_up, w_down, router, **kw):
        y, aux = ffn(x, w_gate, w_up, w_down, router, **kw)
        calls[-1].update(y=y.reshape(-1, y.shape[-1]),
                         w=(w_gate, w_up, w_down))
        return y, aux
    moe.route, moe.moe_ffn = logged_route, logged_ffn
    try:
        yield calls
    finally:
        moe.route, moe.moe_ffn = route, ffn


def moe_by_token(x, idx, gate, w):
    """The routed experts' output token by token in float32, straight from
    the expert weights (no dispatch buffer, no capacity, ``torch.sigmoid``
    for SiLU): ``Σ_k gate[t, k] · W_down[e](silu(x W_gate[e]) · x
    W_up[e])`` with ``e = idx[t, k]``; x (T, D) -> (T, D)."""
    import torch
    wg, wu, wd = (a[idx].float() for a in w)      # (T, K, D|F, F|D)
    xf = x.float()[:, None, None, :]
    g, u = (xf @ wg).squeeze(2), (xf @ wu).squeeze(2)
    o = ((g * torch.sigmoid(g) * u)[:, :, None, :] @ wd).squeeze(2)
    return (o * gate.float()[..., None]).sum(1)


def _card_and_cpu(card, cpu, toks, n, steps, vocab, stub=None):
    """Prefill then teacher-forced decode steps on both copies, each under
    ``routing_log``: ({"card"|"cpu": logits per call}, seconds, {"card"|
    "cpu": each ``moe_ffn`` call's sorted expert ids and margins}, none
    for a dense model).  ``stub``: Whisper's ``frames`` or the VLM's
    ``patches`` (CPU tensors), given to both prefills; the patches add
    their count to the cache's positions."""
    import torch
    stub = stub or {}
    room = stub["patches"].shape[1] if "patches" in stub else 0
    out, secs, routes = {}, {}, {}
    for name, m in (("card", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        with routing_log() as calls:
            batch = {"tokens": toks[:, :n].to(m.device),
                     **{k: v.to(m.device) for k, v in stub.items()}}
            logits, cache = m.prefill(batch, room + n + steps)
            seq = [logits[:, :vocab].cpu()]
            for i in range(steps):
                logits, cache = m.decode_step(
                    toks[:, n + i: n + i + 1].to(m.device), cache)
                seq.append(logits[:, :vocab].cpu())
        secs[name] = time.perf_counter() - t0
        out[name] = seq
        routes[name] = [dict(idx=r["idx"].sort(-1).values.cpu(),
                             margin=r["margin"].cpu()) for r in calls]
    return out, secs, routes


def _compare(out, routes, label):
    """(max |Δ|/max|want| per call, top-1 agreeing rows, near-tie rows,
    missed rows, tokens routed differently: (call, token, card margin,
    CPU margin)).  Top-1 agrees row for row but where the CPU's logits at
    the two argmaxes lie within ``LM_CPU_TOL`` of each other (a near-tie,
    counted)."""
    import torch
    rels, ties, agree, missed, flips = [], 0, 0, [], []
    for j, (a, b) in enumerate(zip(routes["card"], routes["cpu"])):
        for t in (a["idx"] != b["idx"]).any(-1).nonzero().flatten().tolist():
            flips.append((j, t, float(a["margin"][t]),
                          float(b["margin"][t])))
    for got, want in zip(out["card"], out["cpu"]):
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError(f"{label}: non-finite logits")
        scale = float(want.abs().max())
        rels.append(float((got - want).abs().max()) / scale)
        for row in range(want.shape[0]):
            a, b = int(got[row].argmax()), int(want[row].argmax())
            if a == b:
                agree += 1
            elif float(want[row, b] - want[row, a]) <= LM_CPU_TOL * scale:
                ties += 1
            else:
                missed.append((row, a, b))
    return rels, agree, ties, missed, flips


def lm_card_vs_cpu():
    """(c): a 2-layer full-width copy of the same parameters (the card's
    generator draws the first two layers' weights first), in float32 on
    both, prefill then teacher-forced decode steps on the card and on the
    CPU.  (The bf16 copy, 10.0 s of the CPU's, is cut: the CPU tests hold
    bf16 per layer against the JAX package.)"""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    c = LM_CPU
    cfg = get_config(LM["arch"]).scaled(n_layers=c["n_layers"])
    card = init_params(cfg, torch.Generator(DEV).manual_seed(SEED),
                       DEV).float()
    cpu = Model(cfg, "cpu").float()
    cpu.load_state_dict(card.state_dict())
    n, steps = c["prompt_len"], c["steps"]
    toks = torch.randint(0, cfg.vocab, (c["batch"], n + steps),
                         generator=torch.Generator().manual_seed(SEED + 2),
                         dtype=torch.int32)
    out, secs, routes = _card_and_cpu(card, cpu, toks, n, steps, cfg.vocab)
    del card, cpu
    rels, agree, ties, missed, _ = _compare(out, routes, "lm_serve (c)")
    if missed:
        row, a, b = missed[0]
        raise RuntimeError(f"lm_serve (c): top-1 {a} on the card, {b} on "
                           f"the CPU (row {row})")
    res = dict(layers=c["n_layers"], batch=c["batch"], prompt_len=n,
               decode_steps=steps, dtype="f32", max_rel_err=max(rels),
               rel_errs=rels, top1_agree=agree, top1_near_ties=ties,
               seconds=secs)
    log(f"lm_serve (c) card vs CPU: {json.dumps(res)}")
    if max(rels) > LM_CPU_TOL:
        raise RuntimeError(f"lm_serve (c): card vs CPU {max(rels):.4g} > "
                           f"{LM_CPU_TOL}")
    return res


def lm_serve_phase():
    """Phase 11: the dense LM serving path (``launch.serve.serve``) at
    Qwen2-72B's published widths, depth cut to 8 layers: (a) batch 4,
    prompt 1,024, 32 greedy tokens; (d) the same run again, equal tokens;
    (b) prompt + 8 teacher-forced steps against one prefill of the longer
    sequence; (c) a 2-layer copy on the card against the CPU.  Raises on
    any failed check.  None of the eight kernels may launch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.models import attention as attn
    from repro_torch.models.model import init_params
    c = LM
    cfg = get_config(c["arch"]).scaled(n_layers=c["n_layers"])
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    runs = []
    for _ in range(2):                     # (a), then (d)
        t0 = time.perf_counter()
        toks, stats = serve(cfg, batch=c["batch"], prompt_len=c["prompt_len"],
                            gen=c["gen"], seed=SEED, device=DEV)
        stats["wall_s"] = time.perf_counter() - t0
        runs.append((toks.cpu(), stats))
    peak = torch.cuda.max_memory_allocated()
    launched = {k: n for k, n in _build.launch_counts.items() if n}
    toks, st = runs[0]
    bound_step, bound_prefill, step_bytes = lm_bounds(
        cfg, c["batch"], c["prompt_len"], c["gen"])
    serve_out = dict(
        arch=c["arch"], layers=c["n_layers"], published_layers=80,
        batch=c["batch"], prompt_len=c["prompt_len"], gen=c["gen"],
        prefill_s=st["prefill_s"], decode_s=st["decode_s"],
        tok_per_s=st["tok_per_s"], decode_step_ms=st["decode_step_ms"],
        decode_step_ms_median=statistics.median(st["decode_step_ms"]),
        decode_step_ms_min=min(st["decode_step_ms"]),
        decode_step_bound_ms=bound_step, decode_step_bytes=step_bytes,
        prefill_bound_ms=bound_prefill,
        decode_host_syncs=[s["decode_host_syncs"] for _, s in runs],
        rerun=dict(prefill_s=runs[1][1]["prefill_s"],
                   decode_s=runs[1][1]["decode_s"],
                   tok_per_s=runs[1][1]["tok_per_s"],
                   decode_step_ms_median=statistics.median(
                       runs[1][1]["decode_step_ms"])),
        wall_s=[s["wall_s"] for _, s in runs], max_memory_allocated=peak,
        kernel_launches=launched)
    log(f"lm_serve (a)/(d): {json.dumps(serve_out)}")
    if any(s["decode_host_syncs"] for _, s in runs):
        raise RuntimeError("lm_serve (a): host syncs inside decode_step")
    if not torch.equal(runs[0][0], runs[1][0]):
        raise RuntimeError("lm_serve (d): two greedy runs differ")
    if toks.shape != (c["batch"], c["gen"]) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab:
        raise RuntimeError(f"lm_serve (a): tokens {tuple(toks.shape)} "
                           "out of range")
    if launched:
        raise RuntimeError(f"lm_serve: kernels launched {launched}")
    del runs, toks

    # (b) decode matches prefill, at the same width and depth
    model = init_params(cfg, torch.Generator(DEV).manual_seed(SEED), DEV)
    n, extra = c["prompt_len"], c["extra"]
    full = torch.randint(0, cfg.vocab, (c["batch"], n + extra),
                         generator=torch.Generator(DEV).manual_seed(SEED + 1),
                         dtype=torch.int32, device=DEV)
    want, _ = model.prefill({"tokens": full}, n + extra)
    logits, cache = model.prefill({"tokens": full[:, :n]}, n + extra)
    for i in range(extra):
        logits, cache = model.decode_step(full[:, n + i: n + i + 1], cache)
    logits, want = logits[:, :cfg.vocab], want[:, :cfg.vocab]
    if not (torch.isfinite(logits).all() and torch.isfinite(want).all()):
        raise RuntimeError("lm_serve (b): non-finite logits")
    rel = float((logits - want).abs().max() / max(float(want.abs().max()),
                                                  1.0))
    a, b = logits.argmax(-1), want.argmax(-1)
    top1 = float((a == b).float().mean())
    # where the argmaxes differ: the prefill's logit gap between the two
    # tokens against the largest |Δ| (random weights leave near-ties)
    gaps = [float(want[r, b[r]] - want[r, a[r]])
            for r in range(a.shape[0]) if a[r] != b[r]]
    decode = dict(prompt_len=n, steps=extra, max_rel_err=rel, top1=top1,
                  max_abs_logit=float(want.abs().max()),
                  max_abs_err=float((logits - want).abs().max()),
                  flipped_row_gaps=gaps)
    log(f"lm_serve (b) decode vs prefill: {json.dumps(decode)}")
    if not (rel < LM_DECODE_TOL and top1 >= LM_DECODE_TOP1):
        raise RuntimeError(f"lm_serve (b): decode vs prefill {rel:.4g}, "
                           f"top-1 {top1}")
    _, cache = model.prefill({"tokens": full[:, :n]}, n + extra)
    profile_window("lm decode, 8 steps at full width", lambda: [
        model.decode_step(full[:, n + i: n + i + 1], cache)
        for i in range(extra)])
    # yardstick, not on the path: one layer's prefill attention in the
    # port's flash_attention and in F.scaled_dot_product_attention
    g = torch.Generator(DEV).manual_seed(SEED + 3)
    B, Hq, Hkv, hd = c["batch"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.randn((B, n, H, hd), generator=g, device=DEV,
                           dtype=torch.bfloat16) for H in (Hq, Hkv, Hkv))
    yard = dict(
        flash_attention_ms=time_ms(lambda: attn.flash_attention(
            q, k, v, kv_chunk=cfg.attn_chunk), [()], reps=5),
        sdpa_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True), [()], reps=5))
    log(f"lm_serve attention yardstick (B={B}, S={n}, Hq={Hq}, Hkv={Hkv}, "
        f"hd={hd}, bf16): {json.dumps(yard)}")
    del model, cache, logits, want, q, k, v
    torch.cuda.empty_cache()

    cpu = lm_card_vs_cpu()                 # (c)
    out = dict(serve=serve_out, decode_vs_prefill=decode, card_vs_cpu=cpu,
               attention_yardstick=yard,
               seconds=time.perf_counter() - t_phase)
    log(f"lm_serve phase: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 12
# MoE serving: Qwen1.5-MoE-A2.7B at all 24 layers and the published
# widths, then Grok-1's widths at 2 of 64 layers.

MOE = dict(arch="qwen2-moe-a2.7b", batch=4, prompt_len=1024, gen=32,
           extra=4, decode_cf=64.0)    # (a), (b), (d): (b)'s steps 8 -> 4
MOE_CPU = dict(n_layers=2, batch=2, prompt_len=64, steps=4)   # (c)
GROK = dict(arch="grok-1-314b", n_layers=2, published_layers=64, batch=2,
            prompt_len=256, gen=8)     # (e): depth cut 64 -> 2


def moe_weight_bytes(cfg):
    """(bytes of one routed expert of one layer, bytes of every weight but
    the embedding and the routed experts)."""
    from repro_torch.models import Model
    meta = Model(cfg, device="meta")
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff * 2
    rest = sum(p.numel() * p.element_size()
               for n, p in meta.named_parameters()
               if n != "embed" and ".moe.we_" not in n)
    return per_expert, rest


def moe_card_vs_cpu(cfg):
    """(c): a 2-layer full-width copy at the configured capacity factor,
    in float32 on both, prefill then teacher-forced decode steps on the
    card and on the CPU, held to phase 11's limits (logits within
    ``LM_CPU_TOL`` of max|want|, top-1 equal but at near-ties), and every
    token routed alike (the tokens routed differently are printed with
    their router margins).  (The bf16 copy, 3.8 s of the CPU's, is cut:
    the CPU tests hold bf16 per layer against the JAX package.)"""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    c = MOE_CPU
    cfg = cfg.scaled(n_layers=c["n_layers"])
    card = init_params(cfg, torch.Generator(DEV).manual_seed(SEED),
                       DEV).float()
    cpu = Model(cfg, "cpu").float()
    cpu.load_state_dict(card.state_dict())
    n, steps = c["prompt_len"], c["steps"]
    toks = torch.randint(0, cfg.vocab, (c["batch"], n + steps),
                         generator=torch.Generator().manual_seed(SEED + 2),
                         dtype=torch.int32)
    res = dict(layers=c["n_layers"], batch=c["batch"], prompt_len=n,
               decode_steps=steps, capacity_factor=cfg.moe_capacity_factor)
    out, secs, routes = _card_and_cpu(card, cpu, toks, n, steps, cfg.vocab)
    del card, cpu
    rels, agree, ties, missed, flips = _compare(out, routes, "lm_moe (c)")
    r = res["f32"] = dict(max_rel_err=max(rels), rel_errs=rels,
                          top1_agree=agree, top1_near_ties=ties,
                          top1_missed=missed, routing_calls=len(
                              routes["card"]), routing_flips=flips,
                          seconds=secs)
    log(f"lm_moe (c) card vs CPU: {json.dumps(res)}")
    if r["top1_missed"] or r["max_rel_err"] > LM_CPU_TOL or \
            r["routing_flips"]:
        raise RuntimeError(
            f"lm_moe (c): f32 card vs CPU {r['max_rel_err']:.4g} "
            f"(limit {LM_CPU_TOL}), top-1 missed {r['top1_missed']}, "
            f"tokens routed differently (call, token, card margin, CPU "
            f"margin) {r['routing_flips']}")
    return res


def grok_phase():
    """(e): Grok-1's widths at 2 of 64 layers: ``serve`` twice (equal
    tokens, 0 host syncs), then one prefill and decode step with finite
    logits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import init_params
    c = GROK
    cfg = get_config(c["arch"]).scaled(n_layers=c["n_layers"])
    torch.cuda.reset_peak_memory_stats()
    runs = [serve(cfg, batch=c["batch"], prompt_len=c["prompt_len"],
                  gen=c["gen"], seed=SEED, device=DEV) for _ in range(2)]
    model = init_params(cfg, torch.Generator(DEV).manual_seed(SEED), DEV)
    toks = runs[0][0]
    prompt = torch.randint(0, cfg.vocab, (c["batch"], c["prompt_len"]),
                           generator=torch.Generator(DEV).manual_seed(SEED),
                           dtype=torch.int32, device=DEV)
    logits, cache = model.prefill({"tokens": prompt}, c["prompt_len"] + 1)
    step, _ = model.decode_step(toks[:, :1], cache)
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(step).all())
    peak = torch.cuda.max_memory_allocated()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    del model, cache
    st = runs[0][1]
    bound_step, bound_prefill, step_bytes = lm_bounds(
        cfg, c["batch"], c["prompt_len"], c["gen"])
    res = dict(arch=c["arch"], layers=c["n_layers"],
               published_layers=c["published_layers"], batch=c["batch"],
               prompt_len=c["prompt_len"], gen=c["gen"],
               weight_bytes=weights, prefill_s=st["prefill_s"],
               tok_per_s=st["tok_per_s"],
               decode_step_ms=st["decode_step_ms"],
               decode_step_ms_median=statistics.median(st["decode_step_ms"]),
               decode_step_bound_ms=bound_step, decode_step_bytes=step_bytes,
               prefill_bound_ms=bound_prefill,
               rerun_decode_step_ms_median=statistics.median(
                   runs[1][1]["decode_step_ms"]),
               decode_host_syncs=[r[1]["decode_host_syncs"] for r in runs],
               tokens_equal=bool(torch.equal(runs[0][0], runs[1][0])),
               finite_logits=finite, max_memory_allocated=peak)
    log(f"lm_moe (e) Grok-1 widths: {json.dumps(res)}")
    if any(res["decode_host_syncs"]) or not res["tokens_equal"] \
            or not finite:
        raise RuntimeError(f"lm_moe (e): syncs {res['decode_host_syncs']}, "
                           f"equal {res['tokens_equal']}, finite {finite}")
    return res


def lm_moe_phase():
    """Phase 12: MoE serving (``launch.serve.serve``) at Qwen1.5-MoE-A2.7B's
    published widths and all 24 layers: (a) batch 4, prompt 1,024, 32
    greedy tokens; (d) the same run again, equal tokens; (b) prompt + 8
    teacher-forced steps against one prefill of the longer sequence at
    capacity factor 64, with the experts the steps route to; (c) a 2-layer
    copy on the card against the CPU; (e) Grok-1's widths at 2 layers.
    Raises on any failed check.  None of the eight kernels may launch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import init_params
    c = MOE
    cfg = get_config(c["arch"])
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    runs = []
    for _ in range(2):                     # (a), then (d)
        t0 = time.perf_counter()
        toks, stats = serve(cfg, batch=c["batch"], prompt_len=c["prompt_len"],
                            gen=c["gen"], seed=SEED, device=DEV)
        stats["wall_s"] = time.perf_counter() - t0
        runs.append((toks.cpu(), stats))
    peak = torch.cuda.max_memory_allocated()
    toks, st = runs[0]
    bound_step, bound_prefill, step_bytes = lm_bounds(
        cfg, c["batch"], c["prompt_len"], c["gen"])
    per_expert, rest = moe_weight_bytes(cfg)
    cap = min(cfg.n_experts, c["batch"] * cfg.experts_per_token)
    serve_out = dict(
        arch=c["arch"], layers=cfg.n_layers, batch=c["batch"],
        prompt_len=c["prompt_len"], gen=c["gen"],
        prefill_s=st["prefill_s"], decode_s=st["decode_s"],
        tok_per_s=st["tok_per_s"], decode_step_ms=st["decode_step_ms"],
        decode_step_ms_median=statistics.median(st["decode_step_ms"]),
        decode_step_ms_min=min(st["decode_step_ms"]),
        decode_step_bound_ms=bound_step, decode_step_bytes=step_bytes,
        routed_bytes_cap=rest + cfg.n_layers * cap * per_expert,
        prefill_bound_ms=bound_prefill,
        decode_host_syncs=[s["decode_host_syncs"] for _, s in runs],
        rerun=dict(prefill_s=runs[1][1]["prefill_s"],
                   decode_s=runs[1][1]["decode_s"],
                   tok_per_s=runs[1][1]["tok_per_s"],
                   decode_step_ms_median=statistics.median(
                       runs[1][1]["decode_step_ms"])),
        wall_s=[s["wall_s"] for _, s in runs], max_memory_allocated=peak)
    log(f"lm_moe (a)/(d): {json.dumps(serve_out)}")
    if any(s["decode_host_syncs"] for _, s in runs):
        raise RuntimeError("lm_moe (a): host syncs inside decode_step")
    if not torch.equal(runs[0][0], runs[1][0]):
        raise RuntimeError("lm_moe (d): two greedy runs differ")
    if toks.shape != (c["batch"], c["gen"]) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab:
        raise RuntimeError(f"lm_moe (a): tokens {tuple(toks.shape)} "
                           "out of range")
    if peak > torch.cuda.get_device_properties(DEV).total_memory:
        raise RuntimeError(f"lm_moe (a): peak {peak} bytes")
    del runs, toks

    # (b) decode matches prefill at capacity factor 64, all 24 layers.
    # After step i the reference is ``prefill`` of the prompt and the i + 1
    # forced tokens.  Per step and row: each layer's MoE input against that
    # prefill's at the same position, up to and including the first layer
    # where the token's experts differ (a router near-tie flipped by the
    # two paths' bf16 sums: from there on the token's activations part);
    # the logits where no layer differs, or where the first difference is
    # not a near-tie (``MOE_TIE``); every decode layer's MoE output against
    # its experts token by token (``moe_by_token``).  The steps' routing
    # gives the bytes a step routes to.
    cfg64 = cfg.scaled(moe_capacity_factor=c["decode_cf"])
    model = init_params(cfg64, torch.Generator(DEV).manual_seed(SEED), DEV)
    n, extra, L_, B = c["prompt_len"], c["extra"], cfg.n_layers, c["batch"]
    full = torch.randint(0, cfg.vocab, (B, n + extra),
                         generator=torch.Generator(DEV).manual_seed(SEED + 1),
                         dtype=torch.int32, device=DEV)
    wants, pre = [], []
    for i in range(extra):
        S = n + i + 1
        with routing_log() as calls:
            logits, _ = model.prefill({"tokens": full[:, :S]}, S)
        wants.append(logits[:, :cfg.vocab])
        # the last position of each row, layer by layer
        pre.append([{k: r[k].reshape(B, S, *r[k].shape[1:])[:, -1].clone()
                     for k in ("x", "idx", "margin")} for r in calls])
        del calls
    _, cache = model.prefill({"tokens": full[:, :n]}, n + extra)
    steps = []
    with routing_log() as dcalls:
        for i in range(extra):
            logits, cache = model.decode_step(full[:, n + i: n + i + 1],
                                              cache)
            steps.append(logits[:, :cfg.vocab])
    distinct = [int(torch.zeros(cfg.n_experts, device=DEV).index_fill_(
        0, r["idx"].flatten(), 1.0).sum()) for r in dcalls]
    routed = rest + sum(distinct) / extra * per_expert

    def rel_err(got, want):                # the reference test's measure
        return float((got.float() - want.float()).abs().max()) / max(
            float(want.float().abs().max()), 1.0)
    layer_errs = []                        # decode MoE vs token by token
    for r in dcalls:
        want = moe_by_token(r["x"], r["idx"], r["gate"], r["w"])
        layer_errs.append(float((r["y"].float() - want).abs().max())
                          / float(want.abs().max()))
    pairs, flips, act, cells = [], [], [0.0] * L_, 0
    for i, (got, want) in enumerate(zip(steps, wants)):
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError("lm_moe (b): non-finite logits")
        for r in range(B):
            first = None
            for layer in range(L_):
                d, p_ = dcalls[i * L_ + layer], pre[i][layer]
                act[layer] = max(act[layer], rel_err(d["x"][r], p_["x"][r]))
                cells += 1
                if not torch.equal(d["idx"][r].sort().values,
                                   p_["idx"][r].sort().values):
                    dm, pm = float(d["margin"][r]), float(p_["margin"][r])
                    first = dict(step=i, row=r, layer=layer,
                                 decode_margin=dm, prefill_margin=pm,
                                 near_tie=min(dm, pm) <= MOE_TIE)
                    flips.append(first)
                    break
            pairs.append(dict(held=first is None or not first["near_tie"],
                              rel=rel_err(got[r], want[r]),
                              top1=int(got[r].argmax()) == int(
                                  want[r].argmax())))
    del pre, dcalls, wants
    held = [p for p in pairs if p["held"]]
    rel = max((p["rel"] for p in held), default=0.0)
    top1 = (sum(p["top1"] for p in held) / len(held)) if held else None
    min_cells = int(MOE_MIN_CELLS * len(pairs) * L_)
    decode = dict(
        prompt_len=n, steps=extra, capacity_factor=c["decode_cf"],
        pairs=len(pairs), pairs_routed_alike=len(pairs) - len(flips),
        pairs_logits_held=len(held), max_rel_err=rel, top1=top1,
        moe_input_cells=cells, moe_input_cells_min=min_cells,
        moe_input_max_rel_err=max(act), moe_input_max_rel_err_by_layer=act,
        near_tie_margin=MOE_TIE, first_flips=flips,
        moe_output_vs_by_token=dict(max_rel_err=max(layer_errs),
                                    calls=len(layer_errs),
                                    limit=MOE_LAYER_TOL),
        all_pairs=dict(max_rel_err=max(p["rel"] for p in pairs),
                       top1=sum(p["top1"] for p in pairs) / len(pairs)),
        distinct_experts_per_layer_step=dict(
            mean=sum(distinct) / len(distinct), min=min(distinct),
            max=max(distinct), cap=cap),
        routed_bytes=routed)
    log(f"lm_moe (b) decode vs prefill: {json.dumps(decode)}")
    if not (max(act) < LM_DECODE_TOL and rel < LM_DECODE_TOL
            and (top1 is None or top1 >= LM_DECODE_TOP1)
            and cells >= min_cells and max(layer_errs) <= MOE_LAYER_TOL):
        raise RuntimeError(
            f"lm_moe (b): decode vs prefill: MoE inputs {max(act):.4g} over "
            f"{cells} (layer, pair) cells (at least {min_cells}), logits "
            f"{rel:.4g}, top-1 {top1} over {len(held)} of {len(pairs)} "
            f"pairs, MoE outputs vs token by token {max(layer_errs):.4g} "
            f"(limit {MOE_LAYER_TOL})")
    serve_out["routed_bytes"] = routed
    _, cache = model.prefill({"tokens": full[:, :n]}, n + extra)
    profile_window(f"lm moe decode, {extra} steps, {cfg.n_layers} layers",
                   lambda: [model.decode_step(full[:, n + i: n + i + 1],
                                              cache) for i in range(extra)])
    del model, cache, logits, steps
    torch.cuda.empty_cache()

    cpu = moe_card_vs_cpu(cfg)             # (c)
    torch.cuda.empty_cache()
    grok = grok_phase()                    # (e)
    launched = {k: n for k, n in _build.launch_counts.items() if n}
    if launched:
        raise RuntimeError(f"lm_moe: kernels launched {launched}")
    out = dict(serve=serve_out, decode_vs_prefill=decode, card_vs_cpu=cpu,
               grok=grok, kernel_launches=launched,
               seconds=time.perf_counter() - t_phase)
    log(f"lm_moe phase: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 13
# Mamba-2 serving: Mamba2-2.7B at its published widths, depth cut 64 -> 32
# -> 16 layers to fit the script's time.

SSM = dict(arch="mamba2-2.7b", n_layers=16, published_layers=64, batch=4,
           prompt_len=1024, gen=32, extra=8)    # (a), (b), (d)
SSM_CPU = dict(n_layers=2, batch=2, prompt_len=200, steps=4)   # (c): pads
SSM_LONG = dict(batch=1, gen=8)         # (e), at SHAPES["prefill_32k"]'s S
# (b) in float32, layer by layer: each layer's decode outputs, final SSD
# state and conv tail within SSM_F32_TOL of max|want| (the chunked scan
# against the stepwise recurrence on the same inputs, float32, TF32 off)
SSM_F32_TOL = 1e-3
# the cuBLAS/CUTLASS matmul kernels of a trace, by name
MATMUL_MARKERS = ("gemm", "gemv", "nvjet", "cutlass", "xmma")


def ssm_card_vs_cpu(cfg):
    """(c): a 2-layer full-width copy at batch 2, prompt 200 (chunk 128:
    the padding path) and 4 teacher-forced steps on the card and on the
    CPU, in bf16 as served and then both copies in float32, each held to
    phase 11's limits (logits within ``LM_CPU_TOL`` of max|want|, top-1
    equal but at near-ties)."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    c = SSM_CPU
    cfg = cfg.scaled(n_layers=c["n_layers"])
    card = init_params(cfg, torch.Generator(DEV).manual_seed(SEED), DEV)
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    n, steps = c["prompt_len"], c["steps"]
    toks = torch.randint(0, cfg.vocab, (c["batch"], n + steps),
                         generator=torch.Generator().manual_seed(SEED + 2),
                         dtype=torch.int32)
    res = dict(layers=c["n_layers"], batch=c["batch"], prompt_len=n,
               decode_steps=steps, chunk=cfg.ssd_chunk)
    for dtype in ("bf16", "f32"):
        if dtype == "f32":
            card.float(), cpu.float()
        out, secs, routes = _card_and_cpu(card, cpu, toks, n, steps,
                                          cfg.vocab)
        rels, agree, ties, missed, _ = _compare(out, routes, "lm_ssm (c)")
        res[dtype] = dict(max_rel_err=max(rels), rel_errs=rels,
                          top1_agree=agree, top1_near_ties=ties,
                          top1_missed=missed, seconds=secs)
    log(f"lm_ssm (c) card vs CPU: {json.dumps(res)}")
    for dtype in ("bf16", "f32"):
        r = res[dtype]
        if r["top1_missed"] or r["max_rel_err"] > LM_CPU_TOL:
            raise RuntimeError(
                f"lm_ssm (c): {dtype} card vs CPU {r['max_rel_err']:.4g} "
                f"(limit {LM_CPU_TOL}), top-1 missed {r['top1_missed']}")
    return res


@contextlib.contextmanager
def ssm_layer_log():
    """While open, every ``model._mamba_block_seq`` call (``Model.prefill``
    looks it up at call time) records the layer, its input x and its
    output hidden state."""
    from repro_torch.models import model as model_lib
    calls, real = [], model_lib._mamba_block_seq

    def logged(lp, x, cfg):
        out = real(lp, x, cfg)
        calls.append((lp, x, out[0]))
        return out
    model_lib._mamba_block_seq = logged
    try:
        yield calls
    finally:
        model_lib._mamba_block_seq = real


def _rel(got, want):
    """max|Δ| over max|want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def ssm_decode_vs_prefill(model, full, n, extra):
    """(b) on ``model`` (bf16 or float32), against one prefill of the
    longer sequence (``want``):

    - end to end: the prompt's prefill and ``extra`` teacher-forced steps:
      the logits (the reference test's measure, max|Δ| / max|want|, top-1)
      and each layer's final SSD state and conv tail (max|Δ| over that
      layer's max|want|);
    - the same sequence prefilled at half the SSD chunk (the same
      function summed in another order), on the same measures;
    - layer by layer on ``want``'s own layer inputs: each layer's prefill
      of the prompt then ``extra`` ``_mamba_block_step``s against that
      layer's output at those positions, its final state and conv tail.
    """
    import torch
    from repro_torch.models import model as model_lib
    cfg, vocab = model.cfg, model.cfg.vocab
    with ssm_layer_log() as calls:
        want, wcache = model.prefill({"tokens": full}, n + extra)
    logits, cache = model.prefill({"tokens": full[:, :n]}, n + extra)
    for i in range(extra):
        logits, cache = model.decode_step(full[:, n + i: n + i + 1], cache)
    model.cfg = cfg.scaled(ssd_chunk=cfg.ssd_chunk // 2)
    try:
        half, hcache = model.prefill({"tokens": full}, n + extra)
    finally:
        model.cfg = cfg
    logits, want, half = (t[:, :vocab] for t in (logits, want, half))
    if not all(bool(torch.isfinite(t).all()) for t in (logits, want, half)):
        raise RuntimeError("lm_ssm (b): non-finite logits")

    def end_to_end(got, gcache):
        err = float((got - want).abs().max())
        a, b = got.argmax(-1), want.argmax(-1)
        by = {key: [_rel(g, w) for g, w in zip(gcache[key], wcache[key])]
              for key in ("state", "conv")}
        return dict(
            max_rel_err=err / max(float(want.abs().max()), 1.0),
            rel_to_max=err / float(want.abs().max()),
            top1=float((a == b).float().mean()), max_abs_err=err,
            flipped_row_gaps=[float(want[r, b[r]] - want[r, a[r]])
                              for r in range(a.shape[0]) if a[r] != b[r]],
            state_rel_by_layer=by["state"], conv_rel_by_layer=by["conv"],
            state_max_rel=max(by["state"]), conv_max_rel=max(by["conv"]))
    layers = []
    for i, (lp, x, y) in enumerate(calls):
        _, (state, tail) = model_lib._mamba_block_seq(lp, x[:, :n], cfg)
        outs = [model_lib._mamba_block_step(lp, x[:, n + j: n + j + 1],
                                            state, tail, cfg)
                for j in range(extra)]
        layers.append(dict(out=_rel(torch.cat(outs, 1), y[:, n:]),
                           state=_rel(state, wcache["state"][i]),
                           conv=_rel(tail, wcache["conv"][i])))
    del calls
    worst = {key: max(r[key] for r in layers)
             for key in ("out", "state", "conv")}
    return dict(max_abs_logit=float(want.abs().max()), len=cache["len"],
                end_to_end=end_to_end(logits, cache),
                half_chunk_prefill=end_to_end(half, hcache),
                by_layer=layers, by_layer_max=worst)


def ssm_matmul_rate(prof, cfg, steps):
    """The decode trace's matmul kernels (``MATMUL_MARKERS``): their device
    ms a step, share of busy time and the TB/s at which they read the
    projections and ``lm_head`` (bf16 weights, once a step)."""
    if prof is None:
        return None
    us = sum(t for name, (t, _) in prof["by_name"].items()
             if any(m in name for m in MATMUL_MARKERS))
    w = cfg.n_layers * 2 * cfg.d_model * (
        3 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads) \
        + 2 * cfg.d_model * cfg.vocab_padded
    return dict(ms_per_step=us / 1e3 / steps,
                share_of_busy=us / 1e6 / prof["busy_s"],
                weight_bytes=w,
                tbs=w * steps / (us / 1e6) / 1e12 if us else None)


def lm_ssm_phase():
    """Phase 13: Mamba-2 serving (``launch.serve.serve``) at Mamba2-2.7B's
    published widths and 16 of its 64 layers: (a) batch 4, prompt 1,024, 32
    greedy tokens; (d) the same run again, equal tokens; (e) batch 1 at a
    32,768-token prompt, 8 tokens; (b) prompt + 8 teacher-forced steps
    against one prefill of the longer sequence, in bf16 and in a float32
    copy of the same weights, end to end and layer by layer
    (``ssm_decode_vs_prefill``); (c) a 2-layer copy on the card against
    the CPU.  Raises on any failed check.  None of the eight kernels may
    launch."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import init_params
    c = SSM
    cfg = get_config(c["arch"]).scaled(n_layers=c["n_layers"])
    n_long = SHAPES["prefill_32k"].seq_len
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    runs = []
    for _ in range(2):                     # (a), then (d)
        t0 = time.perf_counter()
        toks, stats = serve(cfg, batch=c["batch"], prompt_len=c["prompt_len"],
                            gen=c["gen"], seed=SEED, device=DEV)
        stats["wall_s"] = time.perf_counter() - t0
        runs.append((toks.cpu(), stats))
    peak = torch.cuda.max_memory_allocated()
    toks, st = runs[0]
    bound_step, bound_prefill, step_bytes = lm_bounds(
        cfg, c["batch"], c["prompt_len"], c["gen"])
    serve_out = dict(
        arch=c["arch"], layers=cfg.n_layers,
        published_layers=c["published_layers"], batch=c["batch"],
        prompt_len=c["prompt_len"], gen=c["gen"],
        prefill_s=st["prefill_s"], decode_s=st["decode_s"],
        tok_per_s=st["tok_per_s"], decode_step_ms=st["decode_step_ms"],
        decode_step_ms_median=statistics.median(st["decode_step_ms"]),
        decode_step_ms_min=min(st["decode_step_ms"]),
        decode_step_bound_ms=bound_step, decode_step_bytes=step_bytes,
        cache_bytes=ssm_cache_bytes(cfg, c["batch"]),
        prefill_bound_ms=bound_prefill,
        prefill_ssd_f32_ops=ssd_ops(cfg, c["batch"], c["prompt_len"]),
        decode_host_syncs=[s["decode_host_syncs"] for _, s in runs],
        rerun=dict(prefill_s=runs[1][1]["prefill_s"],
                   decode_s=runs[1][1]["decode_s"],
                   tok_per_s=runs[1][1]["tok_per_s"],
                   decode_step_ms_median=statistics.median(
                       runs[1][1]["decode_step_ms"])),
        wall_s=[s["wall_s"] for _, s in runs], max_memory_allocated=peak)
    log(f"lm_ssm (a)/(d): {json.dumps(serve_out)}")
    if any(s["decode_host_syncs"] for _, s in runs):
        raise RuntimeError("lm_ssm (a): host syncs inside decode_step")
    if not torch.equal(runs[0][0], runs[1][0]):
        raise RuntimeError("lm_ssm (d): two greedy runs differ")
    if toks.shape != (c["batch"], c["gen"]) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab:
        raise RuntimeError(f"lm_ssm (a): tokens {tuple(toks.shape)} "
                           "out of range")
    del runs, toks
    torch.cuda.empty_cache()

    # (e) long context: batch 1 at prefill_32k's length
    e = SSM_LONG
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ltoks, lst = serve(cfg, batch=e["batch"], prompt_len=n_long, gen=e["gen"],
                       seed=SEED, device=DEV)
    lbound_step, lbound_prefill, lstep_bytes = lm_bounds(
        cfg, e["batch"], n_long, e["gen"])
    long_out = dict(
        batch=e["batch"], prompt_len=n_long, gen=e["gen"],
        prefill_s=lst["prefill_s"], prefill_bound_ms=lbound_prefill,
        decode_step_ms=lst["decode_step_ms"],
        decode_step_ms_median=statistics.median(lst["decode_step_ms"]),
        decode_step_bound_ms=lbound_step, decode_step_bytes=lstep_bytes,
        batch4_prompt1024_step_ms_median=serve_out["decode_step_ms_median"],
        tok_per_s=lst["tok_per_s"], decode_host_syncs=lst["decode_host_syncs"],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        wall_s=time.perf_counter() - t0)
    del ltoks
    torch.cuda.empty_cache()

    # (b) decode matches prefill, full width and depth, bf16 then float32;
    # between them the long prompt's logits and cache on the same weights
    # and a trace of 8 decode steps
    model = init_params(cfg, torch.Generator(DEV).manual_seed(SEED), DEV)
    n, extra = c["prompt_len"], c["extra"]
    full = torch.randint(0, cfg.vocab, (c["batch"], n + extra),
                         generator=torch.Generator(DEV).manual_seed(SEED + 1),
                         dtype=torch.int32, device=DEV)
    decode = dict(prompt_len=n, steps=extra,
                  bf16=ssm_decode_vs_prefill(model, full, n, extra))
    log(f"lm_ssm (b) decode vs prefill, bf16: {json.dumps(decode['bf16'])}")
    torch.cuda.empty_cache()

    long = torch.randint(0, cfg.vocab, (e["batch"], n_long + 1),
                         generator=torch.Generator(DEV).manual_seed(SEED + 4),
                         dtype=torch.int32, device=DEV)
    logits, lcache = model.prefill({"tokens": long[:, :n_long]}, n_long + 1)
    step, lcache = model.decode_step(long[:, n_long:], lcache)
    _, scache = model.prefill({"tokens": full[:1, :n]}, n + 1)
    long_out["finite_logits"] = bool(torch.isfinite(logits).all()
                                     and torch.isfinite(step).all())
    long_out["cache_bytes"] = {
        f"prompt_{k}": {key: cache[key].numel() * cache[key].element_size()
                        for key in ("state", "conv")}
        for k, cache in ((n_long, lcache), (n, scache))}
    long_out["cache_same_size"] = all(
        lcache[key].shape == scache[key].shape
        and lcache[key].dtype == scache[key].dtype
        for key in ("state", "conv"))
    log(f"lm_ssm (e) long context: {json.dumps(long_out)}")
    del logits, step, lcache, scache, long
    if lst["decode_host_syncs"] or not long_out["finite_logits"] \
            or not long_out["cache_same_size"]:
        raise RuntimeError(
            f"lm_ssm (e): syncs {lst['decode_host_syncs']}, finite "
            f"{long_out['finite_logits']}, cache sizes "
            f"{long_out['cache_bytes']}")

    _, cache = model.prefill({"tokens": full[:, :n]}, n + extra)
    prof = profile_window(
        f"lm ssm decode, {extra} steps, {cfg.n_layers} layers",
        lambda: [model.decode_step(full[:, n + i: n + i + 1], cache)
                 for i in range(extra)])
    trace = None if prof is None else dict(
        wall_s=prof["wall_s"], busy_s=prof["busy_s"], idle=prof["idle"],
        activities_per_step=prof["activities"] / extra,
        busy_ms_per_step=prof["busy_s"] * 1e3 / extra,
        matmuls=ssm_matmul_rate(prof, cfg, extra))
    log(f"lm_ssm decode trace: {json.dumps(trace)}")
    del cache
    model.float()
    decode["f32"] = ssm_decode_vs_prefill(model, full, n, extra)
    decode["limits"] = dict(bf16_by_layer=LM_DECODE_TOL,
                            f32_by_layer=SSM_F32_TOL,
                            f32_end_to_end_logits=LM_DECODE_TOL,
                            f32_end_to_end_top1=LM_DECODE_TOP1)
    log(f"lm_ssm (b) decode vs prefill, float32: {json.dumps(decode['f32'])}")
    del model, full
    torch.cuda.empty_cache()
    # Held: every layer's decode against the prefill on the same layer
    # inputs (bf16 at the reference test's 0.15, float32 at SSM_F32_TOL),
    # and the float32 logits end to end at the reference test's limits.
    # Reported, not held: the end-to-end states and the bf16 logits.  The
    # random-weight stack amplifies a rounding difference about 10^4 times
    # over 64 layers, as the half-chunk prefill of the same sequence shows.
    b16, f32 = decode["bf16"], decode["f32"]
    f32e = f32["end_to_end"]
    if not (max(b16["by_layer_max"].values()) < LM_DECODE_TOL
            and max(f32["by_layer_max"].values()) <= SSM_F32_TOL
            and f32e["max_rel_err"] < LM_DECODE_TOL
            and f32e["top1"] >= LM_DECODE_TOP1):
        raise RuntimeError(
            f"lm_ssm (b): decode vs prefill by layer: bf16 "
            f"{b16['by_layer_max']} (limit {LM_DECODE_TOL}), float32 "
            f"{f32['by_layer_max']} (limit {SSM_F32_TOL}); float32 logits "
            f"end to end {f32e['max_rel_err']:.4g}, top-1 {f32e['top1']}")

    cpu = ssm_card_vs_cpu(cfg)             # (c)
    torch.cuda.empty_cache()
    launched = {k: n for k, n in _build.launch_counts.items() if n}
    if launched:
        raise RuntimeError(f"lm_ssm: kernels launched {launched}")
    out = dict(serve=serve_out, long_context=long_out,
               decode_vs_prefill=decode, card_vs_cpu=cpu, trace=trace,
               kernel_launches=launched,
               seconds=time.perf_counter() - t_phase)
    log(f"lm_ssm phase: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 14
# RecurrentGemma serving: RecurrentGemma-9B at its published widths, depth
# cut 38 -> 20 -> 11 layers (3 (rec, rec, attn) groups and the tail of two
# recurrent layers) to fit the script's time.

HYB = dict(arch="recurrentgemma-9b", n_layers=11, published_layers=38,
           batch=4, prompt_len=1024, gen=32,
           trace_steps=8)               # (a), (d): depth cut 38 -> 11
HYB_WRAP = dict(batch=2, prompt_len=2040, extra=16)   # (b): crosses 2,048
HYB_CPU = dict(n_layers=4, window=64, batch=2, prompt_len=200,
               steps=4)                 # (c): one group and a tail layer
HYB_LONG = dict(batch=1, prompt_len=8192, gen=8)      # (e): 4x the window


@contextlib.contextmanager
def hybrid_layer_log():
    """While open, every ``model._rec_block_seq`` and
    ``model._dense_block_seq`` call (``Model.prefill`` looks them up at call
    time) records its block, input x and output (for a recurrent block also
    its final h and conv tail, for an attention block its k and v)."""
    from repro_torch.models import model as model_lib
    calls = []
    real_rec, real_dense = model_lib._rec_block_seq, model_lib._dense_block_seq

    def rec(lp, x, cfg):
        out = real_rec(lp, x, cfg)
        calls.append(("rec", lp, x, out[0], out[1]))
        return out

    def dense(lp, x, cfg, positions, **kw):
        out = real_dense(lp, x, cfg, positions, **kw)
        calls.append(("attn", lp, x, out[0], out[1]))
        return out
    model_lib._rec_block_seq, model_lib._dense_block_seq = rec, dense
    try:
        yield calls
    finally:
        model_lib._rec_block_seq = real_rec
        model_lib._dense_block_seq = real_dense


def hybrid_decode_vs_prefill(model, full, n, extra):
    """(b) on ``model`` (bf16 or float32): the prompt's prefill (n tokens)
    and ``extra`` teacher-forced steps against one prefill of the longer
    sequence (``want``), end to end (logits: max|Δ| / max(max|want|, 1),
    top-1; every layer's h, conv tail and k/v ring: max|Δ| over that
    layer's max|want|), and layer by layer on ``want``'s own layer inputs:
    each layer's prefill of the prompt then ``extra`` decode steps against
    that layer's output at those positions, its final h and conv tail or
    its ring (``_ring_init`` of the long prefill's k and v)."""
    import torch
    from repro_torch.models import model as model_lib
    cfg, vocab, W = model.cfg, model.cfg.vocab, model.cfg.window
    with hybrid_layer_log() as calls:
        want, wcache = model.prefill({"tokens": full}, n + extra)
    logits, cache = model.prefill({"tokens": full[:, :n]}, n + extra)
    for i in range(extra):
        logits, cache = model.decode_step(full[:, n + i: n + i + 1], cache)
    logits, want = logits[:, :vocab], want[:, :vocab]
    if not (torch.isfinite(logits).all() and torch.isfinite(want).all()):
        raise RuntimeError("lm_hybrid (b): non-finite logits")
    err = float((logits - want).abs().max())
    a, b = logits.argmax(-1), want.argmax(-1)
    states = {}
    for key, pair in list(cache["groups"].items()) + [("tail",
                                                        cache["tail"])]:
        wpair = wcache["tail"] if key == "tail" else wcache["groups"][key]
        rec = key == "tail" or cfg.block_pattern[int(key[1:])] == "rec"
        for part, g, w in zip(("h", "conv") if rec else ("k", "v"), pair,
                              wpair):
            states[f"{key}.{part}"] = [_rel(a, b) for a, b in zip(g, w)]
    end_to_end = dict(
        max_rel_err=err / max(float(want.abs().max()), 1.0),
        rel_to_max=err / float(want.abs().max()), max_abs_err=err,
        top1=float((a == b).float().mean()),
        flipped_row_gaps=[float(want[r, b[r]] - want[r, a[r]])
                          for r in range(a.shape[0]) if a[r] != b[r]],
        state_max_rel={k: max(v) for k, v in states.items()})
    positions = torch.arange(n, device=full.device)
    layers = []
    for kind, lp, x, y, st in calls:
        if kind == "rec":
            _, (h, tail) = model_lib._rec_block_seq(lp, x[:, :n], cfg)
            outs = [model_lib._rec_block_step(lp, x[:, n + j: n + j + 1], h,
                                              tail, cfg)
                    for j in range(extra)]
            got, wst = (h, tail), st
        else:
            _, (k, v), _ = model_lib._dense_block_seq(
                lp, x[:, :n], cfg, positions, window=W)
            kc, vc = (model_lib._ring_init(t, W) for t in (k, v))
            outs = [model_lib._attn_block_step(lp, x[:, n + j: n + j + 1],
                                               kc, vc, n + j, cfg)
                    for j in range(extra)]
            got, wst = (kc, vc), tuple(model_lib._ring_init(t, W)
                                       for t in st)
        layers.append(dict(kind=kind,
                           out=_rel(torch.cat(outs, 1), y[:, n:]),
                           state=[_rel(g, w) for g, w in zip(got, wst)]))
    del calls
    worst = dict(out=max(r["out"] for r in layers),
                 state=max(max(r["state"]) for r in layers))
    return dict(max_abs_logit=float(want.abs().max()), len=cache["len"],
                end_to_end=end_to_end, by_layer=layers, by_layer_max=worst)


def hybrid_card_vs_cpu(cfg):
    """(c): a 4-layer copy at full width (one group and one tail layer, so
    every branch runs), window cut to 64 so that prompt 200 plus 4 steps
    wrap the ring, in float32 on the card and on the CPU, held to phase
    11's limits (logits within ``LM_CPU_TOL`` of max|want|, top-1 equal
    but at near-ties).  (The bf16 copy, 10.5 s of the CPU's, is cut: the
    CPU tests hold bf16 per layer against the JAX package.)"""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    c = HYB_CPU
    cfg = cfg.scaled(n_layers=c["n_layers"], window=c["window"])
    card = init_params(cfg, torch.Generator(DEV).manual_seed(SEED),
                       DEV).float()
    cpu = Model(cfg, "cpu").float()
    cpu.load_state_dict(card.state_dict())
    n, steps = c["prompt_len"], c["steps"]
    toks = torch.randint(0, cfg.vocab, (c["batch"], n + steps),
                         generator=torch.Generator().manual_seed(SEED + 2),
                         dtype=torch.int32)
    res = dict(layers=c["n_layers"], window=c["window"], batch=c["batch"],
               prompt_len=n, decode_steps=steps)
    out, secs, routes = _card_and_cpu(card, cpu, toks, n, steps, cfg.vocab)
    del card, cpu
    rels, agree, ties, missed, _ = _compare(out, routes, "lm_hybrid (c)")
    r = res["f32"] = dict(max_rel_err=max(rels), rel_errs=rels,
                          top1_agree=agree, top1_near_ties=ties,
                          top1_missed=missed, seconds=secs)
    log(f"lm_hybrid (c) card vs CPU: {json.dumps(res)}")
    if r["top1_missed"] or r["max_rel_err"] > LM_CPU_TOL:
        raise RuntimeError(
            f"lm_hybrid (c): f32 card vs CPU {r['max_rel_err']:.4g} "
            f"(limit {LM_CPU_TOL}), top-1 missed {r['top1_missed']}")
    return res


def lm_hybrid_phase():
    """Phase 14: RecurrentGemma serving (``launch.serve.serve``) at
    RecurrentGemma-9B's published widths and 11 of its 38 layers: (a) batch 4,
    prompt 1,024, 32 greedy tokens; (d) the same run again, equal tokens;
    (e) batch 1 at an 8,192-token prompt (4x the window), 8 tokens; (b) a
    2,040-token prompt + 16 teacher-forced steps across position 2,048
    against one prefill of the longer sequence, in bf16 and in a float32
    copy of the same weights, end to end and layer by layer
    (``hybrid_decode_vs_prefill``), with a trace of 8 batch-4 decode steps
    between them; (c) a 4-layer copy on the card against the CPU.  Raises
    on any failed check.  None of the eight kernels may launch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import init_params
    c, e, w = HYB, HYB_LONG, HYB_WRAP
    cfg = get_config(c["arch"]).scaled(n_layers=c["n_layers"])
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    runs = []
    for _ in range(2):                     # (a), then (d)
        t0 = time.perf_counter()
        toks, stats = serve(cfg, batch=c["batch"], prompt_len=c["prompt_len"],
                            gen=c["gen"], seed=SEED, device=DEV)
        stats["wall_s"] = time.perf_counter() - t0
        runs.append((toks.cpu(), stats))
    peak = torch.cuda.max_memory_allocated()
    toks, st = runs[0]
    bound_step, bound_prefill, step_bytes = lm_bounds(
        cfg, c["batch"], c["prompt_len"], c["gen"])
    serve_out = dict(
        arch=c["arch"], layers=cfg.n_layers,
        published_layers=c["published_layers"], batch=c["batch"],
        prompt_len=c["prompt_len"], gen=c["gen"], window=cfg.window,
        prefill_s=st["prefill_s"], decode_s=st["decode_s"],
        tok_per_s=st["tok_per_s"], decode_step_ms=st["decode_step_ms"],
        decode_step_ms_median=statistics.median(st["decode_step_ms"]),
        decode_step_ms_min=min(st["decode_step_ms"]),
        decode_step_bound_ms=bound_step, decode_step_bytes=step_bytes,
        recurrent_state_bytes=hybrid_state_bytes(cfg, c["batch"]),
        prefill_bound_ms=bound_prefill,
        decode_host_syncs=[s["decode_host_syncs"] for _, s in runs],
        rerun=dict(prefill_s=runs[1][1]["prefill_s"],
                   decode_s=runs[1][1]["decode_s"],
                   tok_per_s=runs[1][1]["tok_per_s"],
                   decode_step_ms_median=statistics.median(
                       runs[1][1]["decode_step_ms"])),
        wall_s=[s["wall_s"] for _, s in runs], max_memory_allocated=peak)
    log(f"lm_hybrid (a)/(d): {json.dumps(serve_out)}")
    if any(s["decode_host_syncs"] for _, s in runs):
        raise RuntimeError("lm_hybrid (a): host syncs inside decode_step")
    if not torch.equal(runs[0][0], runs[1][0]):
        raise RuntimeError("lm_hybrid (d): two greedy runs differ")
    if toks.shape != (c["batch"], c["gen"]) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab:
        raise RuntimeError(f"lm_hybrid (a): tokens {tuple(toks.shape)} "
                           "out of range")
    del runs, toks
    torch.cuda.empty_cache()

    # (e) long context: batch 1 at 8,192 tokens
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ltoks, lst = serve(cfg, batch=e["batch"], prompt_len=e["prompt_len"],
                       gen=e["gen"], seed=SEED, device=DEV)
    lbound_step, lbound_prefill, lstep_bytes = lm_bounds(
        cfg, e["batch"], e["prompt_len"], e["gen"])
    long_out = dict(
        batch=e["batch"], prompt_len=e["prompt_len"], gen=e["gen"],
        prefill_s=lst["prefill_s"], prefill_bound_ms=lbound_prefill,
        decode_step_ms=lst["decode_step_ms"],
        decode_step_ms_median=statistics.median(lst["decode_step_ms"]),
        decode_step_bound_ms=lbound_step, decode_step_bytes=lstep_bytes,
        batch4_prompt1024_step_ms_median=serve_out["decode_step_ms_median"],
        tok_per_s=lst["tok_per_s"], decode_host_syncs=lst["decode_host_syncs"],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        wall_s=time.perf_counter() - t0)
    del ltoks
    torch.cuda.empty_cache()

    # (b) decode matches prefill across the wrap, bf16 then float32;
    # between them the long prompt's logits and cache on the same weights
    # and a trace of batch-4 decode steps
    model = init_params(cfg, torch.Generator(DEV).manual_seed(SEED), DEV)
    n, extra = w["prompt_len"], w["extra"]
    full = torch.randint(0, cfg.vocab, (w["batch"], n + extra),
                         generator=torch.Generator(DEV).manual_seed(SEED + 1),
                         dtype=torch.int32, device=DEV)
    decode = dict(prompt_len=n, steps=extra, window=cfg.window,
                  bf16=hybrid_decode_vs_prefill(model, full, n, extra))
    log(f"lm_hybrid (b) decode vs prefill, bf16: "
        f"{json.dumps(decode['bf16'])}")
    torch.cuda.empty_cache()

    long = torch.randint(0, cfg.vocab, (e["batch"], e["prompt_len"] + 1),
                         generator=torch.Generator(DEV).manual_seed(SEED + 4),
                         dtype=torch.int32, device=DEV)
    logits, lcache = model.prefill({"tokens": long[:, :-1]}, 0)
    step, lcache = model.decode_step(long[:, -1:], lcache)
    _, scache = model.prefill({"tokens": long[:, :c["prompt_len"]]}, 0)
    long_out["finite_logits"] = bool(torch.isfinite(logits).all()
                                     and torch.isfinite(step).all())
    long_out["cache_bytes"] = {f"prompt_{k}": cache_bytes(cache) for k, cache
                               in ((e["prompt_len"], lcache),
                                   (c["prompt_len"], scache))}
    long_out["cache_same_size"] = (
        cache_bytes(lcache) == cache_bytes(scache)
        and all(a.shape == b.shape for a, b in zip(
            (t for p in lcache["groups"].values() for t in p),
            (t for p in scache["groups"].values() for t in p))))
    log(f"lm_hybrid (e) long context: {json.dumps(long_out)}")
    del logits, step, lcache, scache, long
    if lst["decode_host_syncs"] or not long_out["finite_logits"] \
            or not long_out["cache_same_size"]:
        raise RuntimeError(
            f"lm_hybrid (e): syncs {lst['decode_host_syncs']}, finite "
            f"{long_out['finite_logits']}, cache bytes "
            f"{long_out['cache_bytes']}")

    ts = c["trace_steps"]
    tt = torch.randint(0, cfg.vocab, (c["batch"], c["prompt_len"] + ts),
                       generator=torch.Generator(DEV).manual_seed(SEED + 5),
                       dtype=torch.int32, device=DEV)
    _, cache = model.prefill({"tokens": tt[:, :c["prompt_len"]]}, 0)
    prof = profile_window(
        f"lm hybrid decode, {ts} steps, {cfg.n_layers} layers",
        lambda: [model.decode_step(tt[:, c["prompt_len"] + i:
                                      c["prompt_len"] + i + 1], cache)
                 for i in range(ts)])
    trace = None if prof is None else dict(
        batch=c["batch"], steps=ts,
        wall_s=prof["wall_s"], busy_s=prof["busy_s"], idle=prof["idle"],
        activities_per_step=prof["activities"] / ts,
        busy_ms_per_step=prof["busy_s"] * 1e3 / ts,
        matmul_ms_per_step=sum(
            t for name, (t, _) in prof["by_name"].items()
            if any(m in name for m in MATMUL_MARKERS)) / 1e3 / ts)
    log(f"lm_hybrid decode trace: {json.dumps(trace)}")
    del cache, tt
    torch.cuda.empty_cache()
    model.float()
    decode["f32"] = hybrid_decode_vs_prefill(model, full, n, extra)
    decode["limits"] = dict(bf16_by_layer=LM_DECODE_TOL,
                            f32_by_layer=SSM_F32_TOL,
                            f32_end_to_end_logits=LM_DECODE_TOL,
                            f32_end_to_end_top1=LM_DECODE_TOP1)
    log(f"lm_hybrid (b) decode vs prefill, float32: "
        f"{json.dumps(decode['f32'])}")
    del model, full
    torch.cuda.empty_cache()
    # Held: every layer's decode against the prefill on the same layer
    # inputs (bf16 at the reference test's 0.15, float32 at SSM_F32_TOL),
    # and the float32 logits end to end at the reference test's limits.
    # Reported, not held: the end-to-end states and the bf16 logits (a deep
    # random-weight stack amplifies rounding, as phase 13 shows).
    b16, f32 = decode["bf16"], decode["f32"]
    f32e = f32["end_to_end"]
    if not (max(b16["by_layer_max"].values()) < LM_DECODE_TOL
            and max(f32["by_layer_max"].values()) <= SSM_F32_TOL
            and f32e["max_rel_err"] < LM_DECODE_TOL
            and f32e["top1"] >= LM_DECODE_TOP1):
        raise RuntimeError(
            f"lm_hybrid (b): decode vs prefill by layer: bf16 "
            f"{b16['by_layer_max']} (limit {LM_DECODE_TOL}), float32 "
            f"{f32['by_layer_max']} (limit {SSM_F32_TOL}); float32 logits "
            f"end to end {f32e['max_rel_err']:.4g}, top-1 {f32e['top1']}")

    cpu = hybrid_card_vs_cpu(cfg)          # (c)
    torch.cuda.empty_cache()
    launched = {k: n for k, n in _build.launch_counts.items() if n}
    if launched:
        raise RuntimeError(f"lm_hybrid: kernels launched {launched}")
    out = dict(serve=serve_out, long_context=long_out,
               decode_vs_prefill=decode, card_vs_cpu=cpu, trace=trace,
               kernel_launches=launched,
               seconds=time.perf_counter() - t_phase)
    log(f"lm_hybrid phase: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 15
# Whisper-base (the audio family) and InternVL2-2B (the VLM patch
# frontend) at their published widths and full depth.

AUD = dict(arch="whisper-base", batch=16, prompt_len=448, gen=32,
           extra=8, trace_steps=8)      # (a), (c): Whisper's decoder context
AUD_WINDOW = dict(batch=16, frames=1500, prompt_len=4,
                  steps=64)             # (b): one 30 s window
VLM = dict(arch="internvl2-2b", batch=4, prompt_len=1280, gen=32,
           extra=8, trace_steps=8)      # (a), (c): 256 patches + 1,024 tokens
AV_CPU = dict(n_layers=2, batch=2, prompt_len=64, frames=96,
              steps=4)                  # (d): a 2-layer copy


def stub_inputs(cfg, batch, n, seed, device, frames=None):
    """Whisper's ``frames`` (batch, ``frames`` or n, d_model) or the VLM's
    ``patches`` (batch, n_patches, frontend_dim): bf16 standard normals
    from a generator seeded with ``seed`` on ``device``."""
    import torch
    shape = ((batch, frames or n, cfg.d_model) if cfg.family == "audio"
             else (batch, cfg.n_patches, cfg.frontend_dim))
    x = torch.randn(shape, generator=torch.Generator(device).manual_seed(
        seed), device=device).to(torch.bfloat16)
    return {"frames" if cfg.family == "audio" else "patches": x}


def av_serve(cfg, c):
    """(a) and its rerun: ``serve`` twice from the same seed; the step's
    CUDA-event ms against ``lm_bounds``' bytes bound, tokens a second,
    prefill seconds, host syncs and peak memory.  Raises on unequal or
    out-of-range tokens or a host sync."""
    import torch
    from repro_torch.launch.serve import serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        toks, stats = serve(cfg, batch=c["batch"], prompt_len=c["prompt_len"],
                            gen=c["gen"], seed=SEED, device=DEV)
        stats["wall_s"] = time.perf_counter() - t0
        runs.append((toks.cpu(), stats))
    toks, st = runs[0]
    bound_step, bound_prefill, step_bytes = lm_bounds(
        cfg, c["batch"], c["prompt_len"], c["gen"])
    out = dict(
        arch=c["arch"], layers=cfg.n_layers, enc_layers=cfg.enc_layers,
        batch=c["batch"], prompt_len=c["prompt_len"], gen=c["gen"],
        prefill_s=st["prefill_s"], decode_s=st["decode_s"],
        tok_per_s=st["tok_per_s"], decode_step_ms=st["decode_step_ms"],
        decode_step_ms_median=statistics.median(st["decode_step_ms"]),
        decode_step_ms_min=min(st["decode_step_ms"]),
        decode_step_bound_ms=bound_step, decode_step_bytes=step_bytes,
        prefill_bound_ms=bound_prefill,
        decode_host_syncs=[s["decode_host_syncs"] for _, s in runs],
        rerun=dict(prefill_s=runs[1][1]["prefill_s"],
                   tok_per_s=runs[1][1]["tok_per_s"],
                   decode_step_ms_median=statistics.median(
                       runs[1][1]["decode_step_ms"])),
        wall_s=[s["wall_s"] for _, s in runs],
        max_memory_allocated=torch.cuda.max_memory_allocated())
    label = f"lm_audio_vlm {c['arch']}"
    log(f"{label} (a): {json.dumps(out)}")
    if any(s["decode_host_syncs"] for _, s in runs):
        raise RuntimeError(f"{label} (a): host syncs inside decode_step")
    if not torch.equal(runs[0][0], runs[1][0]):
        raise RuntimeError(f"{label} (a): two greedy runs differ")
    if toks.shape != (c["batch"], c["gen"]) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab:
        raise RuntimeError(f"{label} (a): tokens {tuple(toks.shape)} out "
                           "of range")
    return out


def av_decode_vs_prefill(model, c, label):
    """(c) on ``model`` (bf16 or float32): the prompt's prefill and
    ``extra`` teacher-forced steps against one prefill of the longer
    sequence (the same frames or patches), at the reference test's limits
    (max|Δ| / max(max|want|, 1) < 0.15, top-1 >= 0.5)."""
    import torch
    cfg, n, extra = model.cfg, c["prompt_len"], c["extra"]
    room = cfg.n_patches if cfg.family == "vlm" else 0
    full = torch.randint(0, cfg.vocab, (c["batch"], n - room + extra),
                         generator=torch.Generator(DEV).manual_seed(SEED + 1),
                         dtype=torch.int32, device=DEV)
    stub = stub_inputs(cfg, c["batch"], n, SEED + 1, DEV)
    want, _ = model.prefill({"tokens": full, **stub}, n + extra)
    logits, cache = model.prefill({"tokens": full[:, :n - room], **stub},
                                  n + extra)
    for i in range(extra):
        logits, cache = model.decode_step(
            full[:, n - room + i: n - room + i + 1], cache)
    logits, want = logits[:, :cfg.vocab], want[:, :cfg.vocab]
    if not (torch.isfinite(logits).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{label} (c): non-finite logits")
    err = float((logits - want).abs().max())
    a, b = logits.argmax(-1), want.argmax(-1)
    res = dict(prompt_len=n, steps=extra, len=cache["len"],
               max_rel_err=err / max(float(want.abs().max()), 1.0),
               max_abs_err=err, max_abs_logit=float(want.abs().max()),
               top1=float((a == b).float().mean()),
               flipped_row_gaps=[float(want[r, b[r]] - want[r, a[r]])
                                 for r in range(a.shape[0]) if a[r] != b[r]])
    if not (res["max_rel_err"] < LM_DECODE_TOL
            and res["top1"] >= LM_DECODE_TOP1):
        raise RuntimeError(f"{label} (c): decode vs prefill "
                           f"{res['max_rel_err']:.4g}, top-1 {res['top1']}")
    return res


def av_trace(model, c):
    """A trace of ``trace_steps`` decode steps after a prefill of the
    prompt: activities and busy ms a step, idle share, matmul ms a step."""
    import torch
    cfg, n, ts = model.cfg, c["prompt_len"], c["trace_steps"]
    room = cfg.n_patches if cfg.family == "vlm" else 0
    tt = torch.randint(0, cfg.vocab, (c["batch"], n - room + ts),
                       generator=torch.Generator(DEV).manual_seed(SEED + 5),
                       dtype=torch.int32, device=DEV)
    stub = stub_inputs(cfg, c["batch"], n, SEED + 5, DEV)
    _, cache = model.prefill({"tokens": tt[:, :n - room], **stub}, n + ts)
    prof = profile_window(
        f"lm {c['arch']} decode, {ts} steps",
        lambda: [model.decode_step(tt[:, n - room + i: n - room + i + 1],
                                   cache) for i in range(ts)])
    return None if prof is None else dict(
        batch=c["batch"], steps=ts, wall_s=prof["wall_s"],
        busy_s=prof["busy_s"], idle=prof["idle"],
        activities_per_step=prof["activities"] / ts,
        busy_ms_per_step=prof["busy_s"] * 1e3 / ts,
        matmul_ms_per_step=sum(
            t for name, (t, _) in prof["by_name"].items()
            if any(m in name for m in MATMUL_MARKERS)) / 1e3 / ts)


def av_card_vs_cpu(cfg, label):
    """(d): a 2-layer copy at full width (Whisper: 2 encoder and 2 decoder
    layers) on the card and on the CPU, in bf16 as served and then both
    copies in float32, each held to phase 11's limits (logits within
    ``LM_CPU_TOL`` of max|want|, top-1 equal but at near-ties)."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    c = AV_CPU
    cfg = cfg.scaled(n_layers=c["n_layers"], enc_layers=min(
        cfg.enc_layers, c["n_layers"]))
    card = init_params(cfg, torch.Generator(DEV).manual_seed(SEED), DEV)
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    n, steps = c["prompt_len"], c["steps"]
    toks = torch.randint(0, cfg.vocab, (c["batch"], n + steps),
                         generator=torch.Generator().manual_seed(SEED + 2),
                         dtype=torch.int32)
    stub = stub_inputs(cfg, c["batch"], n, SEED + 2, "cpu",
                       frames=c["frames"])
    res = dict(layers=c["n_layers"], enc_layers=cfg.enc_layers,
               batch=c["batch"], prompt_len=n, decode_steps=steps,
               stub={k: list(v.shape) for k, v in stub.items()})
    for dtype in ("bf16", "f32"):
        if dtype == "f32":
            card.float(), cpu.float()
        out, secs, routes = _card_and_cpu(card, cpu, toks, n, steps,
                                          cfg.vocab, stub)
        rels, agree, ties, missed, _ = _compare(out, routes, f"{label} (d)")
        res[dtype] = dict(max_rel_err=max(rels), rel_errs=rels,
                          top1_agree=agree, top1_near_ties=ties,
                          top1_missed=missed, seconds=secs)
    del card, cpu
    log(f"{label} (d) card vs CPU: {json.dumps(res)}")
    for dtype in ("bf16", "f32"):
        r = res[dtype]
        if r["top1_missed"] or r["max_rel_err"] > LM_CPU_TOL:
            raise RuntimeError(
                f"{label} (d): {dtype} card vs CPU {r['max_rel_err']:.4g} "
                f"(limit {LM_CPU_TOL}), top-1 missed {r['top1_missed']}")
    return res


def whisper_window(model):
    """(b): the shape users run, one 30 s window (1,500 frames) and a
    4-token prompt, through ``make_prefill``/``make_decode_step``: 64
    greedy steps, each under ``sync_counter`` and timed by CUDA events; the
    cross-attention ``xk``/``xv`` bytes, prefill seconds, peak memory."""
    import torch
    from repro_torch.obs.syncs import sync_counter
    from repro_torch.train import make_decode_step, make_prefill
    c, cfg = AUD_WINDOW, model.cfg
    n, steps = c["prompt_len"], c["steps"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    toks = torch.randint(0, cfg.vocab, (c["batch"], n),
                         generator=torch.Generator(DEV).manual_seed(SEED + 6),
                         dtype=torch.int32, device=DEV)
    batch = {"tokens": toks, **stub_inputs(cfg, c["batch"], n, SEED + 6, DEV,
                                           frames=c["frames"])}
    prefill = make_prefill(model, n + steps)
    decode = make_decode_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    syncs, finite = 0, [bool(torch.isfinite(logits).all())]
    events[0].record()
    for i in range(steps):
        with sync_counter() as sc:
            tok, logits, cache = decode(tok, cache)
        syncs += sc.syncs
        events[i + 1].record()
    torch.cuda.synchronize()
    finite.append(bool(torch.isfinite(logits).all()))
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    bound_step, bound_prefill, step_bytes = lm_bounds(
        cfg, c["batch"], n, steps, frames=c["frames"])
    out = dict(batch=c["batch"], frames=c["frames"], prompt_len=n,
               steps=steps, prefill_s=prefill_s,
               prefill_bound_ms=bound_prefill, decode_step_ms=step_ms,
               decode_step_ms_median=statistics.median(step_ms),
               decode_step_bound_ms=bound_step, decode_step_bytes=step_bytes,
               xk_xv_bytes=cache_bytes([cache["xk"], cache["xv"]]),
               xk_shape=list(cache["xk"].shape), len=cache["len"],
               decode_host_syncs=syncs, finite_logits=all(finite),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"lm_audio_vlm whisper-base (b) one window: {json.dumps(out)}")
    if syncs or not all(finite) or cache["len"] != n + steps \
            or cache["xk"].shape[2] != c["frames"]:
        raise RuntimeError(f"lm_audio_vlm whisper-base (b): syncs {syncs}, "
                           f"finite {finite}, len {cache['len']}, xk "
                           f"{tuple(cache['xk'].shape)}")
    return out


def lm_audio_vlm_phase():
    """Phase 15: Whisper-base at its published widths and all 6 + 6 layers,
    then InternVL2-2B at its published widths and all 24 layers, through
    ``launch.serve.serve`` and ``Model``: (a) ``serve`` twice (Whisper:
    batch 16, prompt 448 with as many frames, 32 greedy tokens; the VLM:
    batch 4, 256 patches + 1,024 tokens, 32 tokens), equal tokens, 0
    syncs; (b) Whisper at one 30 s window (1,500 frames) and a 4-token
    prompt, 64 steps; (c) the prompt + 8 teacher-forced steps against one
    prefill of the longer sequence, in bf16 and in a float32 copy, with a
    trace of 8 decode steps between them; (d) a 2-layer copy on the card
    against the CPU.  Raises on any failed check.  None of the eight
    kernels may launch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import init_params
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    out = {}
    for c in (AUD, VLM):
        t0 = time.perf_counter()
        cfg, label = get_config(c["arch"]), f"lm_audio_vlm {c['arch']}"
        res = dict(serve=av_serve(cfg, c))
        model = init_params(cfg, torch.Generator(DEV).manual_seed(SEED),
                            DEV)
        res["parameters"] = sum(p.numel() for p in model.parameters())
        if cfg.family == "audio":
            res["one_window"] = whisper_window(model)
        res["decode_vs_prefill"] = dict(
            bf16=av_decode_vs_prefill(model, c, label))
        res["trace"] = av_trace(model, c)
        model.float()
        res["decode_vs_prefill"]["f32"] = av_decode_vs_prefill(model, c,
                                                               label)
        log(f"{label} (c) decode vs prefill: "
            f"{json.dumps(res['decode_vs_prefill'])}; trace "
            f"{json.dumps(res['trace'])}")
        del model
        torch.cuda.empty_cache()
        res["card_vs_cpu"] = av_card_vs_cpu(cfg, label)
        res["seconds"] = time.perf_counter() - t0
        out[c["arch"]] = res
    launched = {k: n for k, n in _build.launch_counts.items() if n}
    if launched:
        raise RuntimeError(f"lm_audio_vlm: kernels launched {launched}")
    out["kernel_launches"] = launched
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lm_audio_vlm phase: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 16
# LM training: Qwen1.5-4B at its published widths and all 40 layers.

TRAIN = dict(arch="qwen1.5-4b", batch=2, seq=2048, timed=6, lr=3e-4,
             warmup=1)
TRAIN_CPU = dict(n_layers=2, batch=1, seq=128)     # (b)
# (b) card against CPU, float32 both (TF32 off): the CPU tests' float32
# limits against the JAX package (tests/test_torch_train.py): loss 1e-5
# relative, grad norm and each grad leaf 1e-4 of max|want| (cuBLAS and the
# CPU sum in other orders); the parameters after one AdamW and one
# Adafactor step from the same grads (the CPU's, on both) 1e-5 of
# max|want| (the same float32 operations; Adafactor's means in another
# order)
TRAIN_TOL = dict(loss=1e-5, grad_norm=1e-4, grads=1e-4, params=1e-5)
# the dots step against a full step from the same parameters: the same
# products, saved instead of recomputed
TRAIN_DOTS_TOL = dict(loss=1e-6, grad_norm=1e-4)


def train_bounds(cfg, batch, seq):
    """A training step's floor at remat ``full``: the bf16 products (every
    weight product forward, recomputed and twice backward; ``lm_head``
    forward and recomputed) at 989 TFLOP/s, the float32 ones
    (``lm_head``'s backward, whose cotangent is float32 as the
    reference's, and the plain attention's scores and weighted sums over
    the whole S × S square, forward, recomputed and twice backward) at 67,
    and AdamW's bytes (parameters and grads read, m and v read and
    written, parameters written) at 3.35 TB/s, added: the three run one
    after another.  Returns a dict of the terms and ``bound_ms``."""
    from repro_torch.models import Model
    D, Hq, Hkv, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    T = batch * seq
    layer = D * Hq * hd * 2 + D * Hkv * hd * 2 + 3 * D * F
    lm = D * cfg.vocab_padded
    bf16 = 2 * T * (4 * layer * cfg.n_layers + 2 * lm)
    attn_fwd = 2 * 2 * batch * seq * seq * Hq * hd
    fp32 = 2 * 2 * T * lm + 4 * attn_fwd * cfg.n_layers
    n_bf16 = layer * cfg.n_layers + 2 * lm
    n_all = sum(p.numel() for p in Model(cfg, "meta").parameters())
    adam = n_bf16 * (2 + 2 + 16 + 2) + (n_all - n_bf16) * (4 + 4 + 16 + 4)
    ms = dict(bf16_ms=bf16 / BF16_TFLOPS / 1e9, fp32_ms=fp32 / FP32_TFLOPS /
              1e9, adamw_ms=adam / HBM_TBS / 1e9)
    return dict(bf16_tflop=bf16 / 1e12, fp32_tflop=fp32 / 1e12,
                adamw_gb=adam / 1e9, **ms, bound_ms=sum(ms.values()),
                parameters=n_all)


def _pattern_batch(vocab, batch, seq, device):
    """One fixed batch of a repeating 16-token pattern (the reference's
    ``test_loss_learns_structure``): labels are the next token."""
    import torch
    toks = (torch.arange(seq, device=device) % 16).repeat(batch, 1)
    toks = (toks * 997 % vocab).to(torch.int32)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


def _noop_opt(box):
    """An optimizer that keeps the (clipped) grads it is given and updates
    nothing: a step's loss, grad norm and grads from fixed parameters."""
    from repro_torch.train.optimizer import Optimizer

    def update(grads, state, params, step):
        box["grads"] = grads
        return params, state
    return Optimizer(lambda params: None, update)


def _state_bytes(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_state_bytes(v) for v in tree.values())
    return 0


def _step_ids(first, steps):
    """Step indices ``first ..`` as 0-d device tensors, made before a
    ``sync_counter`` block (a host-to-device copy synchronises)."""
    import torch
    return [torch.tensor(first + i, device=DEV) for i in range(steps)]


def _timed_steps(step, state, batch, ids):
    """A train step at each of the step indices ``ids``, CUDA events around
    each; returns (state, metrics per step as device tensors, ms per
    step)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(ids) + 1)]
    mets = []
    ev[0].record()
    for i, sid in enumerate(ids):
        state, m = step(state, batch, sid)
        mets.append(m)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return state, mets, [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def train_full_model():
    """(a): Qwen1.5-4B at its published widths and all 40 layers, bf16,
    remat ``full``: the config's AdamW (lr 3e-4, warm-up 1) for one
    warm-up and ``TRAIN["timed"]`` timed steps on one fixed batch, the
    timed ones under ``sync_counter``; then a ``full`` and a ``dots`` step
    from the same parameters (an optimizer that updates nothing).
    Adafactor at this width runs in (c), ``train_loop_full_model``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.obs.syncs import sync_counter
    from repro_torch.train import make_optimizer, make_train_step
    c = TRAIN
    cfg = get_config(c["arch"])
    assert cfg.remat and cfg.remat_policy == "full" and \
        cfg.optimizer == "adamw"
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    model = init_params(cfg, torch.Generator(DEV).manual_seed(SEED), DEV)
    init_s = time.perf_counter() - t0
    named = dict(model.named_parameters())
    params_b = _state_bytes(named)
    batch = _pattern_batch(cfg.vocab, c["batch"], c["seq"], DEV)
    opt = make_optimizer(cfg.optimizer, lr=c["lr"], warmup=c["warmup"])
    step = make_train_step(model, opt)
    state = opt.init(named)
    adam_b = _state_bytes(state)
    torch.cuda.reset_peak_memory_stats()
    state, warm, warm_ms = _timed_steps(step, state, batch, _step_ids(0, 1))
    ids = _step_ids(1, c["timed"])
    with sync_counter() as sc:
        state, mets, ms = _timed_steps(step, state, batch, ids)
    peak = torch.cuda.max_memory_allocated()
    mets = warm + mets
    losses = [float(m["loss"]) for m in mets]
    norms = [float(m["grad_norm"]) for m in mets]
    bound = train_bounds(cfg, c["batch"], c["seq"])
    med = statistics.median(ms)
    res = dict(
        arch=c["arch"], layers=cfg.n_layers, published_layers=40,
        parameters=sum(p.numel() for p in named.values()),
        batch=c["batch"], seq=c["seq"], remat=cfg.remat_policy,
        optimizer=dict(name="adamw", lr=c["lr"], warmup=c["warmup"]),
        init_s=init_s, warmup_step_ms=warm_ms[0], step_ms=ms,
        step_ms_median=med, step_ms_min=min(ms), step_ms_max=max(ms),
        step_bound_ms=bound["bound_ms"], bound=bound,
        tokens_per_s=c["batch"] * c["seq"] / (med / 1e3),
        max_memory_allocated=peak,
        state_bytes=dict(params=params_b, grads=params_b,
                         adamw_m_v=adam_b),
        host_syncs_per_step=sc.syncs / c["timed"], loss=losses,
        grad_norm=norms)
    log(f"lm_train (a) adamw: {json.dumps(res)}")
    if not all(math.isfinite(v) for v in losses + norms):
        raise RuntimeError(f"lm_train (a): non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"lm_train (a): loss {losses[0]} -> {losses[-1]}")
    if sc.syncs:
        raise RuntimeError(f"lm_train (a): {sc.syncs} host syncs")

    # where a step's time goes: one more AdamW step traced
    prof = profile_window("lm_train, one AdamW step at full width",
                          lambda: _timed_steps(step, state, batch,
                                               _step_ids(1 + c["timed"], 1)))
    if prof is not None:
        busy_us = prof["busy_s"] * 1e6
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:8]
        res["trace"] = dict(
            wall_s=prof["wall_s"], busy_s=prof["busy_s"], idle=prof["idle"],
            activities=prof["activities"],
            matmul_share=sum(t for n, (t, _) in prof["by_name"].items()
                             if any(m in n for m in MATMUL_MARKERS))
            / busy_us,
            top={n: dict(ms=t / 1e3, count=k, share=t / busy_us)
                 for n, (t, k) in top})
    else:
        res["trace"] = "not measured"
    log(f"lm_train (a) trace: {json.dumps(res['trace'])}")

    # the same parameters through a full and a dots step
    remat = {}
    for policy in ("full", "dots"):
        model.cfg = dataclasses.replace(cfg, remat_policy=policy)
        box = {}
        torch.cuda.reset_peak_memory_stats()
        _, (m,), (t,) = _timed_steps(
            make_train_step(model, _noop_opt(box)), None, batch,
            _step_ids(2 + c["timed"], 1))
        remat[policy] = dict(loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"]), step_ms=t,
                             max_memory_allocated=
                             torch.cuda.max_memory_allocated())
        del box
    model.cfg = cfg
    res["remat"] = remat
    log(f"lm_train (a) full vs dots: {json.dumps(remat)}")
    f, d = remat["full"], remat["dots"]
    if abs(d["loss"] - f["loss"]) > TRAIN_DOTS_TOL["loss"] * abs(f["loss"]) \
            or abs(d["grad_norm"] - f["grad_norm"]) > \
            TRAIN_DOTS_TOL["grad_norm"] * f["grad_norm"]:
        raise RuntimeError(f"lm_train (a): dots {d} against full {f}")

    del model, named, state, step, batch
    torch.cuda.empty_cache()
    return res


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def train_card_vs_cpu():
    """(b): a 2-layer full-width copy (the card's generator draws the first
    two layers first), float32 on the card and on the CPU, batch 1 × 128:
    loss, grad norm and every clipped grad of one step; then one AdamW and
    one Adafactor step on each from the same grads (the CPU's), the
    parameters restored in between.  The errors are computed on the card,
    the CPU's tensors copied there."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import init_params
    from repro_torch.train import adafactor, adamw, make_train_step
    c = TRAIN_CPU
    cfg = get_config(TRAIN["arch"]).scaled(n_layers=c["n_layers"])
    t0 = time.perf_counter()
    secs = {}
    card = init_params(cfg, torch.Generator(DEV).manual_seed(SEED),
                       DEV).float()
    cpu = Model(cfg, "meta").float().to_empty(device="cpu")
    cpu.load_state_dict(card.state_dict())
    batch = _pattern_batch(cfg.vocab, c["batch"], c["seq"], "cpu")
    secs["setup"] = time.perf_counter() - t0
    models = (("card", card), ("cpu", cpu))
    mets, grads = {}, {}
    for name, m in models:
        t = time.perf_counter()
        box = {}
        _, met = make_train_step(m, _noop_opt(box))(
            None, {k: v.to(m.device) for k, v in batch.items()},
            torch.tensor(0, device=m.device))
        mets[name] = {k: float(v) for k, v in met.items()}
        grads[name] = box["grads"]
        secs[f"{name}_step"] = time.perf_counter() - t
    gm, wm = mets["card"], mets["cpu"]
    card_grads = grads["card"]
    grads["card"] = {n: g.to(DEV) for n, g in grads["cpu"].items()}
    errs = dict(loss=abs(gm["loss"] - wm["loss"]) / abs(wm["loss"]),
                grad_norm=abs(gm["grad_norm"] - wm["grad_norm"])
                / wm["grad_norm"],
                grads=max(_rel_err(card_grads[n], g)
                          for n, g in grads["card"].items()))
    del card_grads
    # each optimizer from the CPU's grads on both, from the same parameters
    # (one pristine copy a device, restored after the first)
    params = {name: dict(m.named_parameters()) for name, m in models}
    orig = {name: {n: t.detach().clone() for n, t in ps.items()}
            for name, ps in params.items()}
    for oname, opt in (("adamw", adamw(lr=TRAIN["lr"], warmup=1)),
                       ("adafactor", adafactor(warmup=1))):
        t1 = time.perf_counter()
        for name, m in models:
            opt.update(grads[name], opt.init(params[name]), params[name],
                       torch.tensor(0, device=m.device))
        errs[f"params_{oname}"] = max(
            _rel_err(params["card"][n].detach(), t.detach().to(DEV))
            for n, t in params["cpu"].items())
        if oname == "adamw":
            with torch.no_grad():
                for name, _ in models:
                    for n, t in params[name].items():
                        t.copy_(orig[name][n])
        secs[oname] = time.perf_counter() - t1
    del orig, grads, params, card, cpu
    res = dict(layers=c["n_layers"], batch=c["batch"], seq=c["seq"],
               loss=dict(card=gm["loss"], cpu=wm["loss"]),
               grad_norm=dict(card=gm["grad_norm"], cpu=wm["grad_norm"]),
               errors=errs, limits=TRAIN_TOL, step_seconds=secs,
               seconds=time.perf_counter() - t0)
    log(f"lm_train (b) card vs CPU: {json.dumps(res)}")
    bad = {k: v for k, v in errs.items()
           if not v <= TRAIN_TOL[k.split("_")[0] if k.startswith("params")
                                 else k]}
    if bad or not math.isfinite(gm["loss"]):
        raise RuntimeError(f"lm_train (b): card vs CPU {bad}")
    return res


# (c) the trainer loop (launch/train.py::train) at the same width with the
# Adafactor optimizer (its state is 0.2 GB; AdamW's f32 m and v would make
# each checkpoint 39.5 GB): U runs ``steps`` steps without a checkpoint, A
# ``crash_after`` steps into a fresh directory (its final save the only
# one), B resumes there to ``steps``.  B's losses against U's at the same
# steps: the reference's limit (tests/test_checkpoint.py::
# test_crash_resume_equivalence, rel 1e-3), since the backward's atomics on
# the card may move a last ulp.  The CLI at the smoke preset runs
# ``cli_steps`` steps with a checkpoint every ``cli_every``, crashes at
# ``crash_step`` and resumes.
TRAIN_LOOP = dict(steps=4, crash_after=2, loss_rtol=1e-3, cli_steps=6,
                  cli_every=2, crash_step=3, cli_timeout=300)


@contextlib.contextmanager
def checkpoint_log():
    """Wraps ``train.checkpoint``'s ``save`` and ``restore`` and the parts
    that tell a save's device-to-host copies (``_host_array``, in the
    worker thread, beside the npz's write) and its waits for the disk
    (``_fsync``: what the flush-behind thread left) and a restore's read
    (``_read_shards``) apart (all looked up at call time, as
    ``launch/train.py`` calls them).  Yields {"save": [...], "restore":
    [...], "trees": {step: the tree each save was given}, "on_restore":
    None}; ``on_restore``, when set, is called with each restored tree.
    The rest of a save is the npz's write with its CRCs (the copies and
    the write-back beside it), the manifest and the renames; the rest of a
    restore the copies onto the device."""
    import torch
    from repro_torch.train import checkpoint as ck
    names = ("save", "restore", "_host_array", "_fsync", "_read_shards")
    orig = {n: getattr(ck, n) for n in names}
    rec = {"save": [], "restore": [], "trees": {}, "on_restore": None}
    parts = {}

    def part(name):
        def fn(*a, **kw):
            t = time.perf_counter()
            try:
                return orig[name](*a, **kw)
            finally:
                parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
        return fn

    def nbytes(path):
        return sum(f.stat().st_size for f in Path(path).iterdir())

    def save(ckpt_dir, step, tree, **kw):
        parts.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = orig["save"](ckpt_dir, step, tree, **kw)
        sec = time.perf_counter() - t
        n = nbytes(path)
        d2h, fs = parts.get("_host_array", 0.0), parts.get("_fsync", 0.0)
        rec["save"].append(dict(step=step, bytes=n, seconds=sec,
                                gb_per_s=n / sec / 1e9,
                                device_to_host_s_beside=d2h,
                                fsync_wait_s=fs,
                                npz_write_and_rest_s=sec - fs))
        rec["trees"][step] = tree
        return path

    def restore(ckpt_dir, like, **kw):
        parts.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tree, step, extra = orig["restore"](ckpt_dir, like, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        n = nbytes(Path(ckpt_dir) / f"step_{step:010d}")
        rd = parts.get("_read_shards", 0.0)
        rec["restore"].append(dict(step=step, bytes=n, seconds=sec,
                                   gb_per_s=n / sec / 1e9, read_s=rd,
                                   to_device_and_rest_s=sec - rd))
        if rec["on_restore"] is not None:
            rec["on_restore"](tree)
        return tree, step, extra

    wrapped = dict(save=save, restore=restore, **{
        n: part(n) for n in ("_host_array", "_fsync", "_read_shards")})
    for n, f in wrapped.items():
        setattr(ck, n, f)
    try:
        yield rec
    finally:
        for n, f in orig.items():
            setattr(ck, n, f)


@contextlib.contextmanager
def loss_reads():
    """Wraps ``launch/train.py``'s host read of the loss (looked up at call
    time): yields the host clock just after each read."""
    from repro_torch.launch import train as lt
    orig, stamps = lt.read, []

    def read(tree):
        out = orig(tree)
        stamps.append(time.perf_counter())
        return out
    lt.read = read
    try:
        yield stamps
    finally:
        lt.read = orig


def _run_captured(fn, label):
    """``fn()`` with its standard output captured; each captured line is
    logged after.  Returns (fn's result, the output, seconds, the device
    synchronised at the end)."""
    import io
    import torch
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
    finally:
        for line in buf.getvalue().splitlines():
            log(f"  {label}: {line}")
    return out, buf.getvalue(), time.perf_counter() - t


def _cli_pair(ckpt_dir):
    """``python -m repro_torch.launch.train --preset smoke`` twice, without
    ``--device`` (so on the card): with ``--simulate-crash``, then with
    ``--resume``; each run's exit code, seconds, the step it says it
    resumed from and the tail of its output, and the latest step after
    the crash."""
    import os
    import re
    from repro_torch.train import checkpoint as ck
    c = TRAIN_LOOP
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(HERE / "src"), os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--preset",
           "smoke", "--steps", str(c["cli_steps"]), "--ckpt-every",
           str(c["cli_every"]), "--ckpt-dir", ckpt_dir]
    out = {}
    for name, extra in (("crash", ["--simulate-crash",
                                   str(c["crash_step"])]),
                        ("resume", ["--resume"])):
        t = time.perf_counter()
        r = subprocess.run(cmd + extra, capture_output=True, text=True,
                           env=env, timeout=c["cli_timeout"])
        m = re.search(r"resumed from step (\d+)", r.stdout)
        out[name] = dict(rc=r.returncode, seconds=time.perf_counter() - t,
                         resumed_from=m and int(m.group(1)),
                         stdout_tail=r.stdout[-400:],
                         stderr_tail=r.stderr[-400:])
        if name == "crash":
            out[name]["latest_step"] = ck.latest_step(ckpt_dir)
    return out


def _flat_equal(got, want):
    """(leaves of ``want``, the paths whose leaf in ``got`` differs in
    device, dtype or any bit, or is missing)."""
    import torch
    from repro_torch.train import checkpoint as ck
    g, w = ck._flatten(got), ck._flatten(want)
    bad = [k for k, t in w.items()
           if k not in g or g[k].device != t.device or g[k].dtype != t.dtype
           or not torch.equal(g[k], t)]
    return len(w), bad


def train_loop_full_model(bare_step_ms):
    """(c): ``launch/train.py::train`` at Qwen1.5-4B's published widths and
    all 40 layers with Adafactor, batch ``TRAIN``'s 2 × 2,048, on the
    card, ``log_every=1``: U (``steps`` steps, no checkpoint, under
    ``sync_counter``), A (``crash_after`` steps into a fresh temporary
    directory) and B (``resume=True`` there, to ``steps``).  B's restored
    parameters and Adafactor state must equal A's final in-memory ones bit
    for bit on the card, B must print that it resumed, its losses must lie
    within ``loss_rtol`` of U's at the same steps, and every loss must be
    finite.  Beside A and B, the CLI pair (``_cli_pair``): exit 42 with
    the latest step the last multiple of ``cli_every`` before
    ``crash_step``, then a resume from it that exits 0.  Raises
    where the disk lacks room for two checkpoints; the temporary
    directories are removed at the end."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import Model
    from repro_torch.obs.syncs import sync_counter
    from repro_torch.train import adafactor
    from repro_torch.train import checkpoint as ck
    c = TRAIN_LOOP
    cfg = get_config(TRAIN["arch"]).scaled(optimizer="adafactor")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    kw = dict(batch=TRAIN["batch"], seq=TRAIN["seq"], seed=SEED,
              log_every=1, device=DEV)
    meta = dict(Model(cfg, "meta").named_parameters())
    est = _state_bytes(meta) + _state_bytes(adafactor().init(meta))
    del meta
    t_c = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    tmp_cli = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        du = shutil.disk_usage(tmp)
        disk = dict(path=tmp, free_bytes=du.free, total_bytes=du.total,
                    need_bytes=2 * est)
        log(f"lm_train (c) disk: {json.dumps(disk)}")
        if du.free < 2 * est:
            raise RuntimeError(f"lm_train (c): {du.free} bytes free under "
                               f"{tmp}, two checkpoints need {2 * est}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def run_u():
            with loss_reads() as stamps, sync_counter() as sc:
                model, losses = train(cfg, steps=c["steps"], **kw)
            return model, losses, stamps, sc.syncs
        (model_u, loss_u, stamps, syncs), _, u_s = _run_captured(run_u, "U")
        step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        med = statistics.median(step_ms)
        runs = dict(U=dict(steps=c["steps"], seconds=u_s, loss=loss_u,
                           step_ms=step_ms, step_ms_median=med,
                           tokens_per_s=tokens / (med / 1e3),
                           host_syncs=syncs,
                           host_syncs_per_step=syncs / c["steps"],
                           max_memory_allocated=
                           torch.cuda.max_memory_allocated()))
        if syncs != c["steps"]:
            raise RuntimeError(f"lm_train (c): {syncs} host syncs in U, "
                               f"{c['steps']} loss reads")

        checks = {}

        def check_restore(tree):
            n, bad = _flat_equal(tree, rec["trees"].pop(c["crash_after"]))
            checks["restore"] = dict(leaves=n, unequal=bad)

        with ThreadPoolExecutor(1) as pool:
            cli = pool.submit(_cli_pair, tmp_cli)
            with checkpoint_log() as rec:
                (model_a, loss_a), _, a_s = _run_captured(
                    lambda: train(cfg, steps=c["crash_after"],
                                  ckpt_dir=tmp, **kw), "A")
                del model_a
                runs["A"] = dict(steps=c["crash_after"], seconds=a_s,
                                 loss=loss_a, saves=len(rec["save"]),
                                 latest_step=ck.latest_step(tmp))
                rec["on_restore"] = check_restore
                (model_b, loss_b), b_out, b_s = _run_captured(
                    lambda: train(cfg, steps=c["steps"], ckpt_dir=tmp,
                                  resume=True, **kw), "B")
                runs["B"] = dict(steps=c["steps"], seconds=b_s, loss=loss_b,
                                 resumed=f"resumed from step "
                                 f"{c['crash_after']}" in b_out,
                                 latest_step=ck.latest_step(tmp))
                rec["trees"].clear()
            cli_out = cli.result()
        with torch.no_grad():
            diff = max((float((p - q).abs().max()), n) for (n, p), q in zip(
                model_u.named_parameters(), model_b.parameters()))
        del model_u, model_b
        torch.cuda.empty_cache()
        u_at = {s: v for s, v in loss_u}
        rel = {s: abs(v - u_at[s]) / abs(u_at[s]) for s, v in loss_b}
        res = dict(
            arch=TRAIN["arch"], layers=cfg.n_layers, optimizer="adafactor",
            batch=TRAIN["batch"], seq=TRAIN["seq"], log_every=1, disk=disk,
            checkpoint_estimate_bytes=est, runs=runs, saves=rec["save"],
            restores=rec["restore"], restore_check=checks.get("restore"),
            resumed_loss_rel_diff=rel, loss_rtol=c["loss_rtol"],
            max_param_abs_diff=dict(value=diff[0], parameter=diff[1]),
            bare_step_ms_adamw=bare_step_ms, cli=cli_out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(tmp_cli, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_c
    log(f"lm_train (c) loop: {json.dumps(res)}")
    fails = []
    if not runs["B"]["resumed"]:
        fails.append("B did not resume")
    if runs["A"]["saves"] != 1 or runs["A"]["latest_step"] != \
            c["crash_after"] or runs["B"]["latest_step"] != c["steps"]:
        fails.append("checkpoint steps")
    if res["restore_check"] is None or res["restore_check"]["unequal"]:
        fails.append(f"restore against A's state {res['restore_check']}")
    if sorted(rel) != list(range(c["crash_after"], c["steps"])) or \
            not all(v <= c["loss_rtol"] for v in rel.values()):
        fails.append(f"B's losses against U's {rel}")
    if not all(math.isfinite(v) for r in runs.values() for _, v in r["loss"]):
        fails.append("non-finite loss")
    cr, rs = cli_out["crash"], cli_out["resume"]
    saved = c["crash_step"] // c["cli_every"] * c["cli_every"]
    if cr["rc"] != 42 or cr["latest_step"] != saved:
        fails.append(f"CLI crash run {cr}")
    if rs["rc"] != 0 or rs["resumed_from"] != saved:
        fails.append(f"CLI resume run {rs}")
    if fails:
        raise RuntimeError(f"lm_train (c): {fails}")
    return res


def lm_train_phase():
    """Phase 16: training (``Model.loss``, remat, ``make_train_step``,
    AdamW and Adafactor, checkpoints and the trainer loop) at Qwen1.5-4B's
    published widths and all 40 layers: (a) ``train_full_model``; (b)
    ``train_card_vs_cpu``; (c) ``train_loop_full_model``.  Raises on any
    failed check.  None of the eight kernels may launch."""
    from repro_torch.kernels import _build
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    out = dict(full=train_full_model())
    out["card_vs_cpu"] = train_card_vs_cpu()
    out["loop"] = train_loop_full_model(out["full"]["step_ms_median"])
    launched = {k: n for k, n in _build.launch_counts.items() if n}
    if launched:
        raise RuntimeError(f"lm_train: kernels launched {launched}")
    out["kernel_launches"] = launched
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lm_train phase: {out['seconds']:.1f} s")
    return out


def autotune_field(name, tuned):
    """A kernel entry's ``autotune`` field: the table's knob, its entries
    (shape and knob) and phase 10's times, or "exempt" with the reason from
    its module."""
    from repro_torch.kernels import autotune
    if name not in autotune.SWEEP_TILES:
        src = (HERE / "src/repro_torch/kernels" / f"{name}.py").read_text()
        mark = f"# autotune: exempt({name}): "
        reason = src.split(mark, 1)[1].split("\n\n", 1)[0] if mark in src \
            else "?"
        return "exempt: " + " ".join(w.strip("# ") for w in
                                     reason.split("\n")).strip()
    entries = [{k: e[k] for k in ("shape", "tile")}
               for e in autotune.load_table() if e["kernel"] == name]
    return dict(knob=autotune.KNOBS[name],
                default=autotune.DEFAULT_TILE[name], entries=entries,
                phase10=[{k: r[k] for k in ("shape", "table", "default",
                                            "equal", "us_table",
                                            "us_default")}
                         for r in tuned if r["kernel"] == name])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch import resolve_device
    from repro_torch.data import sift_like
    from repro_torch.kernels import _build
    resolve_device("cuda")                 # full-f32 matmuls (no TF32)
    t_all = T_START
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = nvidia_smi_line()
    log(f"card: {smi}")

    t0 = time.perf_counter()
    secs = _build.build()
    phase_s = {"startup (imports, card, nvidia-smi)": t0 - t_all,
               "build (phase 1)": time.perf_counter() - t0}
    log(f"kernel build: {phase_s['build (phase 1)']:.2f} s wall, per source "
        f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    for name in _build.SOURCES:
        rep = _build.build_log(name) or ""
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    def elapsed(after):
        """Logs the seconds since the start and records ``after``'s own
        seconds (since the previous mark) in ``phase_s``."""
        now = time.perf_counter() - t_all
        phase_s[after] = now - sum(phase_s.values())
        log(f"elapsed {now:.1f} s after {after}")

    failures = []
    c = SIFT1M
    X = sift_like(c["n"], c["d"], COMPONENTS,
                  generator=torch.Generator(device=DEV).manual_seed(SEED))
    k2 = 1 << (c["k"] - 1).bit_length()
    X_pad, real_id = padded_copy(X)
    gs = check_gather_score(X, k2)
    rm = check_refine_merge(X_pad, real_id, c["n"])
    del X_pad, real_id
    X_gist = sift_like(GIST["n"], GIST["d"], COMPONENTS,
                       generator=torch.Generator(device=DEV).manual_seed(
                           SEED + 18))
    gs_gist = check_gather_score(X_gist, GIST["k"], "gist1m")
    del X_gist
    if not (gs["ok"] and gs_gist["ok"]):
        failures.append("gather_score vs plain")
    if not rm["ok"]:
        failures.append("refine_merge vs plain")
    ca = check_centroid_kernels(X, k2)
    if not ca["ok"]:
        failures.append("probe/assign_centroids vs plain")
    pw = check_pairwise_sq(X)
    if not pw["ok"]:
        failures.append("pairwise_sq vs plain")
    elapsed("the kernel checks (phase 2)")
    ok_small, X_small, r_small = parity_small()
    if not ok_small:
        failures.append("SIFT_SMALL parity")
    if not ivf_parity_small(X_small, r_small):
        failures.append("SIFT_SMALL IVF parity")
    del X_small, r_small
    elapsed("SIFT_SMALL parity (phase 3)")
    ok_main, launches, res, ref_tel = main_path(X)
    if not ok_main:
        failures.append("main path")
    profile_main_path(X, res)
    elapsed("the main path (phase 4)")
    ok_serve, serve_launches, index, Q, X_all, gt = serve_path(X, res)
    if not ok_serve:
        failures.append("serving path")
    launches.update({k: serve_launches[k] for k in
                     ("probe_centroids", "assign_centroids", "ivf_scan")})
    sc = check_scan_kernel(index, Q, X_all)
    if not sc["ok"]:
        failures.append("ivf_scan vs plain")
    profile_serving(index, Q)
    ok_codec, runs = serve_codec_paths(index, Q, gt)
    if not ok_codec:
        failures.append("codec / grouped serving paths")
    cc = check_codec_kernels(index, runs, Q, X_all)
    if not all(c["ok"] for c in cc["adc"].values()):
        failures.append("ivf_scan_adc vs plain")
    if not (cc["grouped"]["ok"] and cc["grouped_batch"]["ok"]):
        failures.append("ivf_scan_grouped vs plain")
    profile_serving(runs["pq"]["index"], Q, "codec pq nsub=8", codec="pq")
    profile_serving(runs["int8"]["index"], Q, "codec int8", codec="int8")
    profile_serving(index, Q, "qgroup=8", qgroup=8)
    elapsed("serving (phase 5)")
    ok_base, base = baselines_phase(X, res, Q)
    if not ok_base:
        failures.append("baselines")
    elapsed("baselines (phase 6)")
    ok_obs, _ = obs_phase(X, res, ref_tel, index, Q,
                          kernel_entries(gs, rm, ca, sc, cc, pw))
    if not ok_obs:
        failures.append("obs layer")
    elapsed("obs (phase 7)")
    ok_sh, sharded = sharded_phase(X, res, index, runs, Q, gt)
    if not ok_sh:
        failures.append("sharded topology")
    del X
    elapsed("sharded (phase 9)")
    ok_kv, kv_out = kv_cluster_phase()
    if not ok_kv:
        failures.append("clustered-KV decode")
    elapsed("clustered-KV decode (phase 8)")
    ok_an, analysis = analysis_phase(smi)
    if not ok_an:
        failures.append("analysis / autotune / dry run")
    elapsed("analysis (phase 10)")
    lm = lm_serve_phase()                  # raises on a failed check
    elapsed("dense LM serving (phase 11)")
    moe_out = lm_moe_phase()               # raises on a failed check
    elapsed("MoE serving (phase 12)")
    ssm_out = lm_ssm_phase()               # raises on a failed check
    elapsed("Mamba-2 serving (phase 13)")
    hybrid_out = lm_hybrid_phase()         # raises on a failed check
    elapsed("RecurrentGemma serving (phase 14)")
    av_out = lm_audio_vlm_phase()          # raises on a failed check
    elapsed("Whisper and VLM serving (phase 15)")
    train_out = lm_train_phase()           # raises on a failed check
    elapsed("LM training (phase 16)")

    kernels = [
        dict(name="gather_score", route="cuda",
             source="src/repro_torch/kernels/csrc/gather_score.cu",
             replaces="src/repro/kernels/gather_score.py:64",
             launches=launches["gather_score"],
             max_abs_err=gs["bkm"]["max_abs_err"], ms=gs["bkm"]["ms"],
             plain_ms=gs["bkm"]["plain_ms"], bound_ms=gs["bound_ms"],
             bound_by=gs["bound_by"], library_ms=None,
             dots_bmm_ms=gs["dots_bmm_ms"], shape=gs["shape"],
             device_us=gs["bkm"]["device_us"],
             device_launches_per_call=gs["bkm"]["device_launches_per_call"],
             layout=gs["layout"], l2_floor_us=gs["l2_floor_us"],
             l2_rate_tbs=gs["l2_rate_tbs"],
             lloyd_device_us=gs["lloyd"]["device_us"],
             lloyd_max_abs_err=gs["lloyd"]["max_abs_err"],
             lloyd_ms=gs["lloyd"]["ms"], lloyd_plain_ms=gs["lloyd"]["plain_ms"],
             lloyd_max_err_over_limit=gs["lloyd"]["max_err_over_limit"],
             max_err_over_limit=gs["bkm"]["max_err_over_limit"],
             gist={"shape": gs_gist["shape"], "layout": gs_gist["layout"],
                   "bound_ms": gs_gist["bound_ms"],
                   "l2_floor_us": gs_gist["l2_floor_us"],
                   "dots_bmm_ms": gs_gist["dots_bmm_ms"]}
             | {f"{m}_{key}": gs_gist[m][key] for m in ("bkm", "lloyd")
                for key in ("ms", "plain_ms", "device_us", "max_abs_err",
                            "max_err_over_limit")},
             check=f"vs plain: |err| <= {SCORE_RTOL:g}*score_scale per "
                   "element, inf pattern exact; planted faults fail; one "
                   "device launch per call"),
        dict(name="refine_merge", route="cuda",
             source="src/repro_torch/kernels/csrc/refine_merge.cu",
             replaces="src/repro/kernels/refine_merge.py:65",
             launches=launches["refine_merge"], max_abs_err=rm["max_abs_err"],
             ms=rm["ms"], plain_ms=rm["plain_ms"], bound_ms=rm["bound_ms"],
             bound_by=rm["bound_by"], library_ms=None,
             dots_bmm_ms=rm["dots_bmm_ms"], device_us=rm["device_us"],
             id_mismatch_frac=rm["id_mismatch_frac"],
             check="vs plain: distances rtol 1e-5 + 1e-6*max norm², ids "
                   "distinct per row and equal but at near-ties"),
    ]
    split_note = ("wrapper calls on the main path; each makes one device "
                  "launch, or two (pass 1 and the merge) when its split "
                  "plan has more than one chunk")
    sel = (f"vs plain: |d2 err| <= {DIST_RTOL:g}*(||x||²+||c||²) per slot, "
           "-1/+inf pattern exact, ids equal but at near-ties; planted "
           "faults fail")
    nq = SERVE["nq"]
    pr, asg, s16 = ca["probe"][16], ca["assign"]["n10k"], sc[16]
    kernels += [
        dict(name="probe_centroids", route="cuda",
             source="src/repro_torch/kernels/csrc/centroid_assign.cu",
             replaces="src/repro/kernels/centroid_assign.py:103",
             launches=launches["probe_centroids"], launches_note=split_note,
             max_abs_err=max(v["max_abs_err"] for v in ca["probe"].values()),
             ms=pr["ms"], plain_ms=pr["plain_ms"], bound_ms=pr["bound_ms"],
             bound_by=pr["bound_by"], library_ms=None, shape=f"nq={nq} "
             f"k={k2} d=128 p=16", device_us=pr["device_us"],
             split_plan=pr["plan"], mm_ms=ca["mm_ms"],
             p64_ms=ca["probe"][64]["ms"],
             p64_plain_ms=ca["probe"][64]["plain_ms"],
             p64_bound_ms=ca["probe"][64]["bound_ms"],
             p64_device_us=ca["probe"][64]["device_us"],
             p64_split_plan=ca["probe"][64]["plan"],
             p1_ms=ca["probe"][1]["ms"],
             p1_device_us=ca["probe"][1]["device_us"],
             p1_split_plan=ca["probe"][1]["plan"],
             served_batch={key: ca["probe_batch"][key] for key in
                           ("ms", "plain_ms", "bound_ms", "bound_by",
                            "device_us", "mm_ms", "max_abs_err", "plan")}
             | {"shape": f"nq={SERVE['batch']} k={k2} d=128 p=16"},
             near_tie_slots={p: v["near_tie_slots"]
                             for p, v in ca["probe"].items()}, check=sel),
        dict(name="assign_centroids", route="cuda",
             source="src/repro_torch/kernels/csrc/assign_centroids.cu",
             replaces="src/repro/kernels/centroid_assign.py:189",
             launches=launches["assign_centroids"], launches_note=split_note,
             max_abs_err=max(v["max_abs_err"] for v in ca["assign"].values()),
             ms=asg["ms"], plain_ms=asg["plain_ms"], bound_ms=asg["bound_ms"],
             bound_by=asg["bound_by"], bound_fp32_ms=asg["bound_fp32_ms"],
             bound_note="f32 products at the 3xTF32 rate (495/3 TFLOP/s); "
                        "bound_fp32_ms at the 67 TFLOP/s FP32 rate",
             library_ms=None, shape=f"n={nq} k={k2} d=128",
             device_us=asg["device_us"], split_plan=asg["plan"],
             s1_bit_equal=asg["s1_bit_equal"],
             fault_tf32_inputs_fails=asg["fault_tf32_inputs_fails"],
             mm_ms=ca["mm_ms"],
             n1m={key: ca["assign"]["n1m"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_fp32_ms", "device_us",
                 "max_abs_err", "plan")} | {"mm_ms": ca["mm_1m_ms"]},
             pq_training={key: ca["assign"]["pq"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "bound_fp32_ms",
                 "device_us", "max_abs_err", "plan", "mm_ms")}
             | {"shape": "n=1010000 k=256 d=16"},
             near_tie_slots={key: v["near_tie_slots"]
                             for key, v in ca["assign"].items()},
             check=sel + "; the TF32-rounded-input fault fails; S = 1 and "
                         "the card's plan bit-equal"),
        dict(name="ivf_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ivf_scan.cu",
             replaces="src/repro/kernels/ivf_scan.py:64",
             launches=launches["ivf_scan"], launches_note=split_note,
             max_abs_err=max(v["max_abs_err"] for key, v in sc.items()
                             if key != "ok"),
             ms=s16["ms"], plain_ms=s16["plain_ms"], bound_ms=s16["bound_ms"],
             bound_by=s16["bound_by"], library_ms=None,
             shape=f"nq={nq} nprobe=16 topk=10 d=128",
             device_us=s16["device_us"], bmm_ms=s16["bmm_ms"],
             split_plan=s16["plan"],
             nprobe64={key: sc[64][key] for key in
                       ("ms", "plain_ms", "bound_ms", "device_us", "plan")},
             nprobe1_topk100={key: sc[1][key] for key in
                              ("ms", "plain_ms", "bound_ms", "device_us",
                               "exhausted_slots", "plan")},
             served_batch={key: sc["batch"][key] for key in
                           ("ms", "plain_ms", "bound_ms", "bound_by",
                            "device_us", "bmm_ms", "max_abs_err",
                            "near_tie_slots", "rows_per_query", "plan")}
             | {"shape": f"nq={SERVE['batch']} nprobe=16 topk=10 d=128"},
             near_tie_slots={f"{a}/{b}": sc[a]["near_tie_slots"]
                             for a, b in ((16, 10), (64, 10), (1, 100))},
             check=sel),
    ]
    adc, grp, grb = cc["adc"], cc["grouped"], cc["grouped_batch"]
    a8 = adc["pq8"]
    adc_launch = {k: runs[k]["launches"]["ivf_scan_adc"]
                  for k in ("int8", "pq")}

    def brief(chk, *extra):
        return {key: chk[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "device_us",
                                          "max_abs_err", "near_tie_slots")
                + extra}
    kernels += [
        dict(name="ivf_scan_adc", route="cuda",
             source="src/repro_torch/kernels/csrc/ivf_scan_adc.cu",
             replaces="src/repro/kernels/ivf_scan_adc.py:76",
             launches=sum(adc_launch.values()), launches_by_path=adc_launch,
             max_abs_err=max(v["max_abs_err"] for v in adc.values()),
             ms=a8["ms"], plain_ms=a8["plain_ms"], bound_ms=a8["bound_ms"],
             bound_by=a8["bound_by"], library_ms=None,
             shape=f"nq={nq} nprobe=16 topk=40 PQ nsub=8 (M=8, W=256)",
             device_us=a8["device_us"], near_tie_slots=a8["near_tie_slots"],
             split_plan=a8["plan"], launches_note=split_note,
             int8=brief(adc["int8"], "lut_bytes", "plan"),
             pq32=brief(adc["pq32"], "lut_bytes", "plan"),
             served_batch={
                 key: brief(adc[f"{key}_batch"], "plan", "rows_per_query")
                 | {"shape": f"nq={SERVE['batch']} nprobe=16 topk=40"}
                 for key in ("pq8", "int8")},
             check="vs plain: |part err| <= 1e-5*(vnorm + sum_m "
                   "|lut[m,code[m]]| + |qconst|) per slot, -1/+inf pattern "
                   "exact, positions and ids equal but at near-ties; planted "
                   "faults fail"),
        dict(name="ivf_scan_grouped", route="cuda",
             source="src/repro_torch/kernels/csrc/ivf_scan_grouped.cu",
             replaces="src/repro/kernels/ivf_scan.py:149",
             launches=runs["qgroup8"]["launches"]["ivf_scan_grouped"],
             launches_note=split_note,
             max_abs_err=max(grp["max_abs_err"], grb["max_abs_err"]),
             ms=grp["ms"], plain_ms=grp["plain_ms"],
             bound_ms=grp["bound_ms"], bound_by=grp["bound_by"],
             library_ms=None, shape=f"nq={nq} G=8 nprobe=16 topk=10 d=128",
             device_us=grp["device_us"], split_plan=grp["plan"],
             bmm_ms=grp["bmm_ms"], near_tie_slots=grp["near_tie_slots"],
             union_rows_per_group=grp["union_rows_per_group"],
             rows_per_query=grp["rows_per_query"],
             served_batch=brief(grb, "plan", "bmm_ms", "union_slots")
             | {"shape": f"nq={SERVE['batch']} G=8 nprobe=16 topk=10 "
                         "d=128"},
             check=sel),
    ]
    pws = pw["shapes"]
    s1m = pws["sift1m"]
    kernels.append(dict(
        name="pairwise_sq", route="cuda",
        source="src/repro_torch/kernels/csrc/pairwise_sq.cu",
        replaces="src/repro/kernels/pairwise_topk.py:49",
        launches=pw["launches"],
        launches_note="the phase's own counted ops.pairwise_sq calls, one "
                      "per shape: no path of the system calls the kernel",
        max_abs_err=max(v["max_abs_err"] for v in pws.values()),
        max_err_over_limit=max(v["max_err_over_limit"]
                               for v in pws.values()),
        ms=s1m["ms"], plain_ms=s1m["plain_ms"], bound_ms=s1m["bound_ms"],
        bound_by=s1m["bound_by"], library_ms=None, shape=s1m["shape"],
        device_us=s1m["device_us"], bmm_ms=s1m["bmm_ms"],
        baddbmm_ms=s1m["baddbmm_ms"],
        other_shapes={key: {k: v[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "device_us",
            "bmm_ms", "baddbmm_ms", "max_abs_err", "max_err_over_limit")}
            for key, v in pws.items() if key != "sift1m"},
        check=f"vs plain: |err| <= {PAIR_RTOL:g}*(||x_i||²+||x_j||²) per "
              "element, finite and >= 0, D[b] exactly symmetric; planted "
              "faults fail"))
    bp = base["paths"]

    def at_shape(chk, *extra):
        return {key: chk[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "device_us",
                                          "max_abs_err") + extra}
    by_name = {kd["name"]: kd for kd in kernels}
    for name, paths in (("gather_score", ("kgraph_gk_means", "probe_source",
                                          "closure")),
                        ("refine_merge", ("nn_descent",)),
                        ("probe_centroids", ("probe_source",)),
                        ("assign_centroids", ("lloyd", "minibatch"))):
        by_name[name]["baselines_launches"] = {
            path: bp[path]["launches"][name] for path in paths}
    gsb = base["gather_score"]
    by_name["gather_score"]["baselines_shapes"] = {
        key: {m: {f: gsb[key][m][f] for f in (
            "ms", "plain_ms", "device_us", "max_abs_err",
            "max_err_over_limit")} for m in ("bkm", "lloyd")}
        | {f: gsb[key][f] for f in ("bound_ms", "bound_by", "shape")}
        for key in ("probe", "closure")}
    by_name["refine_merge"]["baselines_shapes"] = {
        "nn_descent": at_shape(base["refine_merge"])
        | {"shape": f"B={BASE['nnd_chunk']} C={2 * BASE['nnd_sample']} "
                    f"kappa={BASE['kappa']}"}}
    for name, key in (("probe_centroids", "probe"),
                      ("assign_centroids", "assign")):
        by_name[name]["baselines_shapes"] = {
            key: at_shape(base["shapes"][key], "plan", "shape")}
    for kd in kernels:
        kd["sharded_launches"] = sharded["launches"].get(kd["name"], 0)
        kd["autotune"] = autotune_field(kd["name"], analysis["autotune"])
    phase_s["total"] = time.perf_counter() - t_all
    log(f"total {phase_s['total']:.1f} s; failures: {failures}")
    if failures:
        return 1
    print(json.dumps({"sharded": {k: sharded[k] for k in (
        "seconds", "emulation", "group", "launches", "checks")}}),
        flush=True)
    print(json.dumps({"baselines": base["paths"]
                      | {"sift_small": base["sift_small"]}}), flush=True)
    print(json.dumps({"kv_cluster": kv_out}), flush=True)
    print(json.dumps({"dryrun": analysis}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"lm_serve": lm}), flush=True)
    print(json.dumps({"lm_moe": moe_out}), flush=True)
    print(json.dumps({"lm_ssm": ssm_out}), flush=True)
    print(json.dumps({"lm_hybrid": hybrid_out}), flush=True)
    print(json.dumps({"lm_audio_vlm": av_out}), flush=True)
    print(json.dumps({"lm_train": train_out}), flush=True)
    print(json.dumps({"phase_seconds": phase_s}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
