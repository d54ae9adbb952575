#!/usr/bin/env python3
"""GPU smoke run of the torch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases (each prints its lines; any failure exits non-zero before the
result lines):

1. the card: ``nvidia-smi`` name and power limit, TF32 switched off;
2. the build: ``nvcc`` compiles the CUDA sources of the port, one process
   per source, all at once; ptxas's registers and spills per kernel (and
   shared memory of the round kernel's stream instance), the wgmma (HGMMA)
   and TMA-load (UTMALDG) instructions ``cuobjdump -sass`` finds in the
   tensor-core flash instance (``flash_tc_kernel<64|128|256>``, none of
   which may spill), the bulk copies (UBLKCP) in the stream
   instances of ``csvm_round_block`` and of the two-pass update
   (``update_stream_kernel``), and the wgmma, its waits and the
   copies (UTMALDG, UBLKCP, LDGSTS) of the tensor-core passes of
   ``ssd_scan``, and the wgmma, TMA loads and waits of the tensor-core
   kernels of ``flash_attention_backward`` and of ``ssd_scan_backward``
   (``bwd_tc_chunk_pass``, ``bwd_tc_grad_pass<NP, PP>``) with ptxas's
   spill report (a count of 0 where the design needs the instruction, a
   wait after every wgmma of an SSD pass or a backward kernel, a spill in a
   backward tensor-core kernel, or a forward SSD pass whose counts moved
   from ``FORWARD_SSD_SASS``, fails the run);
3. the CSVM kernels: each against its plain torch version on the card,
   at the paper's design size and at the full size below, in fp32 and
   bf16, with held rounds, ``nact = 0``, lambda vectors and
   ``lam0 > 0`` — ``csvm_round_block``, ``csvm_block_update`` and
   ``csvm_local_update`` each on both its instances (``stream``, one read
   of X a round or update, and ``direct``, the earlier design); then their
   times (CUDA events) beside the plain versions' and the bound, the two
   instances and the plain version in turns with their effective TB/s and
   the floor of one read of X a pass (each stream instance must take at
   most 0.6x the direct one's time);
4. the fit path at full size — ``SimConfig(p=4095, s=10, m=16, n=1024,
   rho=0.5)`` on ``erdos_renyi(16, 0.5, seed=0)``, X (16, 1024, 4096):
   ``decsvm_fit`` under ``megakernel`` (with and without
   ``track_history``) and ``pallas``, ``decsvm_fit_tol`` (KKT stop) under
   ``megakernel_bf16``, each against the plain ``jnp`` backend on the
   card, with the launch counters read around the fits (every
   ``csvm_round_block`` launch, and every two-pass launch of the
   ``track_history`` and ``pallas`` fits, on the stream instance); the KKT
   fits must stop before ``max_iter`` and within one check block of each
   other;
   then the lambda path on the same data: ``tuning.select_lambda_path`` on
   a 12-point ``lambda_grid`` (300 rounds) in batched mode (one
   ``csvm_round_block`` launch per point) and in warm mode with the KKT
   stop at 1e-3 (one fused 4-round + KKT launch per check block) under
   ``megakernel``, the warm path under ``megakernel_bf16``, and
   ``penalties.decsvm_fit_lla`` on the batched pilot (stage 2: one launch
   with a per-coordinate ``lam_vec``), each against the same call under
   ``jnp`` on the card, with the counters set to 0 around each run and
   the round kernel's device time from CUDA events around its launches;
   then, at the quickstart's design, the CV path (3 folds x 4 points,
   reference rounds only: no kernel) and ``select_lambda_path_many`` (wall times), and the torch
   quickstart (``repro_torch.launch.quickstart``: deCSVM and Tuned F1 >=
   0.9);
   then fit serving (``repro_torch.serving.DecsvmFitServer``): a dense
   bucket of four full-size problems (seed 0 the fits' data, seeds 1-3
   drawn on the card; a shared 12-point grid, batched, SCAD LLA,
   thresholded; one bucket tagged "dense", 4 x 12 + 4
   ``csvm_round_block`` launches), a chunked request on problem 0
   (``engine="auto"``: 12 x 300 ``csvm_block_update`` launches, no round
   kernel; its path within 1e-5 of the dense bucket's), each against the
   same requests under ``jnp`` on the card; at the design size a chunked
   warm request (the plain run's stops), a chunked CV request (3 folds x
   4 points, reference rounds only) and the async worker; the sanitizer
   at full size (300
   two-pass launches, equal to the unchecked fit; a NaN label raises E1
   and a NaN adjacency entry E3, at round 0) and the gossip BIC (300
   rounds, every node within 1e-3 of the exact value) — the
   ``fitserve ...`` lines;
   then the decentralized engines across four ranks of one
   ``torch.distributed`` group on card 0 (gloo, host-staged exchange;
   ``repro_torch.launch.ranks.run_cases``): first both two-pass
   kernels against their plain versions at the node blocks the ranks
   give them ((4 | 8, 1024, 4096), (3 | 5, 200, 101)); then each rank
   draws the full-size problem on the card and runs the sharded gather
   fit under ``megakernel`` and ``pallas`` and the ring fit (node 4: 300
   two-pass launches a rank), the chunked fit with the KKT stop at 2e-2
   (node_chunk 4; it stops before round 300), the batched BIC (node,
   lam) path on the 12-point grid (node 2 x lam 2: 1,800 launches a
   rank), and at the design size the warm path (KKT 1e-3) with and
   without the lam-axis hand-off and the block schedule's raw padded
   state (2 ghost rows); each case against the same call at one rank in
   this process with the same kernels and with the plain ``jnp`` update
   (1e-5 each; the same stops and best lambda, support flips at |b| <=
   1e-5; ghost rows exactly 0); each warm path against the plain
   one-rank traversal of its lam shards (``ranks.lam_shard_warm``: 1e-5,
   the same stops), the hand-off's best lambda equal to the dense warm
   path's and its gap to that path below the gap without it; every
   launch on the stream instance — the ``ranks ...`` lines;
5. ``flash_attention`` against its plain version (``ref.mha``) at the
   shapes of ``tests/test_kernels.py`` (every mask, MQA, D = 32/64/128,
   ragged S), at qwen3-14b's (q (1, 40, S, 128), kv (1, 8, S, 128),
   S = 1023 and 2048, causal, fed as the model's strided views) and at
   the edges of the tensor-core instance (windows, no mask, B = 2 at a
   ragged S, S < 128, D = 64), fp32 and bf16, each case on the instance
   ``ops.flash_instance`` names (bf16 at D = 64/128: tensor cores; the
   rest: fp32 FMAs); then its times beside the plain version's, the
   bound, the fp32-FMA instance's and ``scaled_dot_product_attention``'s
   (timed only, never on the path);
6. the serving path at full width — qwen3-14b (40 layers, d_model 5120,
   bf16, random weights from seed 0) in ``ServeEngine(max_batch=4,
   max_len=2048, block_prefill=True)``: 8 requests of ragged prompt
   lengths, 16 new tokens each, with the launch counters read around the
   run (40 flash launches per prefilled request, every one on the
   tensor-core instance);
7. the kernel against the plain attention inside the model: block-prefill
   logits of a 1023-token prompt at full width in bf16, with 2 layers in
   fp32, and in the reduced config (D = 64, group 2) in bf16;
8. ``ssd_scan`` against its plain version (``ref.ssd_scan``) at the
   shapes of ``tests/test_kernels.py``, at mamba2-370m's (x (1, S, 32,
   64), B and C (1, S, 128), S = 1023, 1999 and 2048, fed as the model's
   strided slices of one conv output) and at the edges of the tensor-core
   instance (b = 2 at a ragged S with heads not a multiple of its group,
   chunk 128 at p = n = 16, one chunk), fp32 and bf16, y and the final
   state, each case on every instance that takes it (``ops.ssd_instance``'s
   choice first: bf16 at chunk 64/128 with p, n multiples of 16 on the
   tensor cores; the fp32-FMA chunk walk wherever its shared memory
   fits); then its times beside the plain version's and the bound (no
   single torch call computes the scan: no library time), the two
   instances in turns, as back-to-back calls and as replays of a CUDA
   graph of one call (the tensor-core one must take at most 0.35x the
   fp32-FMA one's device time);
9. the serving path at full width — mamba2-370m (48 layers, d_model 1024,
   bf16, random weights from seed 0) in the same engine and with the same
   8 requests, with the launch counters read around the run (48
   ``ssd_scan`` launches per prefilled request, every one on the
   tensor-core instance, no ``flash_attention``);
10. the kernel against the plain scan inside the model: block-prefill
   logits and the seeded SSM state of a 1999-token prompt (prime, so the
   last chunk is ragged), with all 48 layers in bf16 (on the tensor-core
   instance) and with 2 layers in fp32;
11. granite-moe-3b-a800m at full width (32 MoE layers, d_model 1536, 40
   experts top 8, bf16, random weights from seed 0): 4 requests through
   the engine with block prefill (32 flash launches each, every one on the
   tensor-core instance at D = 64), the 2 shortest again on one slot with
   block prefill and token by token, with the same tokens; the kernel
   against the plain attention inside the model; the scatter route with
   a capacity that drops nothing
   against the dense route on one layer's output and on the logits, and
   the scatter route at capacity factor 1.25 bit for bit in two runs; the
   head on its features (4 x 32 sequences of 128 tokens);
12. recurrentgemma-2b at full width (26 layers: 8 x (rec, rec, attn) and
   2 tail rec layers, D = 256, window 2048, bf16): a 2,100-token prompt
   (the attention layers' ring caches wrap) and two short ones through the
   engine with block prefill (8 flash launches each, every one on the
   tensor-core instance at D = 256), the shortest again on one slot with
   block prefill and token by token (the first generated token's logits
   within the bf16 limit; then, in an fp32 copy of the model, the same
   greedy tokens); the kernel against the plain attention inside the
   model; the flash at D = 256, S = 2048 and at the long prompt's S =
   2099 (the window active) beside plain, its bound, both instances
   forced in turns (the tensor-core one no slower) and
   ``scaled_dot_product_attention`` (causal; at S = 2099 with a boolean
   window mask); one RG-LRU layer's scan; the head on its features;
13. ``flash_attention`` with keys of their own length (``CROSS_CASES``:
   16 heads of 64 over 1024 frames at 1, 77 and 1000 queries, a ragged Sk
   of 1000, a GQA case at D = 128) and at the encoder's shape
   (``ENCODER_CASE``), non-causal, fed as strided views, against
   ``ref.mha``: fp32 on the fp32-FMA instance, bf16 on both; so too the
   causal self-attention at the shapes the two models' paths give it
   (``CAUSAL_PATH_CASES``); a causal or windowed call with Sk != Sq
   raises before any launch; the encoder and
   cross shapes of phase 14 timed beside plain, the bound and
   ``scaled_dot_product_attention``; then internvl2-1b at full width (24
   layers, d_model 896, 14 heads over 2, bf16): the same 4 requests as
   granite through the engine with block prefill (24 tensor-core launches
   each), the kernel against the plain attention inside the model, the
   forward pass behind a (2, 256, 896) media prefix (24 launches; logits of
   the text positions only, against plain), each within a limit of about
   three of its H100 reading with a control above it, the head on its
   features;
14. seamless-m4t-large-v2 at full width (24 encoder + 24 decoder layers,
   d_model 1024, 16 heads of 64, learned positions, bf16): a lockstep
   batch of four 1000-token prompts, each with its own (1024, 1024) frames,
   and one of a 77-token prompt, through ``prefill`` with ``enc_media``
   and 16 greedy ``decode_step``s (per prefill 24 encoder, 24 decoder and
   24 cross flash launches, counted by path, all on the tensor-core
   instance); the prefill logits with the kernel against the plain
   attention on all three paths (a limit of about three of its H100
   reading, with a control above it); block prefill against token-wise decode
   from ``build_cross_cache`` (bf16: the first token's logits within a
   limit, with a control above it; an fp32 copy: the same tokens, 1e-4).
15. training: ``flash_attention_backward`` (``csrc/flash_backward.cu``)
   against ``ref.mha_backward`` at the shapes the families' training
   gives it (``BACKWARD_CASES``: qwen3-14b, internvl2-1b, seamless's
   encoder and cross-attention, recurrentgemma-2b's window at its long
   prompt's and its training shape), fp32 and bf16 on the model's
   transposed buffers, each on the instance
   ``ops.flash_backward_instance`` names (bf16 at D = 64/128/256: tensor
   cores; fp32: fp32 FMAs), each gradient within its limit
   with a control above it, two launches equal bit for bit; its times
   beside plain, the bound and the backward of
   ``scaled_dot_product_attention``; then qwen3-14b at full width, depth
   cut to 4 layers, bf16: one step's loss and gradients through the
   kernels against the same step with the plain attention (B = 1, limits
   from readings, a control above the gradients' limit; no plain
   attention reached under grad), ``train_loop`` for 10 steps at B = 2 x
   S = 4096 on ``token_stream`` (the counters read around it: 8 flash
   forward launches a step, the pass and its remat, and 4 backward, all
   on the tensor-core instances;
   finite losses; step ms, tokens/s, peak memory, forward plus backward
   against the optimizer), and a checkpoint resume at the reduced config
   (bit for bit);
16. the two instances of ``flash_attention`` and of
   ``flash_attention_backward`` on the same bf16 inputs at every
   ``BACKWARD_CASES`` shape (D = 64/128/256), each forced by name against
   ``ref.mha`` (one bf16 ulp) or ``ref.mha_backward`` (the bf16 limit
   with a control above it), relaunches bit for bit; then the two timed
   in turns beside the bound, the tensor-core one no slower (``time
   flash_attention instances`` and ``time flash_attention_backward
   instances`` lines);
17. mamba2 training: ``ssd_scan_backward`` (``csrc/ssd_backward.cu``)
   against ``ref.ssd_scan_backward`` at ``SSD_CASES`` and at mamba2-370m's
   training shape (b 8, s 2048, 32 heads of 64, n 128, chunk 64), fp32
   and bf16, dfinal None and drawn, mamba2's x, B, C as strided slices of
   one conv output: each gradient within its limit (a share of its max
   |grad|; bf16 dx, dB, dC one ulp beyond it) with a control above it,
   two launches equal bit for bit; its times beside plain and the bound
   at the training shape (split by kernel) and at (1, 2048); then
   mamba2-370m as configured (48 layers, bf16, no cut): one step's loss
   and gradients through the kernels against the same step with the plain
   scan under torch autograd (B = 2 x S = 2048, A_log, D and dt_bias
   among the leaves, a control above the limit; no plain scan reached
   under grad), and so in an fp32 copy cut to 2 layers, ``train_loop``
   for 10 steps at B = 8 x S = 2048 (the
   counters read around it: 2 ``ssd_scan`` launches a layer a step and
   one ``ssd_scan_backward``, all on their tensor-core instances; nothing
   else; finite losses; step ms, tokens/s, peak memory) and a checkpoint
   resume at the reduced config (bit for bit) — the ``check
   ssd_scan_backward``, ``time ssd_scan_backward`` and ``train ...``
   lines;
18. mamba2-370m's step in an fp32 copy at all 48 layers (B = 2 x 2048)
   against the plain-scan step under phase 17's fp32 limits (on a failure
   also at 2, 8 and 24 layers); both instances of ``ssd_scan_backward``
   forced by name on the same bf16 inputs at every ``SSD_BACKWARD_CASES``
   shape the tensor-core one takes (chunk 64), each within phase 17's
   limits with the control above them, relaunches bit for bit, timed in
   turns beside the bound and split by kernel (the tensor-core one no
   slower at the training shape: ``time ssd_scan_backward instances``
   lines); one forward + backward of mamba2-370m (bf16, 48 layers, B = 8
   x 2048) split by kernel with each instance forced (``split ...``
   lines);
19. the remat policies and the sharded train step: qwen3-14b at full
   width cut to 4 layers (phase 15's configuration, B = 2 x 4096), one
   step's loss and every gradient under "dots" and "names" equal to
   "full"'s bit for bit, 2 flash forward launches a layer and 1 backward
   under each, all on "wgmma", then each policy's step time and peak
   memory (``remat ...`` lines); qwen3-14b at full width cut to 2 layers
   on four ranks of mesh (2, 2), placed as ``launch.ranks.spawn`` places
   them (gloo on card 0 with one card), one step of
   ``make_jitted_train_step`` against the one-rank ``make_train_step``
   run first here from the same seed and batch (B = 4 x 1024): every
   rank's loss and gnorm, and its block of every weight and moment,
   within ``SHARD_TOL`` with the controls above it; each rank's peak
   memory, collective ms and flash launches (``sharded ...`` lines);
20. the sharded serve step: qwen3-32b at full width cut to 4 layers on
   four ranks of mesh (1, 4) (gloo on card 0 with one card), B = 8, 16
   steps, against the one-rank eager step run first here from the same
   seed (``SERVE_*``): an fp32 copy's predictions equal at every step and
   its logits within 1e-4, bf16 fed the reference's tokens within
   ``SERVE_TOL`` with the control above it, no ``Gather`` forward and no
   kernel launch in the steps; ms, collective ms and bytes a step
   (``serve-sharded ...`` lines);
21. fit serving across four ranks (gloo on card 0 with one card;
   ``repro_torch.launch.ranks.run_fit_serving``): each rank makes every
   exchange once, untimed, then rank 0 serves through
   ``DecsvmFitServer`` — the full-size chunked request of phase 4c
   (problem 0 drawn on the card, ``erdos_renyi(16, 0.5, seed=0)``,
   ``megakernel``, batched, 300 rounds) on the first 4 points of phase
   4c's shared grid and a dense request of m = 4 by ``run()``, then at
   the design size a chunked warm request (KKT stop) and a chunked SCAD
   LLA + threshold request through ``start()`` / ``result()`` /
   ``stop()`` — broadcasting each chunked bucket, while the other ranks
   follow; the same requests at one rank in this process with the same
   kernels and plain: each result within 1e-5 of both, the same best
   lambda, table lambdas and stops, support flips only within 1e-5; the
   followers' results equal rank 0's bit for bit; the bucket tags, every
   two-pass launch on "stream", no collective in the dense bucket; wall
   a bucket a rank, launches by kernel and instance, host ms in
   ``collective`` a round, the broadcasts' bytes and ms
   (``fitserve-ranks ...`` lines);
22. the dry runs (``repro_torch.launch.dryrun``: one rank's step on meta
   tensors, every kernel on its meta route) against the card: phase 15's
   training step and one decode step of phase 6's serving configuration
   (qwen3-14b, 4 slots, a cache of 2048), each dry-run on mesh (1, 1) and
   then run once on the card — the dry run's argument bytes equal to the
   bytes of the step's input tensors on the card, its predicted peak
   beside ``torch.cuda.max_memory_allocated`` and their ratio (not gated);
   the full-size four-card runs of ``PERF.md`` §5 (qwen3-14b's 40-layer
   train step on (2, 2), qwen3-32b's decode on (1, 4) and (2, 2))
   predicted beside their measurements; ``dryrun.main --all --mesh
   both`` in processes of its own (every record ok) and
   ``dryrun_decsvm`` on both schedules at 256 and 512 nodes (``dry ...``
   lines, each with the card's name and power limit);
23. recurrentgemma-2b trains on the card, as configured (26 layers, 8 of
   them attention at D = 256 with window 2048, bf16; no cut): one step's
   loss and gradients through the kernels against the same step with the
   plain attention (B = 1 x S = 4096, the window active; RG_STEP_TOL from
   readings, a control above the gradients' limit; no plain attention
   reached under grad; every launch on the tensor-core instances),
   ``train_loop`` for 10 steps at B = 2 x S = 4096 on ``token_stream``
   (AdamW, lr 3e-4; the counters read around it: 16 flash forward and 8
   backward launches a step, all on ``"wgmma"``, nothing else; finite
   losses; step ms, forward + backward against the optimizer, tokens/s,
   peak memory on ``train recurrentgemma-2b ...`` lines) and a checkpoint
   resume at the reduced config (bit for bit);
24. granite-moe-3b-a800m trains on the card as configured (32 MoE layers,
   40 experts top 8, 24 heads over 8 of D = 64, bf16; no cut): the flash
   kernels at its training shape against ``ref`` (``check ... training``
   and ``time ... training`` lines, beside the bound and SDPA's forward
   and backward; the forward's unrounded output ``o32`` and the backward
   given delta from it, as ``ops.FlashAttention`` runs them under grad),
   the dry run of its step (``dry-train ...``), one step
   through the kernels against the plain-attention step at B = 1 x 4096,
   ``train_loop`` for 10 steps at B = 2 x 4096 (64 flash forward and 32
   backward launches a step, all ``"wgmma"``, nothing else), the scatter
   route against the dense route at a capacity that drops nothing, the
   scatter step twice at capacity factor 1.25 (bit for bit) and timed
   beside the dense route (``scatter ...`` lines), one step of each route
   split by device kernel (``split ...`` lines), a resume;
25. internvl2-1b the same way behind its 256-position media prefix (3840
   text tokens from ``token_stream``, seeded media; ``make_train_step`` in
   a loop of its own, since ``train_loop`` feeds no media: 48 forward and
   24 backward launches a step) and ``ssd_scan`` timed at mamba2-370m's
   training shape;
26. seamless-m4t-large-v2 the same way through its encoder (1024 frames)
   and cross-attention (the plain step swaps both attentions; its own
   loop: ``train_loop`` feeds no ``enc_media``): 24 encoder, 24 decoder
   and 24 cross calls a pass, each launched twice (pass and remat), 144
   forward and 72 backward launches a step, counted by path.

Between 7 and 8 (phase 7b), on phase 6's qwen3-14b weights: the
decentralized CSVM head (``repro_torch.optim.decsvm_head``) — the
features of 8 nodes x 64 sequences of 256 tokens (d = 5120, p = 5121),
held against the same extraction with the plain attention on the first
128, then the fit of ``launch.decentralized_head`` (ring, lam 0.02, 400
rounds) under ``megakernel`` (one ``csvm_round_block`` launch) and
``pallas`` (400 ``csvm_local_update``), through ``decsvm_fit_sharded``
(gather, one rank: 400 ``csvm_block_update``) and tuned (a 12-point
batched BIC path: 12 round launches), each within 1e-5 of the same call
under ``jnp`` on the card (the tuned one with the same lambda), every
launch on the stream instance.

The last two lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 without the
# tensor cores, bf16 on the tensor cores, device-memory bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# A kernel against its plain version on the same inputs.  fp32: the same
# fp32 arithmetic summed in another order (the repo's fp32 tier).  bf16:
# both sides round B, w and beta_bar to bf16 at the same points, so they
# differ only where an fp32 summation-order difference moves an operand
# across a bf16 rounding boundary; measured on an H100 at the shapes below:
# 2.2e-5 (csvm_round_block, bf16 X (16, 1024, 4096), 5 rounds + KKT) and
# 3e-8 (the two-pass kernels).  The limit holds a few such flips and is
# 100x below the fit tier.
TOL = {"float32": 1e-5, "bfloat16": 1e-4}
# A fit against the plain fp32 fit on the card, the repo's tiers
# (tests/test_solver.py): fp32 1e-5; bf16 1e-2 with sign-exact support on
# |B| > 1e-2 (bf16 X changes the estimator itself).
FIT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# decsvm_fit_tol's KKT stop level: the plain fp32 fit at full size reaches
# it after a little more than half of its 300 rounds (the stopping rounds
# are printed), so the stopping round itself is decided and compared on
# the card.
KKT_TOL = 3e-2
CHECK_EVERY = 4         # decsvm_fit_tol's default check interval
# The lambda path at full size: a 12-point lambda_grid (the quickstart's),
# and the warm path's KKT stop level (the quickstart's).
PATH_NUM = 12
PATH_TOL = 1e-3
# The CV paths at the design size run no kernel (the masked fits take the
# reference rounds), so they are timed on a short grid and few folds.
CV_NUM = 4
CV_FOLDS = 3

# flash_attention against its plain version.  fp32: the repo's kernel
# tier (tests/test_kernels.py:86).  bf16: both sides read the same bf16
# inputs, compute in fp32 and round the output once, so they may differ by
# one bf16 ulp of the output: |dev| <= 2^-7 |o_plain| + 1e-6.
FLASH_TOL_F32 = 2e-5
BF16_ULP = 2.0 ** -7
# (B, H, KV, S, D, causal, window): tests/test_kernels.py:75-105, then
# qwen3-14b's attention at the prompt lengths of the kernel table, then the
# edges of the tensor-core instance (bf16 at D = 64 and 128): windows of 64
# and 17, no mask, a batch of 2 at a ragged S, S below one 128-row q tile,
# and D = 64 at group 2 (the reduced dense configs)
FLASH_CASES = [
    (1, 2, 2, 128, 64, True, None), (2, 4, 2, 256, 64, True, None),
    (1, 4, 1, 128, 32, True, None), (1, 8, 2, 200, 64, True, None),
    (1, 14, 2, 128, 64, True, None), (1, 10, 1, 128, 128, True, None),
    (1, 4, 2, 160, 32, True, None), (1, 4, 2, 160, 32, False, None),
    (1, 4, 2, 160, 32, True, 64), (1, 4, 2, 160, 32, True, 17),
    (1, 40, 8, 1023, 128, True, None), (1, 40, 8, 2048, 128, True, None),
    (1, 8, 2, 300, 128, True, 64), (1, 8, 2, 300, 128, True, 17),
    (1, 8, 2, 300, 128, False, None), (2, 8, 2, 333, 128, True, None),
    (1, 8, 2, 100, 128, True, None), (1, 8, 4, 333, 64, True, None),
]
# The serving path: qwen3-14b at full width, ragged prompts (none a
# multiple of the 64-row tile), 16 new tokens each.
SERVE_PROMPTS = (2000, 1500, 1023, 777, 500, 257, 129, 64)
SERVE_NEW = 16
SERVE_BATCH, SERVE_LEN = 4, 2048
# Block-prefill logits with the kernel against the plain attention inside
# the model, one 1023-token prompt (random weights, seed 0; logits up to
# ~8.7).  fp32 (2 layers): the kernel's fp32 summation order through two
# layers and the LM head; measured 3.05e-5 on an H100.  bf16 (40 layers):
# one-ulp differences of each layer's attention output, carried and
# amplified through 40 layers of bf16 rounding; measured 0.361 on an H100
# (the same bits from run to run: the kernel and the products are
# deterministic).  Each limit is about 3x its measured deviation.
MODEL_PROMPT = 1023
MODEL_TOL = {"float32": 1e-4, "bfloat16": 1.0}

# ssd_scan against its plain version.  fp32: the repo's SSD tier
# (tests/test_kernels.py:120); the two sum the cumulative decays in the
# same order and differ only in the order of the other fp32 sums.  bf16:
# both widen the same bf16 x, B, C exactly, compute in fp32 and round y
# once, so y may differ by one bf16 ulp (the flash limit).  The final
# state is fp32 on both sides: within 5e-5 (1 + |s_plain|), the fp32 tier
# relative to the state's size.
SSD_TOL_F32 = 5e-5
# (b, s, h, p, n, chunk): tests/test_kernels.py:105-108, then mamba2-370m's
# scan at prompt lengths of the serving run (1999 is prime: ragged tail),
# then the edges of the tensor-core instance: b = 2 at a ragged s with 3
# heads (not a multiple of its group of 4), chunk 128 at p = n = 16, and
# a single chunk
SSD_CASES = [
    (1, 64, 2, 8, 16, 32), (2, 128, 3, 16, 32, 64), (1, 96, 4, 32, 128, 32),
    (1, 128, 1, 8, 16, 128),
    (1, 1023, 32, 64, 128, 64), (1, 1999, 32, 64, 128, 64),
    (1, 2048, 32, 64, 128, 64),
    (2, 200, 3, 32, 64, 64), (1, 300, 4, 16, 16, 128), (1, 64, 1, 64, 128, 64),
]
# Block-prefill logits and the seeded SSM state with the kernel against
# the plain scan inside mamba2-370m, one 1999-token prompt (random weights,
# seed 0; logits up to ~3.7, states up to ~1.6).  fp32 (2 layers): the
# kernel's fp32 summation order through two layers and the LM head;
# measured 4.5e-6 (logits) and 3.6e-7 (state) on an H100, held to the
# flash phase's 1e-4.  bf16 (48 layers): one-ulp differences of each
# layer's y, carried and amplified through 48 layers of bf16 rounding;
# measured 0.148 (logits) and 0.0335 (state) on an H100.  The limit is
# about 3x the larger.
MAMBA_PROMPT = 1999
MAMBA_TOL = {"float32": 1e-4, "bfloat16": 0.5}

# The stream instances (one read of X a pass) against the direct ones (two
# reads) in the same call, at the main path's shapes — csvm_round_block in
# fp32 and bf16, csvm_block_update and csvm_local_update in fp32 and
# csvm_block_update in bf16: at most this share of its time.
STREAM_RATIO = 0.6
# ssd_scan's tensor-core instance against the fp32-FMA one on the same
# bf16 inputs in the same call, at mamba2-370m's S = 2048 and 1023: at most
# this share of its device time.
SSD_RATIO = 0.35

# The decentralized CSVM head on frozen backbone features at full width:
# the problem of repro_torch.launch.decentralized_head (a ring of m nodes,
# ADMMConfig(lam=0.02, h=0.3, max_iter=400), labels from a sparse
# hyperplane with 5% of the signs flipped) on qwen3-14b's mean-pooled
# features of m x n sequences of S tokens (d_model 5120: p = 5121 <= 8192,
# so the stream instances run), and on the two other new backbones at a
# smaller size.  Tuned: a 12-point BIC path in batched mode.
HEAD_SHAPE = (8, 64, 256)
BACKBONE_HEAD_SHAPE = (4, 32, 128)
HEAD_ADMM = dict(lam=0.02, h=0.3, max_iter=400)
HEAD_TUNE_NUM = 12
HEAD_FITS = ("megakernel", "pallas", "sharded", "tuned")
# bf16 features (mean-pooled over S after 40 layers) with the kernel
# against the plain attention swapped in, on the first HEAD_PLAIN_SEQS
# sequences (two extraction batches): one-ulp differences of each layer's
# attention output carried through the stack, as the logits check; held
# relative to the features' size, max |dev| <= FEATURE_TOL max |feature|.
FEATURE_TOL = 3e-2
HEAD_PLAIN_SEQS = 128
# granite-moe-3b-a800m: four requests through the engine with block
# prefill, the two shortest also on one slot with block prefill and token
# by token (the same greedy tokens, in bf16); the scatter route with
# a capacity that drops nothing (capacity factor E / k: C = T + 1) against
# the dense one on one layer's bf16 output, relative to its size, and on
# the logits (MODEL_TOL).
GRANITE_PROMPTS = (1000, 300, 77, 33)
GRANITE_TOKENWISE = 2
MOE_LAYER_TOL = 3e-2
# recurrentgemma-2b: one prompt longer than the 2048-token window (its
# attention layers' ring caches wrap) and two short ones; the shortest
# also on one slot with block prefill and token by token.
RG_PROMPTS = (2100, 300, 77)
# Its block prefill against token-wise decode in bf16, on the first
# generated token's logits: the sound readings were 8.30e-2 (max |logit|
# ~5, where a bf16 ulp is 2^-5); the limit is three of them, eight ulps.
# The control (the logits one position earlier) must lie above it.  The
# fp32 copy of the model is held at MODEL_TOL["float32"] and to the
# same tokens.
RG_TOKENWISE_TOL = 0.25
RG_LEN = 2176
NEW_TOKENS = 8
# Cross-attention through flash_attention with keys of their own length
# (non-causal, no window), held against ref.mha with the flash limits;
# (B, H, KV, Sq, Sk, D): seamless-m4t-large-v2's (16 heads of 64 over its
# 1024 encoder frames) at one query, a short and a long prompt, a ragged
# Sk, and a GQA case at D = 128 with a batch of 2.  ENCODER_CASE is its
# encoder's self-attention (non-causal, Sq = Sk = 1024).  Each runs as the
# model feeds the kernel: (B, S, heads, D) buffers through
# ``.transpose(1, 2)``.
CROSS_CASES = [
    (1, 16, 16, 1, 1024, 64), (1, 16, 16, 77, 1024, 64),
    (1, 16, 16, 1000, 1024, 64), (1, 16, 16, 300, 1000, 64),
    (2, 8, 2, 333, 200, 128),
]
ENCODER_CASE = (1, 16, 16, 1024, 1024, 64)
# Causal self-attention at the shapes the two new models' paths give the
# kernel, (B, H, KV, S, D), as strided views of the model's (B, S, heads,
# D) buffers: seamless's lockstep decoder (4 x 1000) and its 77-token row;
# internvl2's longest served prompt (the engine prefills 999 tokens of it
# and decodes the last), its 1023-token in-model prefill, and its forward
# pass behind the media prefix (two rows of 256 + 300 positions).
CAUSAL_PATH_CASES = [
    ("seamless decoder", (4, 16, 16, 1000, 64)),
    ("seamless decoder", (1, 16, 16, 77, 64)),
    ("internvl2 served", (1, 14, 2, 999, 64)),
    ("internvl2 prefill", (1, 14, 2, 1023, 64)),
    ("internvl2 media forward", (2, 14, 2, 556, 64)),
]
# internvl2-1b: granite's four prompts through the engine; the forward
# pass behind a media prefix of its 256 positions, two rows of 300 text
# tokens.
VLM_PROMPTS = GRANITE_PROMPTS
VLM_TEXT = 300
# seamless-m4t-large-v2: a lockstep batch of four 1000-token prompts, each
# with its own 1024 frames, and one row of a 77-token prompt, 16 greedy
# tokens each, over a cache of 1024 + 16 positions.
ENCDEC_PROMPTS = ((1000,) * 4, (77,))
ENCDEC_NEW = 16
ENCDEC_LEN = 1024 + 16
# Its block prefill against token-wise decode from build_cross_cache, on
# the first generated token's logits in bf16 (48 layers of bf16 rounding
# on both paths; the greedy tokens over 256,256 logits may tie): measured
# 3.91e-2 on an H100 (max |logit| ~3, where a bf16 ulp is 2^-6); the limit
# is about three of them, eight ulps, with recurrentgemma's control (the
# logits one position earlier, measured 0.436) above it.  The fp32 copy is
# held at MODEL_TOL["float32"] and to the same tokens.
ENCDEC_TOKENWISE_TOL = 0.125
# The bf16 logits with the kernel against the plain attention inside each
# new model, measured on an H100 (NVIDIA H100 80GB HBM3, 700.00 W):
# 7.23e-2 for internvl2's 1023-token prefill, 0.113 for its forward pass
# behind the media prefix, 5.54e-2 for seamless's 1000-token prefill over
# its 1024 frames (max |logit| 3.3-3.6, where a bf16 ulp is 2^-6).  Each
# limit is about three of its reading, with a control above it: the plain
# logits one position earlier (``position_control``).
VLM_MODEL_TOL = 0.22
VLM_MEDIA_TOL = 0.34
ENCDEC_MODEL_TOL = 0.17

# phase 15: training.  flash_attention_backward at the shapes the families'
# training gives it, (B, H, KV, S, Sk, D, causal, window), every operand
# the model's (B, rows, heads, D) buffer seen through .transpose(1, 2).
BACKWARD_CASES = [
    ("qwen3-14b", (2, 40, 8, 4096, 4096, 128, True, None)),
    ("internvl2-1b", (1, 14, 2, 999, 999, 64, True, None)),
    ("seamless encoder", (4, 16, 16, 1024, 1024, 64, False, None)),
    ("seamless cross", (4, 16, 16, 1000, 1024, 64, False, None)),
    ("recurrentgemma-2b", (1, 10, 1, 2099, 2099, 256, True, 2048)),
    ("recurrentgemma-2b training", (2, 10, 1, 4096, 4096, 256, True, 2048)),
]
# The kernel against ref.mha_backward on the same inputs, each of dq, dk,
# dv.  fp32: max |dev| within BACKWARD_TOL_F32 of max |grad| (the same
# fp32 closed form summed in another order; the first H100 readings were
# 5.6e-6 at qwen3-14b's shape and 4.6e-6 at recurrentgemma-2b's).  bf16:
# both read the same bf16 inputs and round each gradient once, so an entry
# may differ by one bf16 ulp of the plain one, plus that fp32 floor:
# |dev| <= 2^-7 |plain| + BACKWARD_TOL_F32 max |plain| (the first readings
# used 0.77-0.99 of it).  The control: the kernel's dq against the plain dq
# one query row earlier (1.0-1.4 of max |dq|), which must exceed the fp32
# limit.
BACKWARD_TOL_F32 = 2e-5
# qwen3-14b at full width, depth cut 40 -> 4: the kernel step against the
# step with the plain attention (B = 1: its S x S buffers), then train_loop.
TRAIN_ARCH = "qwen3_14b"
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 10
PLAIN_STEP_BATCH = 1
# The kernel step against the plain-attention step (bf16 weights and
# grads): |loss_k - loss_p|, and for each parameter max |g_k - g_p| over
# max |g_p|.  The first H100 reading: loss 1.33e-4 (of 13.006), gradients
# 1.91e-2 at most (layers.2.attn.q_norm; median 1.28e-2): the bf16
# one-ulp differences of the two attentions through 4 layers.  The limits
# are about three of it.  The control, the kernel step's gradients of
# another batch against the plain step's of this one, read 0.944 at its
# smallest leaf; every leaf's control must exceed the gradient limit.
TRAIN_LOSS_TOL = 5e-4
TRAIN_GRAD_TOL = 6e-2
CKPT_ARCH = "qwen3_14b"
CKPT_BATCH, CKPT_SEQ = 2, 128

# phase 17: mamba2 training.  ssd_scan_backward at SSD_CASES and at
# mamba2-370m's training shape (b 8, s 2048, 32 heads of 64, n 128, chunk
# 64), each with dfinal zero (None) and drawn.
SSD_TRAIN_CASE = (8, 2048, 32, 64, 128, 64)
SSD_BACKWARD_CASES = SSD_CASES + [SSD_TRAIN_CASE]
# The kernel against ref.ssd_scan_backward on the same inputs: each
# gradient's max |dev| as a share of its max |grad|.  fp32 outputs (all six
# in fp32; ddt, dA and dD in bf16): the same fp32 closed form summed in
# another order; each limit is about three of the largest reading of a
# first check of the kernel at these shapes, dA's the widest (a sum over
# every row of dt times the reverse cumsum of dcum, whose terms cancel).
# This phase's largest readings on an H100 (NVIDIA H100 80GB HBM3, 700.00
# W, the 256-thread gradient pass) were dx 2.86e-7, ddt 6.09e-7, dA
# 1.22e-5, dB 1.01e-6, dC 3.41e-7, dD 4.89e-7: 0.12-0.72 of the limits.
# bf16 dx, dB, dC: both round the fp32 gradient once, so an entry may
# differ by one bf16 ulp of the plain one plus that floor (readings up to
# 0.96 of it).  The control: the kernel's gradients against plain's for dy
# one row later (``roll``), which must exceed each fp32 limit (its
# smallest reading, 0.11 of max |dD|, is 8.7e4 times dD's limit).
SSD_BACKWARD_TOL = {"dx": 4e-7, "ddt": 2.2e-6, "dA": 1e-4, "dB": 2e-6,
                    "dC": 6e-7, "dD": 1.3e-6}
SSD_GRADS = tuple(SSD_BACKWARD_TOL)
# mamba2-370m as configured (48 layers, d_model 1024, bf16): the kernel
# step against the step with the plain scan (``ssd_chunked`` under torch
# autograd on the card) at B = 2 x S = 2048, then train_loop for
# TRAIN_STEPS steps at B = 8 x S = 2048; the checkpoint resume at the
# reduced config.
MAMBA_TRAIN_ARCH = "mamba2_370m"
MAMBA_STEP_BATCH = 2
MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = 8, 2048
# The kernel step against the plain-scan step: |loss_k - loss_p|, and for
# each parameter max |g_k - g_p| over max |g_p|; the control, another
# batch's kernel gradients against this batch's plain ones, must exceed
# the gradient limit at every leaf.  bf16, 48 layers: the first H100
# reading (NVIDIA H100 80GB HBM3, 700.00 W) was 2.52e-4 on the loss (of
# 11.06) and 0.145 on the gradients (layers.28.mixer.A_log; median
# 4.5e-2): one-ulp differences of each layer's bf16 y carried through 48
# layers (the prefill logits of phase 10 differ by 0.148 the same way),
# largest on A_log and dt_bias, whose gradients are sums over every row
# that cancel.  The limits are about three of it, the gradients' 2.8 of
# it, under the control's smallest leaf (0.46).  fp32, full width cut to
# 2 layers (as phase 10's fp32 check): the fp32 closed form summed in
# another order through two layers; the first reading was 0 on the loss
# and 5.56e-5 on the gradients (layers.0.mixer.A_log; median 9.0e-7), the
# gradients' limit about three of it and the loss's the fp32 tier.
MAMBA_STEP_TOL = {"bfloat16": dict(loss=7.5e-4, grad=0.4),
                  "float32": dict(loss=1e-4, grad=1.7e-4)}
MAMBA_FP32_LAYERS = 2
# phase 18: the same fp32 check on all 48 layers (B = 2 x 2048, the limits
# above), which holds the fma kernel sound through the whole depth; on a
# failure the layer counts of MAMBA_DEPTH_BISECT are read too.
MAMBA_DEPTH_BISECT = (2, 8, 24)

# phase 19: (a) the remat policies on phase 15's configuration (qwen3-14b
# at full width, 4 layers, B = 2 x 4096): one step's loss and every
# gradient under "dots" and "names" against "full" — the same products,
# saved or recomputed, so the same bits are expected (REMAT_TOL 0) — then
# REMAT_STEPS timed steps of each policy (after one warm-up) with their
# peak memory.  (b) the sharded train step on four ranks placed as
# ``launch.ranks.spawn`` places them (NCCL with four cards, else gloo on
# card 0): qwen3-14b at full width, 2 layers, mesh (2, 2), B = 4 x 1024,
# one step from ``init_sharded``'s blocks of ``init_params``' weights,
# against the one-rank ``make_train_step`` run first in this process from
# the same seed and batch (saved whole under build/, read back by mmap,
# block by block).  SHARD_LR makes the first step's update (lr x 1/20 of
# warm-up = 5e-4) about four bf16 ulps of a 0.02 weight, so the weights'
# check sees it.
REMAT_POLICIES = ("full", "dots", "names")
REMAT_STEPS = 3
REMAT_TOL = 0.0
SHARD_ARCH = "qwen3_14b"
SHARD_LAYERS = 2
SHARD_MESH = (2, 2)
SHARD_BATCH, SHARD_SEQ = 4, 1024
SHARD_LR = 1e-2
# The sharded step against the one-rank step, bf16: |loss dev| and |gnorm
# dev| / gnorm; each weight by |w_sharded - w_one| / |w_one - w_before|
# (L2: Adam's first step is about lr x sign(g), so a gradient near 0 that
# rounds to the other sign moves one entry by twice the update, which a
# max would read as a failure); each moment by max |dev| / max |m_one|.
# The sharded gradients differ from the one-rank ones by bf16 rounding
# (each rank's product is rounded before the fp32 reduce-scatter).
# The first H100 reading (NVIDIA H100 80GB HBM3, 700.00 W; gloo, four
# ranks on card 0): loss 0, gnorm 6.81e-6, weights 0.199
# (layers.1.attn.k_norm, 128 entries: one entry's flip is a large share;
# median 2.4e-2), m 7.64e-3, v 1.53e-2.  Limits: about three of it (the
# loss's, read 0, the fp32 tier).  Controls: the loss and gnorm of another
# batch from the same weights (the first reading 1.97e-2 and 9.37e-4);
# the weights before the step and zero moments (1 by construction).
SHARD_TOL = dict(loss=1e-4, gnorm=2e-5, params=0.6, m=2.3e-2, v=4.6e-2)

# phase 20: the sharded serve step (tensor-parallel decode over "model", a
# sequence-sharded cache) on four ranks placed as ``launch.ranks.spawn``
# places them (gloo on card 0 with one card): qwen3-32b at full width,
# depth cut 64 -> 4 (3.5 B parameters, 14 GB in fp32), mesh (1, 4), B = 8,
# a cache of SERVE_MAX_LEN (16 slots a rank), SERVE_STEPS steps from an
# 8-token prompt (stepped in, then greedy), against the one-rank eager
# ``make_serve_step`` run first here from the same seed and saved under
# build/ (``serve.reference_run``).  An fp32 copy on its own tokens: the
# same predictions at every step, logits within SERVE_TOL["float32"] (the
# fp32 tier).  bf16 fed the reference's tokens: logits within
# SERVE_TOL["bfloat16"], with the control — the reference one position
# earlier — above it.  No ``Gather`` forward in the timed steps.  The
# first H100 reading (NVIDIA H100 80GB HBM3, 700.00 W; gloo, four ranks on
# card 0): fp32 2.55e-5 with equal predictions; bf16 0.113, the control
# 7.75.  The bf16 limit is about three of it.
SERVE_ARCH = "qwen3_32b"
SERVE_LAYERS = 4
SERVE_MESH = (1, 4)
SHARD_SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX_LEN = 8, 8, 16, 64
SERVE_TOL = {"float32": 1e-4, "bfloat16": 0.34}

# phase 21: fit serving across four ranks (``ranks.run_fit_serving``) on the
# first FIT_RANKS_NUM points of phase 4c's shared grid: gloo on one card
# exchanges every round through the host, so the full 12-point request is
# left to the four-card run (``python3 -m repro_torch.launch.ranks
# --fit-serving --ranks 4``).  Each result is held to the one-rank server's
# at ``ranks.TOL``, which is FIT_TOL["float32"].
FIT_RANKS = 4
FIT_RANKS_NUM = 4

# phase 22: the dry runs (``launch.dryrun``: one rank's step on meta
# tensors) against the card.  (a) phase 15's training step (TRAIN_ARCH
# cut to TRAIN_LAYERS, B = TRAIN_BATCH x TRAIN_SEQ) and (b) one decode
# step of phase 6's serving configuration (qwen3-14b as configured, 4
# slots, a cache of 2048), each on mesh (1, 1): dry-run, then run once on
# the card from the same shapes; the dry run's argument bytes must equal
# the bytes of the step's input tensors on the card; its predicted peak
# (argument + temp) is printed beside ``torch.cuda.max_memory_allocated``
# and not gated.  (c) the full-size four-card runs of the sharded train
# and serve steps predicted beside ``PERF.md`` §5's measurements (four
# NVIDIA H100 80GB HBM3, 700.00 W).  (d) ``dryrun.main --all --mesh both`` (DRY_JOBS processes) and
# ``dryrun_decsvm.main --schedule both --multi``, each record ok.
DRY_SERVE_ARCH = "qwen3_14b"
DRY_SERVE_BATCH, DRY_SERVE_LEN = 4, 2048
DRY_FOUR_CARD = (
    ("train", "qwen3_14b", (2, 2), 4, 4096,
     "PERF.md §5: 2.10400-3.62004 s a step, peak 56.79 GB a card"),
    ("decode", "qwen3_32b", (1, 4), 8, 4096,
     "PERF.md §5: 359.62-560.90 ms a token, peak 18.64 GB a card, "
     "51.01 MB of collectives a step"),
    ("decode", "qwen3_32b", (2, 2), 8, 4096,
     "PERF.md §5: 363.61-478.99 ms a token, peak 35.02 GB a card, "
     "25.51 MB of collectives a step"),
    ("train", "glm4_9b", (2, 2), 4, 4096, "PERF.md §5"),
    ("decode", "command_r_35b", (1, 4), 8, 4096, "PERF.md §5"),
    ("decode", "command_r_35b", (2, 2), 8, 4096, "PERF.md §5"))
DRY_JOBS = 7
DRY_DEADLINE_S = 300.0

# phase 23: recurrentgemma-2b trains on the card, as configured (26
# layers: 8 x (rec, rec, attn) and 2 tail rec layers, d_model 2560, 10
# heads over 1 of D = 256, window 2048, bf16; no cut): the kernel step
# against the plain-attention step at B = 1 x S = 4096 (the window
# active), then ``train_loop`` for TRAIN_STEPS steps at B = 2 x S = 4096
# (16 flash forward and 8 backward launches a step, all on "wgmma"), and a
# checkpoint resume at the reduced config.
RG_TRAIN_ARCH = "recurrentgemma_2b"
RG_STEP_BATCH = 1
RG_TRAIN_BATCH, RG_TRAIN_SEQ = 2, 4096
# The kernel step against the plain-attention step (bf16 weights and
# grads): |loss_k - loss_p| and, for each parameter, max |g_k - g_p| over
# max |g_p|, as phase 15's.  The first H100 reading (NVIDIA H100 80GB
# HBM3, 700.00 W): loss 1.74e-4 (of 12.991), gradients 5.83e-2 at most
# (layers.10.mixer.lam, an RG-LRU gate; median 1.25e-2): the bf16 one-ulp
# differences of the two attentions carried through 26 layers and the
# recurrences after them.  The limits are about three of it.  The control,
# another batch's kernel gradients against this batch's plain ones, read
# 0.428 at its smallest leaf; every leaf's must exceed the gradient limit.
RG_STEP_TOL = dict(loss=5e-4, grad=0.18)

# phases 24-26: the last three families train on the card as configured
# (no cut): granite-moe-3b-a800m (32 MoE layers, d_model 1536, 24 heads
# over 8 of D = 64, 40 experts top 8, d_ff 512, vocab 49,155 tied) on both
# MoE routes; internvl2-1b (24 layers, d_model 896, 14 heads over 2 of D =
# 64, vocab 151,655 tied) behind its 256-position media prefix;
# seamless-m4t-large-v2 (24 encoder and 24 decoder layers, d_model 1024,
# 16 heads over 16 of D = 64, d_ff 8192, learned positions, vocab 256,206)
# through its encoder and cross-attention; all bf16.  Each phase: the
# kernels at the family's training shapes (FAMILY_KERNEL_CASES), the
# dry run of its step on mesh (1, 1), the kernel step against the
# plain-attention step at B = FAMILY_STEP_BATCH x FAMILY_SEQ, then
# FAMILY_TRAIN_STEPS steps at B = FAMILY_BATCH x FAMILY_SEQ (B = 1 where the
# dry run predicts a peak above FAMILY_PEAK_LIMIT), and a checkpoint resume
# at the reduced config.  JAX's train shape: S = 4096 positions, of which the
# VLM's first 256 are its media prefix; the encoder-decoder's frames are
# min(frontend_len, S / 4) = 1024.
GRANITE_TRAIN_ARCH = "granite_moe_3b_a800m"
VLM_TRAIN_ARCH = "internvl2_1b"
ENCDEC_TRAIN_ARCH = "seamless_m4t_large_v2"
FAMILY_STEP_BATCH = 1
FAMILY_BATCH, FAMILY_SEQ = 2, 4096
FAMILY_PEAK_LIMIT = 75e9
# the timed steps of phases 23-29 (10 until phases 27-29 came: the script
# keeps within its time)
FAMILY_TRAIN_STEPS = 5
# flash_attention and flash_attention_backward at each family's training
# shape, (B, H, KV, Sq, Sk, D, causal, window), bf16, the model's
# (B, rows, heads, D) buffers seen through .transpose(1, 2): against
# ref.mha (one bf16 ulp) and ref.mha_backward (BACKWARD_TOL_F32's bf16
# limit, the control above it), relaunched bit for bit, timed beside the
# bound and scaled_dot_product_attention.  Not BACKWARD_CASES, which
# phase 15 gates.
FAMILY_KERNEL_CASES = {
    GRANITE_TRAIN_ARCH: [
        ("granite-moe-3b-a800m training",
         (2, 24, 8, 4096, 4096, 64, True, None))],
    VLM_TRAIN_ARCH: [
        ("internvl2-1b training", (2, 14, 2, 4096, 4096, 64, True, None))],
    ENCDEC_TRAIN_ARCH: [
        ("seamless decoder training",
         (2, 16, 16, 4096, 4096, 64, True, None)),
        ("seamless encoder training",
         (2, 16, 16, 1024, 1024, 64, False, None)),
        ("seamless cross training",
         (2, 16, 16, 4096, 1024, 64, False, None))],
    # phases 27-29: the GQA groups of 16, 8 and 2 (pass B of the backward
    # splits glm4-9b's group in 4 and command-r-35b's in 2:
    # ops.backward_splits)
    "glm4_9b": [
        ("glm4-9b training", (2, 32, 2, 4096, 4096, 128, True, None))],
    "command_r_35b": [
        ("command-r-35b training", (2, 64, 8, 4096, 4096, 128, True, None))],
    "granite_moe_1b_a400m": [
        ("granite-moe-1b-a400m training",
         (2, 16, 8, 4096, 4096, 64, True, None))],
}
# The kernel step against the plain-attention step (bf16 weights and
# grads), as phases 15 and 23: |loss_k - loss_p| and, for each parameter,
# max |g_k - g_p| over max |g_p|; the control, another batch's kernel
# gradients against this batch's plain ones, must exceed the gradient
# limit at every leaf.  The first H100 readings (NVIDIA H100 80GB HBM3,
# 700.00 W): granite loss 4.11e-4 (of 12.187), gradients 8.07e-2
# (layers.30.moe.w_down; control min 0.90); internvl2 3.48e-4 (of 12.115),
# 5.59e-2 (layers.3.attn.bk; control 0.65); seamless 1.34e-5 (of 12.666),
# 4.31e-2 (layers.16.attn.wk; control 0.69).  Each limit is about three
# of its reading.  seamless read 0.649 (layers.18.attn.wk) while the
# backward took delta = rowsum(do * o) from the bf16 o, whose error its
# decoder's wq and wk gradients magnify: its cross-attention makes every
# position's input nearly alike and those gradients nearly a zero sum
# (``ops.FlashAttention`` now gives the backward delta from the forward's
# unrounded o; csrc/flash_backward.cu).
GRANITE_STEP_TOL = dict(loss=1.2e-3, grad=0.24)
VLM_STEP_TOL = dict(loss=1e-3, grad=0.17)
ENCDEC_STEP_TOL = dict(loss=4e-5, grad=0.13)
# granite's scatter route at capacity factor E / k (C = T·k/E·5 + 1 > T:
# nothing drops) against the dense route, one step from the same weights
# and batch at B = FAMILY_STEP_BATCH x FAMILY_SEQ: the same measures and
# control.  Both routes compute every kept (token, expert) product in
# bf16, but sum the experts in other orders (the dense route's one
# contraction over (e, f), the scatter route's sum over k).  The first
# reading: loss 4.14e-4, gradients 9.78e-2 (layers.29.moe.w_up; control
# min 0.90); the limits about three of it.
SCATTER_STEP_TOL = dict(loss=1.2e-3, grad=0.3)
# the scatter route's step at the configured capacity factor timed beside
# the dense route's train_loop at B = FAMILY_BATCH x FAMILY_SEQ
SCATTER_TIMED_STEPS = 3

# phases 27-29: the registry's last three configurations on the card.
# glm4-9b (40 layers, d_model 4096, 32 heads over 2 of D = 128, partial
# RoPE 0.5, attention bias, vocab 151,552 untied; 9.40 B parameters) serves
# as configured with phase 6's traffic, block prefill against token-wise
# decode as phase 12 holds it (bf16 first-token logits within a limit with
# a control, an fp32 copy within MODEL_TOL's 1e-4 and the same tokens),
# and trains at full width cut to GLM4_TRAIN_LAYERS layers (2.87 B
# parameters, phase 15's size).  command-r-35b (40 layers, d_model 8192,
# 64 heads over 8 of D = 128, LayerNorm, tied vocab 256,000; 30.28 B
# parameters, 60.6 GB) serves as configured with phase 11's traffic from a
# collected allocator, its peak beside the dry run's decode step, and
# trains cut to COMMAND_R_TRAIN_LAYERS layers (3.51 B: the tied head under
# grad).  granite-moe-1b-a400m (24 layers, d_model 1024, 16 heads over 8 of
# D = 64, 32 experts top 8) serves with phase 11's traffic and trains as
# configured on both MoE routes.
GLM4_ARCH, COMMAND_R_ARCH = "glm4_9b", "command_r_35b"
GRANITE1B_ARCH = "granite_moe_1b_a400m"
GLM4_TRAIN_LAYERS = 8
COMMAND_R_TRAIN_LAYERS = 2
# Prefill logits through the kernel against the plain attention (bf16, a
# MODEL_PROMPT-token prompt), each limit about three of its first H100
# reading (NVIDIA H100 80GB HBM3, 700.00 W): glm4-9b 0.375 (max |logit|
# 7.375; control 10.78), command-r-35b 0.820 (11.25; control 15.0),
# granite-moe-1b-a400m 0.0710 (3.3125; control 0.797, under MODEL_TOL's
# 1.0).  glm4-9b's block prefill against token-wise decode on phase 6's
# 64-token prompt: the first generated token's bf16 logits 0.351 (control
# 8.39; the same eight greedy tokens), the fp32 copy 8.99e-5 (limit 1e-4)
# with the same tokens.
GLM4_MODEL_TOL = 1.1
COMMAND_R_MODEL_TOL = 2.5
GRANITE1B_MODEL_TOL = 0.22
GLM4_TOKENWISE_TOL = 1.05
# The kernel step against the plain-attention step, as phases 24-26, each
# limit about three of its first H100 reading: glm4-9b at 8 layers loss
# 4.16e-4 (of 12.754), gradients 4.45e-2 (layers.6.attn.wq; control min
# 0.99); command-r-35b at 2 layers 1.06e-4 (of 14.108), 2.01e-2 (embed,
# the tied head; control 1.04); granite-moe-1b-a400m 1.91e-4 (of 11.748),
# 7.40e-2 (layers.23.moe.w_gate; control 0.88).  Its scatter route
# against its dense route, as phase 24's: loss 6.68e-5, gradients 7.52e-2
# (layers.23.moe.w_gate; control 0.88).
GLM4_STEP_TOL = dict(loss=1.2e-3, grad=0.13)
COMMAND_R_STEP_TOL = dict(loss=3.2e-4, grad=6e-2)
GRANITE1B_STEP_TOL = dict(loss=5.7e-4, grad=0.22)
GRANITE1B_SCATTER_TOL = dict(loss=2e-4, grad=0.23)

FIT_KERNELS = ("csvm_local_update", "csvm_block_update", "csvm_round_block")
REPLACES = {
    "csvm_local_update": "src/repro/kernels/csvm_update.py:83",
    "csvm_block_update": "src/repro/kernels/csvm_update.py:349",
    "csvm_round_block": "src/repro/kernels/csvm_update.py:277",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:76",
    "flash_attention_backward": "no Pallas kernel: XLA autodiff of "
                                "repro.models.attention._attend "
                                "(src/repro/models/attention.py:74-126)",
    "ssd_scan_backward": "no Pallas kernel: XLA autodiff of "
                         "repro.models.ssm.ssd_chunked "
                         "(src/repro/models/ssm.py:53-106)",
}
SOURCES = {name: "src/repro_torch/kernels/csrc/csvm_update.cu"
           for name in FIT_KERNELS}
SOURCES["flash_attention"] = "src/repro_torch/kernels/csrc/flash_attention.cu"
SOURCES["ssd_scan"] = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SOURCES["flash_attention_backward"] = \
    "src/repro_torch/kernels/csrc/flash_backward.cu"
SOURCES["ssd_scan_backward"] = "src/repro_torch/kernels/csrc/ssd_backward.cu"


def log(*args):
    print(*args, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def _ptxas_entries(log_text: str):
    """(kernel<[type, ][int]>, its "Used ..." line, spills) per entry
    function (``*_kernel`` or ``*_pass``; no <> without template
    arguments) of nvcc's ``-Xptxas -v`` output."""
    out, name, spills = [], None, ""
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '.*?\d+([a-z_]+_"
                          r"(?:kernel|pass))(?:I(f|13__nv_bfloat16)?"
                          r"((?:Li\d+E)*)E)?", line)
        if entry:
            args = []
            if entry.group(2):
                args.append("float" if entry.group(2) == "f" else "bf16")
            args += re.findall(r"Li(\d+)E", entry.group(3) or "")
            name = entry.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif "spill" in line:
            spills = line.strip()
        elif re.search(r"Used \d+ registers", line) and name:
            out.append((name, line, spills))
            name = None
    return out


def ptxas_report(log_text: str):
    """(kernel<[type, ][int]>, registers, spills) per entry function of
    nvcc's ``-Xptxas -v`` output."""
    return [(name, int(re.search(r"Used (\d+) registers", used).group(1)),
             spills) for name, used, spills in _ptxas_entries(log_text)]


def ptxas_smem(log_text: str):
    """{kernel<...>: static shared memory bytes} of the same output (0
    where ptxas reports none)."""
    out = {}
    for name, used, _ in _ptxas_entries(log_text):
        smem = re.search(r"(\d+) bytes smem", used)
        out[name] = int(smem.group(1)) if smem else 0
    return out


def sass_counts(sass_text: str, opcodes=("HGMMA", "UTMALDG")):
    """{function: (count of each opcode)} of ``cuobjdump -sass`` output:
    by default the wgmma and TMA-load instructions each compiled kernel
    issues."""
    counts, fn = {}, None
    for line in sass_text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = [0] * len(opcodes)
        elif fn is not None:
            for i, op in enumerate(opcodes):
                counts[fn][i] += op in line
    return {fn: tuple(c) for fn, c in counts.items()}


def disassemble(build, name: str) -> str:
    """``cuobjdump -sass`` of the library built from source ``name``."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-2000:]}")
    return sass.stdout


FLASH_TC_HEAD_DIMS = (64, 128, 256)


def tensor_core_sass(build):
    """Disassemble the flash library and check that the tensor-core
    instance (``flash_tc_kernel`` at D = 64, 128 and 256) issues wgmma and
    TMA loads, and that ptxas reports no spill for it; returns {D:
    (HGMMA, UTMALDG)}."""
    found = {}
    for fn, (hgmma, utmaldg) in sass_counts(
            disassemble(build, "flash_attention")).items():
        inst = re.search(r"flash_tc_kernelILi(\d+)E", fn)
        if inst:
            found[int(inst.group(1))] = (hgmma, utmaldg)
            log(f"sass flash_tc_kernel<{inst.group(1)}>: {hgmma} HGMMA, "
                f"{utmaldg} UTMALDG")
    spills = {name: line for name, _, line in ptxas_report(
        build.build_log("flash_attention"))
        if name.startswith("flash_tc_kernel")}
    check(set(found) == set(FLASH_TC_HEAD_DIMS) and all(
        h > 0 and u > 0 for h, u in found.values()),
        f"the tensor-core flash instance issues no wgmma or TMA load: "
        f"{found}")
    check(len(spills) == len(FLASH_TC_HEAD_DIMS) and all(
        re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line)
        for line in spills.values()),
        f"ptxas spills in the tensor-core flash instance: {spills}")
    return found


STREAM_KERNELS = ("round_stream_kernel", "update_stream_kernel")


def bulk_copy_counts(sass_text: str):
    """{kernel<dtype>: (UBLKCP, UTMALDG)} of ``cuobjdump -sass`` output for
    the kernels that stream X through the TMA ring: the round kernel's
    stream instance and the two-pass update's, for fp32 and bf16 X."""
    found = {}
    for fn, counts in sass_counts(sass_text, ("UBLKCP", "UTMALDG")).items():
        inst = re.search(r"(%s)I(f|13__nv_bfloat16)E" % "|".join(
            STREAM_KERNELS), fn)
        if inst:
            dtype = "float32" if inst.group(2) == "f" else "bfloat16"
            found[f"{inst.group(1)}<{dtype}>"] = counts
    return found


def bulk_copy_sass(build):
    """Disassemble the CSVM library and check that the stream instances
    (``round_stream_kernel`` and ``update_stream_kernel``, for fp32 and
    bf16 X) issue TMA bulk copies (UBLKCP; UTMALDG with a tensor map);
    returns {kernel<dtype>: (UBLKCP, UTMALDG)}."""
    found = bulk_copy_counts(disassemble(build, "csvm_update"))
    for name, (blk, tma) in found.items():
        log(f"sass {name}: {blk} UBLKCP, {tma} UTMALDG")
    want = {f"{k}<{dt}>" for k in STREAM_KERNELS
            for dt in ("float32", "bfloat16")}
    check(set(found) == want and all(b + u > 0 for b, u in found.values()),
          f"a stream kernel issues no bulk copy: {found}")
    return found


SSD_OPCODES = ("HGMMA", "WARPGROUP.DEPBAR", "UTMALDG", "UBLKCP", "LDGSTS")


def ssd_tensor_core_sass(build):
    """Disassemble the SSD library and check that the tensor-core passes
    (``ssd_chunk_pass<Q>`` and ``ssd_output_pass<Q, NP>`` at chunk Q 64
    and 128, NP 64-row panels of n) issue wgmma, and that their wgmmas are
    pipelined: fewer waits (WARPGROUP.DEPBAR) than wgmmas, where ptxas,
    when it serializes them, puts a wait after each.  Log their copies
    too: TMA (UTMALDG, UBLKCP) and cp.async (LDGSTS, the one they use).
    Returns {pass<args>: {opcode: count}}."""
    found = {}
    for fn, counts in sass_counts(disassemble(build, "ssd_scan"),
                                  SSD_OPCODES).items():
        inst = re.search(r"(ssd_(?:chunk|output)_pass)I((?:Li\d+E)+)E", fn)
        if inst:
            args = ", ".join(re.findall(r"Li(\d+)E", inst.group(2)))
            name = f"{inst.group(1)}<{args}>"
            found[name] = dict(zip(SSD_OPCODES, counts))
            log(f"sass {name}: " + ", ".join(
                f"{n} {op}" for op, n in found[name].items()))
    want = {f"ssd_chunk_pass<{Q}>" for Q in (64, 128)} | {
        f"ssd_output_pass<{Q}, {NP}>" for Q in (64, 128)
        for NP in (1, 2, 3, 4)}
    check(set(found) == want and all(
        c["HGMMA"] > 0 for c in found.values()),
        f"the tensor-core ssd_scan passes issue no wgmma: {found}")
    check(all(c["WARPGROUP.DEPBAR"] < c["HGMMA"] for c in found.values()),
          f"ptxas serialized the wgmmas of a tensor-core ssd_scan pass (a "
          f"wait after each): {found}")
    return found


def forward_sass_unchanged(found):
    """The forward's tensor-core passes (``ssd_tensor_core_sass``'s
    counts) against FORWARD_SSD_SASS: the move of their helpers into
    csrc/hopper.cuh must leave the compiled passes as they were."""
    changed = {name: c for name, c in found.items()
               if tuple(c.values()) != FORWARD_SSD_SASS.get(name)}
    log(f"sass ssd_scan passes: {len(found) - len(changed)} of {len(found)} "
        "with the counts of the build before csrc/hopper.cuh took their "
        "helpers")
    check(not changed and len(found) == len(FORWARD_SSD_SASS),
          f"the forward's SASS counts changed: {changed}, expected "
          f"{FORWARD_SSD_SASS}")


# The forward's tensor-core passes as the H100's toolkit compiled them
# before their helpers moved into csrc/hopper.cuh (NVIDIA H100 80GB HBM3,
# 700.00 W; SSD_OPCODES counts: HGMMA, WARPGROUP.DEPBAR, UTMALDG, UBLKCP,
# LDGSTS): the move must leave them as they were.
FORWARD_SSD_SASS = {
    "ssd_output_pass<128, 4>": (105, 4, 0, 0, 29),
    "ssd_output_pass<128, 3>": (85, 4, 0, 0, 29),
    "ssd_output_pass<128, 2>": (65, 4, 0, 0, 29),
    "ssd_output_pass<128, 1>": (45, 4, 0, 0, 29),
    "ssd_chunk_pass<128>": (24, 2, 0, 0, 17),
    "ssd_output_pass<64, 4>": (77, 2, 0, 0, 29),
    "ssd_output_pass<64, 3>": (61, 2, 0, 0, 29),
    "ssd_output_pass<64, 2>": (45, 2, 0, 0, 29),
    "ssd_output_pass<64, 1>": (29, 2, 0, 0, 29),
    "ssd_chunk_pass<64>": (12, 1, 0, 0, 17),
}
SSD_BACKWARD_OPCODES = ("HGMMA", "WARPGROUP.DEPBAR", "LDGSTS")


def ssd_backward_tensor_core_sass(build):
    """Disassemble the SSD backward library and check its tensor-core
    kernels (``bwd_tc_chunk_pass`` and ``bwd_tc_grad_pass<NP, PP>``, NP
    and PP the 64-row panels of n and p, 1 to 4 each): they issue wgmma,
    their wgmmas are pipelined (fewer waits than wgmmas), and ptxas
    reports no spill for them.  Returns {kernel: {opcode: count,
    "registers": n, "spills": ptxas's line}}."""
    found = {}
    for fn, counts in sass_counts(disassemble(build, "ssd_backward"),
                                  SSD_BACKWARD_OPCODES).items():
        inst = re.search(r"(bwd_tc_(?:chunk|grad)_pass)(?:I((?:Li\d+E)+)E)?",
                         fn)
        if inst:
            args = re.findall(r"Li(\d+)E", inst.group(2) or "")
            name = inst.group(1) + (f"<{', '.join(args)}>" if args else "")
            found[name] = dict(zip(SSD_BACKWARD_OPCODES, counts))
    for name, regs, spills in ptxas_report(build.build_log("ssd_backward")):
        if name in found:
            found[name].update(registers=regs, spills=spills)
    for name, c in found.items():
        log(f"sass {name}: " + ", ".join(
            f"{c[op]} {op}" for op in SSD_BACKWARD_OPCODES)
            + f"; ptxas {c.get('registers')} registers, {c.get('spills')}")
    want = {"bwd_tc_chunk_pass"} | {f"bwd_tc_grad_pass<{n}, {p}>"
                                    for n in range(1, 5) for p in range(1, 5)}
    check(set(found) == want and all(
        c["HGMMA"] > 0 for c in found.values()),
        f"a tensor-core ssd_scan_backward kernel issues no wgmma: {found}")
    check(all(c["WARPGROUP.DEPBAR"] < c["HGMMA"] for c in found.values()),
          f"ptxas serialized the wgmmas of a tensor-core ssd_scan_backward "
          f"kernel: {found}")
    check(all(re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                        c.get("spills", "")) for c in found.values()),
          f"ptxas spills in a tensor-core ssd_scan_backward kernel: {found}")
    return found


BACKWARD_OPCODES = ("HGMMA", "UTMALDG", "UBLKCP", "WARPGROUP.DEPBAR")
BACKWARD_TC_KERNELS = ("dq_tc_kernel", "dkdv_tc_kernel")


def backward_tensor_core_sass(build):
    """Disassemble the backward library and check its tensor-core kernels
    (``dq_tc_kernel`` and ``dkdv_tc_kernel`` at D = 64, 128 and 256): they issue
    wgmma and TMA loads, their wgmmas are pipelined (fewer waits than
    wgmmas, where ptxas, when it serializes them, puts a wait after each),
    and ptxas reports no spill for them.  Returns {kernel<D>: {opcode:
    count, "registers": n, "spills": ptxas's line}}."""
    found = {}
    for fn, counts in sass_counts(disassemble(build, "flash_backward"),
                                  BACKWARD_OPCODES).items():
        inst = re.search(r"(%s)ILi(\d+)E" % "|".join(BACKWARD_TC_KERNELS), fn)
        if inst:
            found[f"{inst.group(1)}<{inst.group(2)}>"] = dict(
                zip(BACKWARD_OPCODES, counts))
    for name, regs, spills in ptxas_report(build.build_log("flash_backward")):
        if name in found:
            found[name].update(registers=regs, spills=spills)
    for name, c in found.items():
        log(f"sass {name}: " + ", ".join(
            f"{c[op]} {op}" for op in BACKWARD_OPCODES)
            + f"; ptxas {c.get('registers')} registers, {c.get('spills')}")
    want = {f"{k}<{D}>" for k in BACKWARD_TC_KERNELS
            for D in FLASH_TC_HEAD_DIMS}
    check(set(found) == want and all(
        c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in found.values()),
        f"a tensor-core backward kernel issues no wgmma or TMA load: {found}")
    check(all(c["WARPGROUP.DEPBAR"] < c["HGMMA"] for c in found.values()),
          f"ptxas serialized the wgmmas of a tensor-core backward kernel: "
          f"{found}")
    check(all(re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                        c.get("spills", "")) for c in found.values()),
          f"ptxas spills in a tensor-core backward kernel: {found}")
    return found


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn`` on the card by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(torch, kernel, plain, reps: int, plain_reps: int):
    """A kernel and its plain version timed in turns — kernel, plain,
    plain, kernel — so that drift on the card hits both alike.  Returns
    the two means and the two samples of each."""
    k1 = cuda_ms(torch, kernel, reps)
    p1 = cuda_ms(torch, plain, plain_reps)
    p2 = cuda_ms(torch, plain, plain_reps)
    k2 = cuda_ms(torch, kernel, reps)
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                ms_samples=[k1, k2], plain_ms_samples=[p1, p2])


def bound(flops: float, nbytes: float, peak_flops: float):
    """Least time the card could take: (ms, "operations" | "bytes")."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return ((1e3 * t_ops, "operations") if t_ops >= t_bytes
            else (1e3 * t_bytes, "bytes"))


class Data:
    """One problem on the card: the simulated design, the network, and
    the per-node scalars, plus seeded iterates for the kernel checks."""

    def __init__(self, torch, core, sim, seed=0, device="cuda"):
        import numpy as np
        self.sim = sim
        X, y, self.beta_star = core.generate(sim, seed=seed)
        self.Xn, self.yn = X, y
        self.Wn = core.graph.erdos_renyi(sim.m, sim.p_connect, seed=0)
        self.lam = 1.2 * math.sqrt(math.log(sim.p) / sim.n_total)
        self.h = core.default_bandwidth(sim.n_total, sim.p)
        self.device = dev = torch.device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.X = torch.tensor(X, **f32)
        self.y = torch.tensor(y, **f32)
        self.W = torch.tensor(self.Wn, **f32)
        self.deg = self.W.sum(1)
        self.rho = core.compute_rho(self.X, self.h, "epanechnikov")
        self.lam0 = 0.05
        self.omega = 1.0 / (2.0 * self.deg + self.rho)
        self.omega0 = 1.0 / (2.0 * self.deg + self.rho + self.lam0)
        rng = np.random.default_rng(seed + 1)
        m, p = self.X.shape[0], self.X.shape[2]
        self.B = torch.tensor(rng.standard_normal((m, p)) * 0.05, **f32)
        self.P = torch.tensor(rng.standard_normal((m, p)) * 0.01, **f32)
        self.lam_vec = torch.tensor(
            self.lam * rng.uniform(0.5, 1.5, p), **f32)
        self.lam_flat = torch.full((p,), self.lam, **f32)
        self.neigh = 1.0 * (self.deg[:, None] * self.B + self.W @ self.B)
        self.X16 = self.X.to(torch.bfloat16)

    def x(self, dtype):
        return self.X if dtype == "float32" else self.X16


def compare(torch, got, want, dtype, what):
    """Max |got - want| over the tensors, +inf statistics matched exactly;
    bf16 also needs sign-exact support of B."""
    dev = 0.0
    for g, w in zip(got, want):
        if w.dim() == 0 and torch.isinf(w):
            check(bool(torch.isinf(g)) and float(g) > 0,
                  f"{what}: statistic {float(g)} where the plain version "
                  "gives +inf")
            continue
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
        dev = max(dev, float((g - w).abs().max()))
    if dtype == "bfloat16":
        supp = want[0].abs() > FIT_TOL["bfloat16"]
        check(torch.equal(torch.sign(got[0])[supp], torch.sign(want[0])[supp]),
              f"{what}: bf16 support signs differ")
    check(dev <= TOL[dtype], f"{what}: max |dev| {dev:.3e} > {TOL[dtype]}")
    return dev


def record(devs, name, dtype, dev):
    devs.setdefault(name, {})
    devs[name][dtype] = max(devs[name].get(dtype, 0.0), dev)


def two_pass_runs(ops, name, X, rest, kw, label):
    """``name``'s wrapper on X, then on the card its other instance by
    name (``ops._two_pass_launch``), each run checked to have launched
    once on the instance it names; returns [(instance, B+)] (on the CPU
    one run of the plain version)."""
    fn = getattr(ops, name)
    if X.device.type != "cuda":
        return [("plain", fn(X, *rest, **kw))]
    chosen = ops.two_pass_instance(*X.shape, X.dtype, X.data_ptr())
    runs = []
    for instance in [chosen] + [i for i in ops.TWO_PASS_INSTANCES
                                if i != chosen]:
        before = dict(ops.two_pass_launches)
        got = (fn(X, *rest, **kw) if instance == chosen else
               ops._two_pass_launch(name, X, *rest, instance, **kw))
        ran = {k: v - before[k] for k, v in ops.two_pass_launches.items()}
        check(ran == {k: int(k == instance) for k in ops.TWO_PASS_INSTANCES},
              f"{name} {label}: launched {ran}, expected one {instance} "
              "launch")
        runs.append((instance, got))
    return runs


def kernel_checks(torch, ops, cu, d: Data, label: str, devs: dict):
    """Each kernel's wrapper on the card against its plain version (the
    two-pass updates and the round kernel on both their instances)."""
    nact_t = lambda k: torch.tensor(k, dtype=torch.int32, device=d.device)
    rest = (d.y, d.B, d.P, d.neigh, d.rho, d.omega, d.lam_vec)
    for dtype in ("float32", "bfloat16"):
        X = d.x(dtype)
        want = (cu.csvm_block_update_plain(X, *rest, h=d.h),)
        for instance, got in two_pass_runs(ops, "csvm_block_update", X, rest,
                                           dict(h=d.h), label):
            what = f"csvm_block_update [{instance}] {label} {dtype}"
            dev = compare(torch, (got,), want, dtype, what)
            if instance == "stream":
                check(torch.equal(got, ops.csvm_block_update(X, *rest,
                                                             h=d.h)),
                      f"{what}: two launches gave different bits")
            record(devs, "csvm_block_update", dtype, dev)
            log(f"check {what}: max|dev| {dev:.3e}")
    for kernel in ("epanechnikov", "laplacian"):
        want = cu.csvm_local_update_plain(d.X, *rest, h=d.h, kernel=kernel)
        one = ops.csvm_local_update(d.X[0], d.y[0], d.B[0], d.P[0],
                                    d.neigh[0], d.rho[0], d.omega[0], d.lam,
                                    h=d.h, kernel=kernel)
        plain_one = cu.csvm_local_update_plain(d.X, *rest[:-1], d.lam_flat,
                                               h=d.h, kernel=kernel)[0]
        for instance, got in two_pass_runs(ops, "csvm_local_update", d.X,
                                           rest, dict(h=d.h, kernel=kernel),
                                           label):
            what = f"csvm_local_update [{instance}] {label} {kernel}"
            dev = compare(torch, (got, one), (want, plain_one), "float32",
                          what)
            record(devs, "csvm_local_update", "float32", dev)
            log(f"check {what} (stacked, and one node with a scalar lambda "
                f"on the wrapper's instance): max|dev| {dev:.3e}")
    # (dtype, num_rounds, nact, want_kkt, lam0, lambda vector)
    cases = [("float32", 5, 5, False, 0.0, False),
             ("float32", 5, 3, True, d.lam0, True),
             ("float32", 4, 0, False, 0.0, True),
             ("float32", 4, 0, True, d.lam0, False),
             ("float32", 6, 6, True, 0.0, True),
             ("bfloat16", 5, 5, True, d.lam0, True),
             ("bfloat16", 5, 2, False, 0.0, False),
             ("bfloat16", 4, 0, True, 0.0, True)]
    # on the card each case runs on both instances of the round kernel
    # (the wrapper's choice first); on the CPU the wrapper's plain version
    m, n, p = d.X.shape
    on_card = d.device.type == "cuda"
    for dtype, R, nact, kkt, lam0, vec in cases:
        omega = d.omega0 if lam0 else d.omega
        args = (d.x(dtype), d.y, d.B, d.P, d.W, d.deg, d.rho, omega,
                d.lam_vec if vec else d.lam_flat)
        kw = dict(tau=1.0, lam0=lam0, h=d.h, num_rounds=R, want_kkt=kkt)
        want = cu.csvm_round_block_plain(*args, nact, **kw)
        chosen = ops.round_block_instance(m, n, p, args[0].dtype)
        instances = ([chosen] + [i for i in ops.ROUND_INSTANCES
                                 if i != chosen]) if on_card else ["plain"]
        for instance in instances:
            before = dict(ops.round_block_launches)
            if instance == chosen:
                got = ops.csvm_round_block(*args, nact_t(nact), **kw)
            elif on_card:
                got = ops._round_block_launch(*args, nact_t(nact), instance,
                                              **kw)
            else:
                got = ops.csvm_round_block(*args, nact_t(nact), **kw)
            if on_card:
                ran = {k: v - before[k]
                       for k, v in ops.round_block_launches.items()}
                check(ran == {k: int(k == instance)
                              for k in ops.ROUND_INSTANCES},
                      f"csvm_round_block {label}: launched {ran}, expected "
                      f"one {instance} launch")
            what = (f"csvm_round_block [{instance}] {label} {dtype} "
                    f"rounds={R} nact={nact} kkt={kkt} lam0={lam0} "
                    f"lam_vector={vec}")
            dev = compare(torch, got, want, dtype, what)
            if nact == 0:
                check(torch.equal(got[0], d.B) and torch.equal(got[1], d.P),
                      f"{what}: held rounds changed B or P")
            record(devs, "csvm_round_block", dtype, dev)
            log(f"check {what}: max|dev| {dev:.3e} stat {float(got[2]):.6g}"
                f" (plain {float(want[2]):.6g})")


def in_turns(torch, kernel, earlier, plain, reps: int, plain_reps: int,
             timer=None):
    """A kernel's instance, its earlier instance (None: none to time) and
    its plain version timed in turns — kernel, earlier, plain, plain,
    earlier, kernel — so that drift on the card hits all alike, by
    ``timer(fn, reps)`` (default: CUDA events around back-to-back calls).
    Returns the means and the two samples of each, and kernel / earlier."""
    timer = timer or (lambda fn, r: cuda_ms(torch, fn, r))
    k1 = timer(kernel, reps)
    e1 = timer(earlier, reps) if earlier else None
    p1 = timer(plain, plain_reps)
    p2 = timer(plain, plain_reps)
    e2 = timer(earlier, reps) if earlier else None
    k2 = timer(kernel, reps)
    row = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
               ms_samples=[k1, k2], plain_ms_samples=[p1, p2])
    if earlier:
        row.update(earlier_ms=(e1 + e2) / 2, earlier_ms_samples=[e1, e2])
        row["ratio"] = row["ms"] / row["earlier_ms"]
    return row


def kernel_timings(torch, ops, cu, d: Data, max_iter: int, graph_ms=None):
    """Times at the shapes the main path gives each kernel: the two-pass
    updates (fp32, and csvm_block_update in bf16) and the round kernel
    on both their instances, in turns with the plain versions.  A two-pass
    update's ``ms`` is the device's time, by ``graph_ms`` (replays of a
    CUDA graph of one call), and ``call_ms`` that of back-to-back calls
    (host time included, as a fit's loop pays it)."""
    from repro_torch.kernels import cost
    m, n, p = d.X.shape
    on_card = d.device.type == "cuda"
    two_pass = {}
    rest = (d.y, d.B, d.P, d.neigh, d.rho, d.omega, d.lam_vec)
    for name, plain_fn, dtype in (
        ("csvm_block_update", cu.csvm_block_update_plain, "float32"),
        ("csvm_local_update", cu.csvm_local_update_plain, "float32"),
        ("csvm_block_update", cu.csvm_block_update_plain, "bfloat16"),
    ):
        X = d.x(dtype)
        fn = getattr(ops, name)
        if on_card:
            instance = ops.two_pass_instance(m, n, p, X.dtype, X.data_ptr())
            check(instance == "stream", f"{name} at X ({m}, {n}, {p}) "
                  f"{dtype} takes the {instance} instance, not the stream "
                  "one")
        earlier = (lambda: ops._two_pass_launch(name, X, *rest, "direct",
                                                h=d.h)) if on_card else None
        fns = (lambda: fn(X, *rest, h=d.h), earlier,
               lambda: plain_fn(X, *rest, h=d.h))
        row = in_turns(torch, *fns, 20, 20, timer=graph_ms)
        calls = in_turns(torch, *fns, 20, 20)
        row.update({f"call_{k}": v for k, v in calls.items()})
        # each input read once, B+ written once; 4 flops per element of X
        # (the margin dot and X^T w): ``kernels.cost.two_pass_work``
        isz = X.element_size()
        x_bytes = m * n * p * isz
        flops, nbytes = cost.two_pass_work(m, n, p, isz)
        bms, by = bound(flops, nbytes,
                        PEAK_FP32 if dtype == "float32" else PEAK_BF16)
        row.update(bound_ms=bms, bound_by=by,
                   floor_ms=1e3 * x_bytes / PEAK_BYTES,
                   stream_tbs=x_bytes / row["ms"] / 1e9,
                   shape=f"X ({m}, {n}, {p}) {dtype}, one update")
        if earlier:
            row["earlier_tbs"] = 2 * x_bytes / row["earlier_ms"] / 1e9
        row["faster_than_plain"] = (
            max(row["ms_samples"]) < min(row["plain_ms_samples"])
            and max(calls["ms_samples"]) < min(calls["plain_ms_samples"]))
        two_pass.setdefault(name, []).append(row)
    rows = {name: dict(v[0], variants=v[1:]) for name, v in two_pass.items()}
    variants = []
    for dtype, R, kkt in (("float32", max_iter, False),
                          ("bfloat16", 4, True)):
        args = (d.x(dtype), d.y, d.B, d.P, d.W, d.deg, d.rho, d.omega,
                d.lam_flat)
        kw = dict(tau=1.0, lam0=0.0, h=d.h, num_rounds=R, want_kkt=kkt)
        nact = torch.tensor(R, dtype=torch.int32, device=d.device)
        reps = 3 if R > 10 else 20
        instance = ops.round_block_instance(m, n, p, args[0].dtype)
        check(instance == "stream", f"csvm_round_block at X ({m}, {n}, {p})"
              f" {dtype} takes the {instance} instance, not the stream one")
        # in turns: stream, direct, plain, plain, direct, stream
        earlier = (lambda: ops._round_block_launch(*args, nact, "direct",
                                                   **kw)) if on_card else None
        times = in_turns(torch, lambda: ops.csvm_round_block(*args, nact, **kw),
                         earlier,
                         lambda: cu.csvm_round_block_plain(*args, R, **kw),
                         reps, max(1, reps // 3))
        isz = 4 if dtype == "float32" else 2
        # the margins and X^T w of each round, and once more at beta_bar
        # for the KKT epilogue; the W@B sums (2 m^2 p a round) are left
        # out: ``kernels.cost.round_block_work``
        passes = R + (1 if kkt else 0)
        flops, nbytes = cost.round_block_work(m, n, p, isz, R, kkt)
        bms, by = bound(flops, nbytes,
                        PEAK_FP32 if dtype == "float32" else PEAK_BF16)
        # X must come from device memory once a pass: it does not fit on
        # the chip; the direct instance reads it twice a pass
        x_bytes = m * n * p * isz
        row = dict(times, bound_ms=bms, bound_by=by,
                   floor_ms=1e3 * passes * x_bytes / PEAK_BYTES,
                   stream_tbs=passes * x_bytes / times["ms"] / 1e9,
                   shape=f"X ({m}, {n}, {p}) {dtype}, {R} rounds, "
                         f"want_kkt={kkt}")
        if earlier:
            row["earlier_tbs"] = (2 * passes * x_bytes / row["earlier_ms"]
                                  / 1e9)
        variants.append(row)
    rows["csvm_round_block"] = dict(variants[0], variants=variants[1:])
    for name, row in rows.items():
        for v in [row] + row["variants"]:
            log(f"time {name} [{v['shape']}]: {v['ms']:.4f} ms "
                f"(samples {v['ms_samples'][0]:.4f}, "
                f"{v['ms_samples'][1]:.4f}), plain {v['plain_ms']:.4f} ms "
                f"(samples {v['plain_ms_samples'][0]:.4f}, "
                f"{v['plain_ms_samples'][1]:.4f}), bound "
                f"{v['bound_ms']:.4f} ms ({v['bound_by']})"
                + (f", faster than plain in every sample: "
                   f"{v['faster_than_plain']}"
                   if "faster_than_plain" in v else ""))
    for name, row in rows.items():
        for v in [row] + row["variants"]:
            if "earlier_ms" not in v:
                continue
            log(f"time {name} instances [{v['shape']}]: stream "
                f"{v['ms']:.4f} ms ({v['stream_tbs']:.3f} TB/s, X once a "
                f"pass), direct {v['earlier_ms']:.4f} ms (samples "
                f"{v['earlier_ms_samples'][0]:.4f}, "
                f"{v['earlier_ms_samples'][1]:.4f}; {v['earlier_tbs']:.3f} "
                f"TB/s, X twice a pass), stream/direct {v['ratio']:.3f}; "
                f"floor of one read of X a pass {v['floor_ms']:.4f} ms, the "
                f"roofline bound {v['bound_ms']:.4f} ms")
            if "call_ms" in v:
                log(f"time {name} calls [{v['shape']}]: stream "
                    f"{v['call_ms']:.4f} ms (samples "
                    f"{v['call_ms_samples'][0]:.4f}, "
                    f"{v['call_ms_samples'][1]:.4f}), direct "
                    f"{v['call_earlier_ms']:.4f} ms (samples "
                    f"{v['call_earlier_ms_samples'][0]:.4f}, "
                    f"{v['call_earlier_ms_samples'][1]:.4f}), plain "
                    f"{v['call_plain_ms']:.4f} ms (samples "
                    f"{v['call_plain_ms_samples'][0]:.4f}, "
                    f"{v['call_plain_ms_samples'][1]:.4f}), stream/direct "
                    f"{v['call_ratio']:.3f} (host time included)")
            check(v["ratio"] <= STREAM_RATIO,
                  f"{name} [{v['shape']}]: the stream instance takes "
                  f"{v['ratio']:.3f}x the direct one's time, over "
                  f"{STREAM_RATIO}")
    return rows


def main_path(torch, core, ops, d: Data, max_iter: int = 300,
              kkt_tol: float = KKT_TOL, two_pass=None):
    """The four fits at full size through the port's entry points, each
    held against the plain backend on the card; returns the launches.  On
    the card ``two_pass`` (a dict), where given, receives each two-pass
    update's launches by instance."""
    import numpy as np
    sim = d.sim
    X, y, W = d.Xn, d.yn, d.Wn
    on = dict(device=d.device)

    def cfg(backend):
        return core.ADMMConfig(lam=d.lam, h=d.h, max_iter=max_iter,
                               backend=backend)

    def timed(fn):
        synchronize(torch, d.device)
        t0 = time.perf_counter()
        out = fn()
        synchronize(torch, d.device)
        return out, time.perf_counter() - t0

    def report(name, B, secs, ref=None, tol=None):
        Bn = B.detach().cpu().numpy()
        check(Bn.shape == (sim.m, sim.p + 1), f"{name}: shape {Bn.shape}")
        check(bool(np.isfinite(Bn).all()), f"{name}: non-finite B")
        Bh = core.hard_threshold_final(B, d.lam).cpu().numpy()
        msg = (f"fit {name}: {secs:.3f} s wall, est.err "
               f"{core.metrics.estimation_error(Bn, d.beta_star):.4f}, F1 "
               f"{core.metrics.mean_f1(Bn, d.beta_star):.3f}, F1 after hard "
               f"threshold {core.metrics.mean_f1(Bh, d.beta_star):.3f}, "
               f"support {core.metrics.mean_support_size(Bh):.1f}")
        if ref is not None:
            dev = float(np.max(np.abs(Bn - ref)))
            msg += f", max|dev| vs plain {dev:.3e} (tol {tol:g})"
            check(dev <= tol, f"{name}: max|dev| {dev:.3e} > {tol}")
        log(msg)
        return Bn

    ops.reset_launches()
    counts = lambda: dict(ops.launches)

    ref, s = timed(lambda: core.decsvm_fit(X, y, W, cfg("jnp"), **on))
    ref = report("jnp (plain, reference)", ref, s)

    on_card = d.device.type == "cuda"
    instances = lambda: dict(ops.round_block_launches)

    c0, i0 = counts(), instances()
    B, s = timed(lambda: core.decsvm_fit(X, y, W, cfg("megakernel"), **on))
    report("megakernel", B, s, ref, FIT_TOL["float32"])
    check(ops.launches["csvm_round_block"] - c0["csvm_round_block"] == 1,
          "megakernel fit: expected one csvm_round_block launch")
    if on_card:
        ran = {k: v - i0[k] for k, v in instances().items()}
        check(ran == {"stream": 1, "direct": 0},
              f"megakernel fit: round kernel instances {ran}, expected one "
              "stream launch")

    two_pass = {} if two_pass is None else two_pass

    def on_stream(name, what, c0, j0):
        check(ops.launches[name] - c0[name] == max_iter,
              f"{what} fit: expected one {name} launch per round")
        if on_card:
            ran = {k: v - j0[k] for k, v in ops.two_pass_launches.items()}
            check(ran == {"stream": max_iter, "direct": 0},
                  f"{what} fit: {name} instances {ran}, expected all "
                  f"{max_iter} on the stream instance")
            two_pass[name] = ran

    c0, j0 = counts(), dict(ops.two_pass_launches)
    (B, H), s = timed(lambda: core.decsvm_fit(X, y, W, cfg("megakernel"),
                                              track_history=True, **on))
    report("megakernel track_history", B, s, ref, FIT_TOL["float32"])
    check(tuple(H.shape) == (max_iter, sim.m, sim.p + 1), "history shape")
    on_stream("csvm_block_update", "track_history", c0, j0)

    c0, j0 = counts(), dict(ops.two_pass_launches)
    B, s = timed(lambda: core.decsvm_fit(X, y, W, cfg("pallas"), **on))
    report("pallas", B, s, ref, FIT_TOL["float32"])
    on_stream("csvm_local_update", "pallas", c0, j0)

    tol_kw = dict(tol=kkt_tol, stop_rule="kkt", check_every=CHECK_EVERY)
    (Bt, tt), s = timed(lambda: core.decsvm_fit_tol(X, y, W, cfg("jnp"),
                                                    **tol_kw, **on))
    tt = int(tt)
    ref_tol = report(f"tol kkt {kkt_tol:g} jnp (plain, reference) t={tt}",
                     Bt, s)
    check(tt < max_iter, f"plain KKT fit: tol {kkt_tol:g} not reached in "
          f"{max_iter} rounds, so the stopping round is not compared")

    c0, i0 = counts(), instances()
    (B16, t16), s = timed(lambda: core.decsvm_fit_tol(
        X, y, W, cfg("megakernel_bf16"), **tol_kw, **on))
    t16 = int(t16)
    B16n = report(f"tol kkt {kkt_tol:g} megakernel_bf16 t={t16} (plain "
                  f"t={tt})", B16, s, ref_tol, FIT_TOL["bfloat16"])
    check(abs(t16 - tt) <= CHECK_EVERY,
          f"bf16 KKT fit stopped at t={t16}, the plain fit at t={tt}: more "
          f"than one check block ({CHECK_EVERY} rounds) apart")
    supp = np.abs(ref_tol) > FIT_TOL["bfloat16"]
    check(np.array_equal(np.sign(B16n)[supp], np.sign(ref_tol)[supp]),
          "bf16 tol fit: support signs differ from the fp32 fit")
    n_blocks = ops.launches["csvm_round_block"] - c0["csvm_round_block"]
    check(n_blocks == math.ceil(t16 / CHECK_EVERY),
          f"bf16 tol fit: {n_blocks} csvm_round_block launches for "
          f"t={t16} rounds in blocks of {CHECK_EVERY}")
    if on_card:
        ran = {k: v - i0[k] for k, v in instances().items()}
        check(ran == {"stream": n_blocks, "direct": 0},
              f"bf16 tol fit: round kernel instances {ran}, expected all "
              f"{n_blocks} on the stream instance")
    launches = {name: ops.launches[name] for name in FIT_KERNELS}
    for name in FIT_KERNELS:
        check(launches[name] >= 1, f"fit path never launched {name}")
    log(f"fit path launches: {json.dumps(launches)}; csvm_round_block by "
        f"instance: {json.dumps(instances())}; the two-pass updates by "
        f"instance: {json.dumps(two_pass)}")
    return launches


def lambda_path_phase(torch, core, ops, d: Data, small: Data,
                      max_iter: int = 300, num: int = PATH_NUM,
                      tol: float = PATH_TOL):
    """The lambda path at full size through the port's entry points
    (``tuning.select_lambda_path``, ``penalties.decsvm_fit_lla``), each
    kernel run held against the same call under the plain ``jnp`` backend
    on the card; then the CV path and ``decsvm_path_select_many`` at the
    quickstart design (``small``; wall times only: CV runs no kernel) and
    the torch quickstart.  The counters are set to 0 just before each
    kernel run and read just after.  Returns the phase's launches (by
    kernel and, for the round kernel, by instance), the warm paths' iters
    and the times."""
    import numpy as np
    from repro_torch.launch import quickstart
    from repro_torch.launch.ranks import LaunchTimer
    X, y, W = d.Xn, d.yn, d.Wn
    on = dict(device=d.device)
    on_card = d.device.type == "cuda"
    grid = core.tuning.lambda_grid(X, y, num=num)
    total = {name: 0 for name in FIT_KERNELS}
    instances = {name: 0 for name in ops.ROUND_INSTANCES}
    out = dict(launches=total, round_instances=instances, times={})

    def cfg(backend):
        return core.ADMMConfig(lam=d.lam, h=d.h, max_iter=max_iter,
                               backend=backend)

    def timed(fn):
        synchronize(torch, d.device)
        t0 = time.perf_counter()
        res = fn()
        synchronize(torch, d.device)
        return res, time.perf_counter() - t0

    def kernel_run(label, fn):
        """``fn`` with the counters at 0 and the round kernel's launches
        timed; returns (result, launches by kernel, by instance)."""
        ops.reset_launches()
        with LaunchTimer(ops, "csvm_round_block") as timer:
            res, secs = timed(fn)
        ran = {name: ops.launches[name] for name in FIT_KERNELS}
        inst = dict(ops.round_block_launches)
        for name in FIT_KERNELS:
            total[name] += ran[name]
        for name in instances:
            instances[name] += inst[name]
        if on_card:
            check(inst == {"stream": ran["csvm_round_block"], "direct": 0},
                  f"{label}: round kernel instances {inst}, expected every "
                  "launch on the stream instance")
        dev_ms = timer.ms()
        n = ran["csvm_round_block"]
        out["times"][label] = dict(wall_s=secs, kernel_ms=dev_ms,
                                   launches=n)
        log(f"path {label}: {secs:.3f} s wall, {n} csvm_round_block "
            f"launches" + (f", {dev_ms:.3f} ms of round-kernel device time "
                           f"({dev_ms / max(n, 1):.4f} ms a launch)"
                           if dev_ms is not None else "")
            + f"; launches {json.dumps(ran)}")
        return res, ran

    def plain_run(label, fn):
        res, secs = timed(fn)
        out["times"][label] = dict(wall_s=secs)
        log(f"path {label} (plain, reference): {secs:.3f} s wall")
        return res

    def host(t):
        return t.detach().cpu().numpy()

    def blocks(iters):
        """Round-kernel launches of a warm path: one per check block."""
        return sum(math.ceil(int(t) / CHECK_EVERY)
                   for t in np.asarray(iters).reshape(-1))

    def deviation(label, got, want, tol_):
        dev = float(np.max(np.abs(host(got) - host(want))))
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite path")
        check(dev <= tol_, f"{label}: max|dev| {dev:.3e} vs plain > {tol_}")
        return dev

    def select(backend, mode):
        return core.tuning.select_lambda_path(
            X, y, W, cfg(backend), lams=grid, mode=mode, tol=tol, **on)

    # batched: one round-kernel launch of max_iter rounds per grid point
    ref_b = plain_run("batched jnp", lambda: select("jnp", "batched"))
    got_b, ran = kernel_run("batched megakernel",
                            lambda: select("megakernel", "batched"))
    check(ran["csvm_round_block"] == num,
          f"batched path: {ran['csvm_round_block']} csvm_round_block "
          f"launches, expected one per grid point ({num})")
    dev = deviation("batched path", got_b[3].path, ref_b[3].path,
                    FIT_TOL["float32"])
    check(got_b[0] == ref_b[0], f"batched path: best lambda {got_b[0]} vs "
          f"plain {ref_b[0]}")
    dev_ms = out["times"]["batched megakernel"]["kernel_ms"]
    log(f"path batched: {num} points, best lambda {got_b[0]:.6f}, max|dev| "
        f"vs plain {dev:.3e}" + (f", {dev_ms / num:.3f} ms of device time "
                                 f"a point ({max_iter} rounds)"
                                 if dev_ms is not None else ""))

    # warm: one fused 4-round + KKT launch per check block
    ref_w = plain_run("warm jnp", lambda: select("jnp", "warm"))
    it_ref = host(ref_w[3].iters)
    got_w, ran = kernel_run("warm megakernel",
                            lambda: select("megakernel", "warm"))
    it_got = host(got_w[3].iters)
    out["warm_iters"] = it_got.tolist()
    log(f"path warm tol {tol:g}: iters {it_got.tolist()} (plain "
        f"{it_ref.tolist()}), best lambda {got_w[0]:.6f} (plain "
        f"{ref_w[0]:.6f})")
    check(ran["csvm_round_block"] == blocks(it_got),
          f"warm path: {ran['csvm_round_block']} csvm_round_block launches "
          f"for iters {it_got.tolist()} in blocks of {CHECK_EVERY}")
    check(bool(np.all(np.abs(it_got - it_ref) <= CHECK_EVERY)),
          f"warm path: iters {it_got.tolist()} vs plain {it_ref.tolist()}: "
          "more than one check block apart")
    first = int(np.argmax(it_got != it_ref)) if np.any(
        it_got != it_ref) else num
    if first < num:
        prob = core.solver.make_problem(d.X, d.y, d.W, cfg("jnp"))
        for i in np.nonzero(it_got != it_ref)[0]:
            lam = float(got_w[3].lams[i])
            kkt = [float(core.kkt_residual(prob, cfg("jnp"), r[3].path[i],
                                           lam)) for r in (got_w, ref_w)]
            log(f"path warm point {i}: the KKT residual at its stop is "
                f"{kkt[0]:.6e} (kernel, t={it_got[i]}) and {kkt[1]:.6e} "
                f"(plain, t={it_ref[i]}) against tol {tol:g}")
    dev = deviation("warm path (points up to the first differing stop)",
                    got_w[3].path[:first], ref_w[3].path[:first],
                    FIT_TOL["float32"]) if first else 0.0
    check(got_w[0] == ref_w[0], f"warm path: best lambda {got_w[0]} vs "
          f"plain {ref_w[0]}")
    log(f"path warm: max|dev| vs plain {dev:.3e} over the {first} points "
        "that stopped on the same round")

    # the same warm path with bf16 X, held to the bf16 tier
    got_16, ran = kernel_run("warm megakernel_bf16",
                             lambda: select("megakernel_bf16", "warm"))
    it_16 = host(got_16[3].iters)
    out["warm_bf16_iters"] = it_16.tolist()
    check(ran["csvm_round_block"] == blocks(it_16),
          f"bf16 warm path: {ran['csvm_round_block']} launches for iters "
          f"{it_16.tolist()}")
    check(bool(np.all(np.abs(it_16 - it_ref) <= CHECK_EVERY)),
          f"bf16 warm path: iters {it_16.tolist()} vs plain fp32 "
          f"{it_ref.tolist()}: more than one check block apart")
    dev = deviation("bf16 warm path", got_16[3].path, ref_w[3].path,
                    FIT_TOL["bfloat16"])
    ref_np = host(ref_w[3].path)
    supp = np.abs(ref_np) > FIT_TOL["bfloat16"]
    check(np.array_equal(np.sign(host(got_16[3].path))[supp],
                         np.sign(ref_np)[supp]),
          "bf16 warm path: support signs differ from the fp32 path")
    log(f"path warm bf16: iters {it_16.tolist()}, best lambda "
        f"{got_16[0]:.6f}, max|dev| vs plain fp32 {dev:.3e}")

    # LLA: the batched path's pilot, then stage 2 with a (p,) lambda vector
    def lla(backend):
        return core.penalties.decsvm_fit_lla(X, y, W, cfg(backend),
                                             penalty="scad", lams=grid,
                                             path_mode="batched", **on)
    (B_ref, w_ref) = plain_run("lla jnp", lambda: lla("jnp"))
    (B_lla, w_lla), ran = kernel_run("lla megakernel",
                                     lambda: lla("megakernel"))
    out["lla_launches"] = ran["csvm_round_block"]
    check(ran["csvm_round_block"] == num + 1,
          f"LLA: {ran['csvm_round_block']} csvm_round_block launches, "
          f"expected {num} (pilot path) + 1 (stage 2)")
    dev = deviation("LLA stage 2", B_lla, B_ref, FIT_TOL["float32"])
    wd = deviation("LLA weights", w_lla, w_ref, FIT_TOL["float32"])
    log(f"path lla scad: stage 2 one launch with a per-coordinate lam_vec "
        f"(weights in [{float(w_lla.min()):.3f}, {float(w_lla.max()):.3f}],"
        f" {int((w_lla < 1).sum())} of {w_lla.numel()} below 1), max|dev| "
        f"vs plain {dev:.3e}, weights {wd:.3e}")

    # CV and the problem stack at the quickstart design: wall times only
    s = small
    _, secs = timed(lambda: core.tuning.select_lambda_path(
        s.Xn, s.yn, s.Wn, core.ADMMConfig(lam=s.lam, h=s.h, max_iter=max_iter,
                                          backend="megakernel"),
        num=CV_NUM, mode="batched", criterion="cv", cv_folds=CV_FOLDS,
        **on))
    out["times"]["cv design"] = dict(wall_s=secs)
    log(f"path cv ({CV_FOLDS} folds x {CV_NUM} points, design size, the "
        f"masked fits take the reference rounds: no kernel): {secs:.3f} s "
        "wall")
    X2, y2, _ = core.generate(s.sim, seed=1)
    many, ran = kernel_run("select_many design", lambda: (
        core.tuning.select_lambda_path_many(
            np.stack([s.Xn, X2]), np.stack([s.yn, y2]),
            np.stack([s.Wn, s.Wn]),
            core.ADMMConfig(lam=s.lam, h=s.h, max_iter=max_iter,
                            backend="megakernel"),
            num=num, mode="warm", tol=tol, **on)))
    it_many = host(many[3].iters)
    check(ran["csvm_round_block"] == blocks(it_many),
          f"select_many: {ran['csvm_round_block']} launches for iters "
          f"{it_many.tolist()}")
    log(f"path select_many (2 problems, design size): best lambdas "
        f"{many[0].tolist()}")

    rows, ran = kernel_run("quickstart", lambda: quickstart.run(
        d.device, log=lambda *a: log("quickstart:", *a)))
    for name in ("deCSVM", "Tuned"):
        check(rows[name]["f1"] >= 0.9,
              f"quickstart: {name} F1 {rows[name]['f1']:.3f} < 0.9")
    out["quickstart"] = rows
    log(f"path phase launches: {json.dumps(total)}; csvm_round_block by "
        f"instance: {json.dumps(instances)}")
    return out


class Capture:
    """While active, every call of ``module.<name>`` is passed through and
    its result kept in ``results``, so that a check can read what the fit
    server's own engine call returned (the server keeps only its
    ``FitResult``s)."""

    def __init__(self, module, name):
        self.module, self.name, self.results = module, name, []

    def __enter__(self):
        self.orig = fn = getattr(self.module, self.name)

        def kept(*args, **kw):
            out = fn(*args, **kw)
            self.results.append(out)
            return out
        setattr(self.module, self.name, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def device_problem(torch, core, sim, seed: int, device):
    """A problem drawn by torch on ``device`` from ``seed``
    (``repro_torch.launch.ranks.device_problem``: the law of
    ``core.generate``, not its numbers; milliseconds on the card where
    numpy takes seconds at full size).  Returns (X (m, n, p + 1), y (m, n))
    as fp32 tensors on ``device`` and the network ``erdos_renyi(m,
    p_connect, seed)``."""
    from repro_torch.launch import ranks
    X, y = ranks.device_problem(sim, seed, device)
    return X, y, core.graph.erdos_renyi(sim.m, sim.p_connect, seed=seed)


def fit_serving_phase(torch, core, ops, d: Data, small: Data,
                      max_iter: int = 300, num: int = PATH_NUM,
                      tol: float = PATH_TOL, n_bucket: int = 4,
                      cv_num: int = CV_NUM, cv_folds: int = CV_FOLDS):
    """Fit serving through the port's ``DecsvmFitServer`` on the card: a
    dense bucket of ``n_bucket`` full-size problems (seed 0 is ``d``'s
    data, seeds 1, ... are drawn on the device by ``device_problem``,
    each on ``erdos_renyi(m, p_connect, seed)``; SCAD LLA and the
    Theorem-4 threshold), a chunked request (``engine="auto"``: m > 1
    rank), then at the design size (``small``) a chunked warm request, a
    chunked CV request (``cv_folds`` folds of a ``cv_num``-point grid:
    its cells take the reference rounds, so it is kept small) and the
    async worker; the sanitizer at full size; the gossip
    BIC on the dense bucket's first result.  Each kernel run is held
    against the same requests under the plain ``jnp`` backend on the card,
    with the counters set to 0 just before it and read just after, and the
    kernels' device time from CUDA events around their launches.  Returns
    the phase's launches by kernel and instance, and its times."""
    import numpy as np
    from repro_torch.launch.ranks import LaunchTimer
    from repro_torch.serving import fit as fitmod
    on = dict(device=d.device)
    on_card = d.device.type == "cuda"
    total = {name: 0 for name in FIT_KERNELS}
    rounds = {name: 0 for name in ops.ROUND_INSTANCES}
    two_pass = {name: 0 for name in ops.TWO_PASS_INSTANCES}
    out = dict(launches=total, round_instances=rounds,
               two_pass_instances=two_pass, times={})

    def cfg(data, backend, **kw):
        return core.ADMMConfig(lam=0.0, h=data.h, max_iter=max_iter,
                               backend=backend, **kw)

    def timed(fn):
        synchronize(torch, d.device)
        t0 = time.perf_counter()
        res = fn()
        synchronize(torch, d.device)
        return res, time.perf_counter() - t0

    def kernel_run(label, fn):
        """``fn`` with the counters at 0, both CSVM kernels' launches
        timed; returns (result, launches by kernel)."""
        ops.reset_launches()
        with LaunchTimer(ops, "csvm_round_block") as rt, \
                LaunchTimer(ops, "csvm_block_update") as bt:
            res, secs = timed(fn)
        ran = {name: ops.launches[name] for name in FIT_KERNELS}
        inst_r = dict(ops.round_block_launches)
        inst_t = dict(ops.two_pass_launches)
        for name in FIT_KERNELS:
            total[name] += ran[name]
        for name in rounds:
            rounds[name] += inst_r[name]
        for name in two_pass:
            two_pass[name] += inst_t[name]
        if on_card:
            check(inst_r == {"stream": ran["csvm_round_block"], "direct": 0},
                  f"fitserve {label}: round kernel instances {inst_r}, "
                  "expected every launch on the stream instance")
            n2 = ran["csvm_block_update"] + ran["csvm_local_update"]
            check(inst_t == {"stream": n2, "direct": 0},
                  f"fitserve {label}: two-pass instances {inst_t}, expected "
                  "every launch on the stream instance")
        ms = {"csvm_round_block": rt.ms(), "csvm_block_update": bt.ms()}
        out["times"][label] = dict(wall_s=secs, launches=ran,
                                   round_instances=inst_r,
                                   two_pass_instances=inst_t, kernel_ms=ms)
        dev = ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()
                        if v is not None)
        log(f"fitserve {label}: {secs:.3f} s wall, launches {json.dumps(ran)}"
            f", round instances {json.dumps(inst_r)}, two-pass instances "
            f"{json.dumps(inst_t)}" + (f"; device time {dev}" if dev else ""))
        return res, ran

    def plain_run(label, fn):
        res, secs = timed(fn)
        out["times"][label] = dict(wall_s=secs)
        log(f"fitserve {label} (plain, reference): {secs:.3f} s wall")
        return res

    def serve(reqs, max_batch=16):
        srv = fitmod.DecsvmFitServer(max_batch=max_batch, device=d.device)
        for r in reqs:
            srv.submit(r)
        return srv.run(), srv

    def host(t):
        return t.detach().cpu().numpy()

    def same(label, got, want, paths, N, p, tol_=FIT_TOL["float32"]):
        """FitResults against the plain run's: the same best lambda, B,
        beta and the LLA weights within ``tol_``, the table's lambdas
        equal.  Its support column counts |b| > 1e-8, so a coefficient
        that sits within the fp32 tier of that cut may count in one run
        and not the other: every such flip must lie at |b| <= ``tol_`` in
        both paths (``paths``: the two runs' (B, L, m, p) paths in rid
        order), and the criterion less its support term (the BIC's
        sqrt(log N) log p supp / N) within ``tol_``.  Returns the largest
        deviation, the number of flipped coefficients and the largest gap
        of the support terms."""
        from repro_torch.launch.ranks import bic_support_weight, \
            support_flips
        dev, flips, sgap = 0.0, 0, 0.0
        pen = bic_support_weight(N, p)
        for b, (rid, w) in enumerate(sorted(want.items())):
            g = got[rid]
            check(bool(np.isfinite(g.B).all()), f"{label}: non-finite B")
            check(g.best_lam == w.best_lam, f"{label} rid {rid}: best lambda "
                  f"{g.best_lam} vs plain {w.best_lam}")
            tg, tw = np.array(g.table), np.array(w.table)
            check(np.array_equal(tg[:, 0], tw[:, 0]),
                  f"{label} rid {rid}: the table's lambdas differ")
            bic = g.criterion == "bic"
            hinge = [t[:, 1] - (pen * t[:, 2] if bic else 0.0)
                     for t in (tg, tw)]
            if bic:
                sgap = max(sgap, float(pen * np.abs(tg[:, 2] - tw[:, 2])
                                       .max()))
            parts = [np.abs(g.B - w.B).max(), np.abs(g.beta - w.beta).max(),
                     np.abs(hinge[0] - hinge[1]).max()]
            if w.lam_weights is not None:
                parts.append(np.abs(g.lam_weights - w.lam_weights).max())
            dev = max(dev, float(max(parts)))
            pg, pw = (host(x[b]) for x in paths)
            n_flips, near = support_flips(pg, pw)
            flips += n_flips
            check(near <= tol_, f"{label} rid {rid}: a support flip at "
                  f"|b| = {near:.3e} > {tol_}")
            support = np.mean((np.abs(pg) > 1e-8).sum(axis=-1), axis=-1)
            check(np.array_equal(support, tg[:, 2]),
                  f"{label} rid {rid}: the table's support is not its path's")
        check(dev <= tol_, f"{label}: max|dev| {dev:.3e} vs plain > {tol_}")
        return dev, flips, sgap

    def blocks(iters):
        """Two-pass launches of a warm path: a check block's rounds each."""
        return sum(CHECK_EVERY * math.ceil(int(t) / CHECK_EVERY)
                   for t in np.asarray(iters).reshape(-1))

    # the dense bucket: n_bucket full-size problems, one shared grid
    t0 = time.perf_counter()
    probs = [(d.X, d.y, d.Wn)] + [
        device_problem(torch, core, d.sim, seed, d.device)
        for seed in range(1, n_bucket)]
    grid = core.tuning.shared_lambda_grid(
        np.stack([host(p[0]) for p in probs]),
        np.stack([host(p[1]) for p in probs]), num=num)
    synchronize(torch, d.device)
    log(f"fitserve data: {n_bucket - 1} more problems X "
        f"{tuple(probs[-1][0].shape)} drawn on the device and the shared "
        f"grid in {time.perf_counter() - t0:.1f} s (seeds 1-{n_bucket - 1}; "
        f"seed 0 is the fits' data)")

    def dense_reqs(backend):
        return [fitmod.FitRequest(
            rid=i, X=X, y=y, W=W, cfg=cfg(d, backend), lams=grid,
            mode="batched", penalty="scad", threshold=True, engine="dense")
            for i, (X, y, W) in enumerate(probs)]

    with Capture(core.tuning, "select_lambda_path_many") as many:
        (done, srv), ran = kernel_run("dense", lambda: serve(
            dense_reqs("megakernel")))
        ref, _ = plain_run("dense jnp", lambda: serve(dense_reqs("jnp")))
    log_tags = [(key[-1], size) for key, size in srv.bucket_log]
    check(log_tags == [("dense", n_bucket)],
          f"fitserve dense: bucket log {log_tags}, expected one dense "
          f"bucket of {n_bucket}")
    want_r = n_bucket * num + n_bucket
    out["dense_round_launches"] = ran["csvm_round_block"]
    check(ran["csvm_round_block"] == want_r,
          f"fitserve dense: {ran['csvm_round_block']} csvm_round_block "
          f"launches, expected {n_bucket} x {num} (path) + {n_bucket} (LLA)")
    m, n, p = d.X.shape
    dense_path = many.results[0][3].path                   # (B, L, m, p)
    dev, flips, sgap = same("fitserve dense", done, ref,
                            (dense_path, many.results[1][3].path), m * n, p)
    out["dense_support_gap"] = sgap
    log(f"fitserve dense: {n_bucket} requests in one bucket, best lambdas "
        f"{[done[i].best_lam for i in range(n_bucket)]}, max|dev| vs plain "
        f"{dev:.3e} (B, beta, LLA weights, criterion less its support "
        f"term), {flips} of {dense_path.numel()} path coefficients on the "
        f"other side of the 1e-8 support cut, largest gap of the "
        f"criterion's support terms {sgap:.3e}, train accuracy "
        f"{[round(done[i].train_accuracy, 4) for i in range(n_bucket)]}")

    # one chunked request: problem 0, engine "auto" (m > 1 rank)
    X0, y0, W0 = probs[0]

    def chunked_req(backend, rid=100):
        return [fitmod.FitRequest(rid=rid, X=X0, y=y0, W=W0,
                                  cfg=cfg(d, backend), lams=grid,
                                  mode="batched")]

    with Capture(core.tuning, "select_lambda_path") as one:
        (cdone, csrv), ran = kernel_run("chunked", lambda: serve(
            chunked_req("megakernel")))
        cref, _ = plain_run("chunked jnp", lambda: serve(chunked_req("jnp")))
    tag = csrv.bucket_log[0][0][-1]
    check(tag == "chunked", f"fitserve chunked: bucket tagged {tag!r}")
    out["chunked_launches"] = ran["csvm_block_update"]
    check(ran["csvm_block_update"] == num * max_iter
          and ran["csvm_round_block"] == 0,
          f"fitserve chunked: launches {ran}, expected {num} x {max_iter} "
          "csvm_block_update and no round kernel")
    cpath = one.results[0][3].path
    dev, flips, sgap = same("fitserve chunked", cdone, cref,
                            (cpath[None], one.results[1][3].path[None]),
                            m * n, p)
    pdev = float((cpath - dense_path[0]).abs().max())
    check(pdev <= FIT_TOL["float32"], f"fitserve chunked: path max|dev| "
          f"{pdev:.3e} vs the dense path > {FIT_TOL['float32']}")
    log(f"fitserve chunked: best lambda {cdone[100].best_lam}, max|dev| vs "
        f"plain {dev:.3e} ({flips} support flips, support terms "
        f"{sgap:.3e} apart), path vs the dense bucket's path {pdev:.3e}")
    del many, one, dense_path, cpath

    # the design size: a chunked warm request, a chunked CV request
    s = small

    def warm_req(backend, rid=200):
        return [fitmod.FitRequest(rid=rid, X=s.Xn, y=s.yn, W=s.Wn,
                                  cfg=cfg(s, backend), num=num, mode="warm",
                                  tol=tol)]

    with Capture(core.tuning, "select_lambda_path") as wcap:
        (wdone, _), ran = kernel_run("warm", lambda: serve(
            warm_req("megakernel")))
    with Capture(core.tuning, "select_lambda_path") as wref_cap:
        wref, _ = plain_run("warm jnp", lambda: serve(warm_req("jnp")))
    it = host(wcap.results[0][3].iters)
    it_ref = host(wref_cap.results[0][3].iters)
    out["warm_iters"] = it.tolist()
    out["warm_launches"] = ran["csvm_block_update"]
    check(np.array_equal(it, it_ref), f"fitserve warm: stops {it.tolist()}"
          f" vs plain {it_ref.tolist()}")
    check(ran["csvm_block_update"] == blocks(it),
          f"fitserve warm: {ran['csvm_block_update']} csvm_block_update "
          f"launches for stops {it.tolist()}")
    sm, sn, sp = s.X.shape
    dev, flips, _ = same("fitserve warm", wdone, wref,
                         (wcap.results[0][3].path[None],
                          wref_cap.results[0][3].path[None]), sm * sn, sp)
    log(f"fitserve warm (design size, KKT {tol:g}): stops {it.tolist()}, "
        f"best lambda {wdone[200].best_lam}, max|dev| vs plain {dev:.3e} "
        f"({flips} support flips)")

    cv_req = [fitmod.FitRequest(rid=300, X=s.Xn, y=s.yn, W=s.Wn,
                                cfg=cfg(s, "megakernel"), num=cv_num,
                                mode="batched", criterion="cv",
                                cv_folds=cv_folds)]
    (cvdone, _), ran = kernel_run("cv", lambda: serve(cv_req))
    check(sum(ran.values()) == 0, f"fitserve cv: launches {ran}: the masked "
          "cells take the reference rounds")
    check(bool(np.isfinite(cvdone[300].B).all())
          and len(cvdone[300].table) == cv_num, "fitserve cv: bad result")
    log(f"fitserve cv (design size, {cv_folds} folds x {cv_num} points + "
        f"{cv_num} full-data cells, reference rounds only): "
        f"{out['times']['cv']['wall_s']:.3f} s wall, best lambda "
        f"{cvdone[300].best_lam}")

    def async_run():
        srv = fitmod.DecsvmFitServer(device=d.device)
        srv.start()
        try:
            h = srv.submit(warm_req("megakernel", rid=400)[0])
            return h.result(timeout=600), srv.utilization
        finally:
            srv.stop()
    (ares, util), ran = kernel_run("async", async_run)
    dev = float(np.abs(ares.B - wdone[200].B).max())
    check(dev <= FIT_TOL["float32"] and ares.best_lam == wdone[200].best_lam,
          f"fitserve async: max|dev| {dev:.3e} vs the synchronous run")
    log(f"fitserve async: start/submit/result/stop, max|dev| vs the "
        f"synchronous run {dev:.3e}, utilization after stop {util}")

    # the sanitizer at full size: the same fit, with and without the checks
    fcfg = core.ADMMConfig(lam=d.lam, h=d.h, max_iter=max_iter,
                           backend="megakernel")
    B, ran = kernel_run("sanitize off", lambda: core.decsvm_fit(
        d.X, d.y, d.W, fcfg, **on))
    check(ran["csvm_round_block"] == 1 and ran["csvm_block_update"] == 0,
          f"fitserve sanitize off: launches {ran}, expected one round launch")
    Bs, ran = kernel_run("sanitize", lambda: core.decsvm_fit(
        d.X, d.y, d.W, dataclasses.replace(fcfg, sanitize=True), **on))
    out["sanitize_launches"] = ran["csvm_block_update"]
    check(ran["csvm_block_update"] == max_iter
          and ran["csvm_round_block"] == 0,
          f"fitserve sanitize: launches {ran}, expected {max_iter} "
          "csvm_block_update and no round kernel")
    dev = float((Bs - B).abs().max())
    check(dev <= FIT_TOL["float32"], f"fitserve sanitize: max|dev| {dev:.3e}"
          " vs the unchecked fit")
    errors = []
    for code, name, at in (("E1", "y", (1, 3)), ("E3", "W", (0, 1))):
        y_, W_ = d.y.clone(), d.W.clone()
        (y_ if name == "y" else W_)[at] = float("nan")
        try:
            core.decsvm_fit(d.X, y_, W_, dataclasses.replace(
                fcfg, sanitize=True), **on)
            err = None
        except core.sanitize.SanitizerError as e:
            err = e
        check(err is not None and err.code == code and err.round == 0,
              f"fitserve sanitize: a NaN at {name}{list(at)} raised {err!r},"
              f" expected {code} at round 0")
        errors.append(str(err))
    log(f"fitserve sanitize: max|dev| vs the unchecked fit {dev:.3e}; "
        f"poisoned: {errors}")

    # the gossip BIC on the dense bucket's first result
    (per_node, exact), secs = timed(lambda: core.gossip.decentralized_bic(
        d.X, d.y, done[0].B, d.Wn, rounds=300))
    gap = float((per_node - exact).abs().max())
    check(gap < 1e-3 * max(abs(exact), 1.0),
          f"fitserve gossip: per-node BIC {gap:.3e} from the exact {exact}")
    out["times"]["gossip"] = dict(wall_s=secs)
    log(f"fitserve gossip: decentralized BIC, 300 rounds, {secs:.3f} s wall;"
        f" exact {exact:.6f}, max per-node gap {gap:.3e}")
    log(f"fitserve phase launches: {json.dumps(total)}; round instances "
        f"{json.dumps(rounds)}; two-pass instances {json.dumps(two_pass)}")
    return out


def block_checks(torch, ops, cu, d: Data, nodes: int, label: str,
                 devs: dict):
    """Both two-pass wrappers against their plain versions on the first
    ``nodes`` nodes of ``d``: the shape of a node block that a rank of
    phase 4d gives them (each instance on the card)."""
    X = d.X[:nodes]
    rest = (d.y[:nodes], d.B[:nodes], d.P[:nodes], d.neigh[:nodes],
            d.rho[:nodes], d.omega[:nodes], d.lam_vec)
    for name, kw in (("csvm_block_update", dict(h=d.h)),
                     ("csvm_local_update", dict(h=d.h,
                                                kernel="epanechnikov"))):
        want = getattr(cu, f"{name}_plain")(X, *rest, **kw)
        for instance, got in two_pass_runs(ops, name, X, rest, kw, label):
            what = f"{name} [{instance}] {label}"
            dev = compare(torch, (got,), (want,), "float32", what)
            record(devs, name, "float32", dev)
            log(f"check {what}: max|dev| {dev:.3e}")


def ranks_phase():
    """The decentralized engines across four ranks on the card(s)
    (``repro_torch.launch.ranks.run_cases``: gloo on one card, NCCL with a
    card a rank), each case held to the same entry point at one rank in
    this process on the same draw, with the same kernels and plain.
    Returns the ranks' two-pass launches by kernel and instance (summed
    over the ranks) and each case's numbers."""
    from repro_torch.launch import ranks
    try:
        rec = ranks.run_cases(4, log=log)
    except ranks.RankFailure as err:
        check(False, f"ranks: {err}")
    log(f"ranks phase: {rec['ranks']} ranks, backend {rec['backend']}, "
        f"{rec['spawn_s']:.1f} s in the ranks, {rec['reference_s']:.1f} s "
        f"in the one-rank and plain references; launches "
        f"{json.dumps(rec['launches'])}, by instance "
        f"{json.dumps(rec['instances'])}; the hand-off's gaps to the dense "
        f"warm path {json.dumps(rec['warm_gap'])}")
    return rec


def synchronize(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def attention_inputs(torch, case, dtype, device, seed):
    """q (B, H, S, D), k and v (B, KV, S, D) from a seeded generator; the
    qwen3-14b cases are the model's (B, S, heads, D) buffers seen through
    ``.transpose(1, 2)``, as ``attention.self_attend`` feeds the kernel."""
    B, H, KV, S, D = case[:5]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    strided = H == 40

    def draw(heads):
        shape = (B, S, heads, D) if strided else (B, heads, S, D)
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32).to(getattr(torch, dtype))
        return t.transpose(1, 2) if strided else t
    return draw(H), draw(KV), draw(KV)


def flash_deviation(torch, got, want, dtype):
    """(max |got - want|, the share of the limit it uses): fp32 against
    FLASH_TOL_F32, bf16 against one bf16 ulp of the plain output."""
    dev = (got.float() - want.float()).abs()
    if dtype == "float32":
        limit = torch.full_like(dev, FLASH_TOL_F32)
    else:
        limit = BF16_ULP * want.float().abs() + 1e-6
    return float(dev.max()), float((dev / limit).max())


def flash_checks(torch, ops, ref, device, devs: dict):
    """``flash_attention`` against ``ref.mha`` on the same inputs; on the
    card each case must launch the instance ``ops.flash_instance`` names."""
    for i, case in enumerate(FLASH_CASES):
        B, H, KV, S, D, causal, window = case
        for dtype in ("float32", "bfloat16"):
            q, k, v = attention_inputs(torch, case, dtype, device, seed=i)
            before = dict(ops.flash_launches)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            instance = "plain"
            if torch.device(device).type == "cuda":
                instance = ops.flash_instance(q.dtype, D)
                ran = {name: n - before[name]
                       for name, n in ops.flash_launches.items()}
                check(ran[instance] == 1 and sum(ran.values()) == 1,
                      f"flash_attention {case} {dtype}: launched {ran}, "
                      f"expected one {instance} launch")
            want = ref.mha(q, k, v, causal=causal, window=window)
            check(tuple(got.shape) == tuple(q.shape) and got.dtype == q.dtype,
                  f"flash_attention {case}: output {tuple(got.shape)} "
                  f"{got.dtype}")
            check(bool(torch.isfinite(got).all()),
                  f"flash_attention {case} {dtype}: non-finite output")
            dev, share = flash_deviation(torch, got, want, dtype)
            record(devs, "flash_attention", dtype, dev)
            what = (f"flash_attention B={B} H={H} KV={KV} S={S} D={D} "
                    f"causal={causal} window={window} {dtype} [{instance}]")
            check(share <= 1.0, f"{what}: max|dev| {dev:.3e} is "
                  f"{share:.2f}x the limit")
            log(f"check {what}: max|dev| {dev:.3e} ({share:.3f} of the "
                "limit)")


def attention_pairs(S: int, window=None) -> int:
    """(query, key) pairs a causal attention over S tokens computes
    (``kernels.cost.attention_pairs``)."""
    from repro_torch.kernels import cost
    return cost.attention_pairs(S, window)


def attention_bound(B, H, KV, S, D, itemsize, window=None, Sk=None,
                    causal=True):
    """Causal attention: 4*B*H*D flops a (query, key) pair inside the
    window against the bf16 tensor peak, or q, k, v read and o written once
    against the memory rate (``kernels.cost.attention_work``, the count
    the kernel's meta route adds to a dry run).  With ``causal=False``
    every query sees all Sk keys (Sk defaults to S)."""
    from repro_torch.kernels import cost
    flops, nbytes = cost.attention_work(B, H, KV, S, D, itemsize, window,
                                        Sk, causal)
    return bound(flops, nbytes, PEAK_BF16)


def flash_timings(torch, ops, ref, device):
    """The kernel beside its plain version (in turns), its bound and
    ``scaled_dot_product_attention`` on the same bf16 inputs, at
    qwen3-14b's shapes; the first row is S = 2048.  The tensor-core
    instance runs, as on the main path; the fp32-FMA instance, the earlier
    design, is timed on the same bf16 inputs as ``fma_ms`` (and, on fp32
    inputs of the same shapes, its own use, as ``fma_fp32_ms``)."""
    F = torch.nn.functional
    rows = []
    for S in (2048, 1023):
        case = (1, 40, 8, S, 128, True, None)
        q, k, v = attention_inputs(torch, case, "bfloat16", device, seed=S)
        check(ops.flash_instance(q.dtype, 128) == "wgmma",
              "qwen3-14b's attention does not take the tensor-core instance")
        times = paired_ms(
            torch, lambda: ops.flash_attention(q, k, v, causal=True),
            lambda: ref.mha(q, k, v, causal=True), 20, 3)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20)
        fma = cuda_ms(torch, lambda: ops._flash_launch(
            q, k, v, "fma", causal=True, window=None, sm_scale=None), 5)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        fma32 = cuda_ms(torch, lambda: ops.flash_attention(
            q32, k32, v32, causal=True), 3)
        bms, by = attention_bound(1, 40, 8, S, 128, 2)
        flops = 4 * 40 * 128 * S * (S + 1) / 2
        rows.append(dict(times, bound_ms=bms, bound_by=by, library_ms=lib,
                         fma_ms=fma, fma_fp32_ms=fma32,
                         tflops=flops / times["ms"] / 1e9,
                         shape=f"q (1, 40, {S}, 128), kv (1, 8, {S}, 128) "
                               "bf16, causal"))
    for v in rows:
        log(f"time flash_attention [{v['shape']}]: {v['ms']:.4f} ms "
            f"(samples {v['ms_samples'][0]:.4f}, {v['ms_samples'][1]:.4f}; "
            f"{v['tflops']:.1f} TFLOP/s, {v['bound_ms'] / v['ms']:.3f} of the "
            f"bound), plain {v['plain_ms']:.4f} ms, bound "
            f"{v['bound_ms']:.4f} ms ({v['bound_by']}), "
            f"scaled_dot_product_attention {v['library_ms']:.4f} ms; fp32-FMA "
            f"instance {v['fma_ms']:.4f} ms on the same bf16 inputs, "
            f"{v['fma_fp32_ms']:.4f} ms on fp32")
    return dict(rows[0], variants=rows[1:])


def serving_path(torch, ops, engine, cfg, params, *, prompts=SERVE_PROMPTS,
                 max_new=SERVE_NEW, max_batch=SERVE_BATCH,
                 max_len=SERVE_LEN, seed=0, kernel="flash_attention"):
    """Serve len(prompts) requests through ``ServeEngine`` with block
    prefill, with the launch counters set to 0 just before the run and
    read just after; every request must finish with ``max_new`` tokens of
    the padded vocabulary, every prefill must launch ``kernel`` once per
    layer that runs it (``kernel_layers``), and no other kernel may
    launch.  Returns the launches, the prefill / decode times and the
    prompts."""
    import numpy as np
    device = params.device
    eng = engine.ServeEngine(cfg, params, max_batch=max_batch,
                             max_len=max_len, block_prefill=True,
                             device=device)
    prefills, decodes = [], []

    def timed(fn, out, label):
        def run(*args):
            synchronize(torch, device)
            t0 = time.perf_counter()
            result = fn(*args)
            synchronize(torch, device)
            out.append((label(*args), 1e3 * (time.perf_counter() - t0)))
            return result
        return run

    eng._prefill_slot = timed(eng._prefill_slot, prefills,
                              lambda b, req: len(req.prompt) - 1)
    eng._decode = timed(eng._decode, decodes,
                        lambda toks, pos: sum(s is not None
                                              for s in eng.slots))
    rng = np.random.default_rng(seed)
    asked = [rng.integers(0, cfg.vocab_size, n).tolist() for n in prompts]
    for rid, prompt in enumerate(asked):
        eng.submit(engine.Request(rid=rid, prompt=prompt, max_new=max_new))
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    synchronize(torch, device)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    instances = dict(ops.flash_launches)
    ssd_instances_run = dict(ops.ssd_launches)
    check(sorted(done) == list(range(len(prompts))),
          f"serving: completed {sorted(done)} of {len(prompts)} requests")
    for rid, req in sorted(done.items()):
        check(len(req.generated) == max_new and all(
            0 <= t < cfg.padded_vocab for t in req.generated),
            f"serving: request {rid} generated {req.generated}")
    per = kernel_layers(cfg, kernel)
    want = per * len(prompts)
    check(launches[kernel] == want,
          f"serving: {launches[kernel]} {kernel} launches, expected {want} "
          f"({per} per prefilled request)")
    check(len(prefills) == len(prompts), "serving: a prompt skipped prefill")
    for name, count in launches.items():
        check(name == kernel or count == 0, f"serving launched {name}")
    for S, ms in prefills:
        log(f"serve prefill S={S}: {ms:.2f} ms")
    steps = [ms for _, ms in decodes]
    log(f"serve: {len(done)} requests x {max_new} tokens in {wall:.2f} s, "
        f"{len(decodes)} decode steps, median {float(np.median(steps)):.2f}"
        f" ms (min {min(steps):.2f}, max {max(steps):.2f}); launches "
        f"{json.dumps(launches)}; first tokens "
        f"{[done[r].generated[:4] for r in sorted(done)]}")
    return dict(launches=launches, flash_instances=instances,
                ssd_instances=ssd_instances_run, prefill_ms=prefills,
                decode_ms=decodes, wall_s=wall, prompts=asked)


def kernel_layers(cfg, kernel="flash_attention") -> int:
    """The layers of ``cfg``'s stack whose prefill launches ``kernel``
    once: the attention layers ("attn" and "moe" blocks) for
    flash_attention, the Mamba-2 layers for ssd_scan."""
    from repro_torch.models import blocks
    kinds = {"flash_attention": ("attn", "moe"), "ssd_scan": ("ssm",)}
    return sum(k in kinds[kernel] for k in blocks.block_kinds(cfg))


def plain_self_attend(q, k, v, *, causal, window):
    """The plain attention on any device (the check's yardstick only)."""
    import torch
    from repro_torch.models import attention
    pos = torch.arange(q.shape[1], device=q.device)
    return attention._attend(q, k, v, pos, pos, causal=causal,
                             window=window)


def position_control(torch, kern, plain, tol, label):
    """The control of an in-model limit: the kernel's logits against the
    plain ones one position earlier (axis 1), near what a kernel that gave
    each query its neighbour's output would give.  It must exceed ``tol``;
    returns it."""
    control = float((kern[:, 1:].float() - plain[:, :-1].float())
                    .abs().max())
    log(f"model {label}: control, the plain logits one position earlier, "
        f"max|dev| {control:.4e} (must exceed {tol:g})")
    check(control > tol, f"{label}: the control's max|dev| {control:.4e} "
          f"is within the limit {tol:g}")
    return control


def kernel_vs_plain_in_model(torch, ops, cfg, params, *, label, tol,
                             prompt=MODEL_PROMPT, seed=1, controls=None):
    """Block-prefill logits of one prompt with the kernel and with the
    plain attention swapped in (one launch per attention layer); returns
    (max |dev|, max |logit|).  With a ``controls`` dict, the limit also
    gets ``position_control``, stored there under ``label``."""
    import numpy as np
    from repro_torch.models import attention
    from repro_torch.models.prefill import prefill
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (1, prompt))
    batch = {"tokens": toks}
    before = ops.launches["flash_attention"]
    kern, _, _ = prefill(params, batch, cfg, prompt + 1)
    check(ops.launches["flash_attention"] - before == kernel_layers(cfg),
          f"{label}: the prefill did not launch the kernel once per "
          "attention layer")
    kernel_attend = attention.self_attend
    attention.self_attend = plain_self_attend
    try:
        plain, _, _ = prefill(params, batch, cfg, prompt + 1)
    finally:
        attention.self_attend = kernel_attend
    check(bool(torch.isfinite(kern).all()), f"{label}: non-finite logits")
    dev = float((kern.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    log(f"model {label}: prefill logits {tuple(kern.shape)}, kernel vs plain "
        f"attention max|dev| {dev:.4e} (limit {tol:g}), max|logit| "
        f"{scale:.4f}")
    check(dev <= tol, f"{label}: max|dev| {dev:.4e} > {tol}")
    if controls is not None:
        controls[label] = position_control(torch, kern, plain, tol, label)
    return dev, scale


def ssd_inputs(torch, case, dtype, device, seed):
    """x (b, s, h, p), dt (b, s, h), A, D (h,), B and C (b, s, n).  The
    tests/test_kernels.py cases draw them as that file does (standard
    normal x, B, C; dt = |N| 0.1 + 0.01; A = -(|N| + 0.5); D = |N|).
    mamba2-370m's cases draw them as the model forms them: x, B and C are
    column slices of one (b, s, h·p + 2n) conv output, silu(0.5 N); dt =
    softplus(N); A = -linspace(1, 16, h) and D = 1, as ``init_mamba``."""
    b, s, h, p, n = case[:5]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    f32 = dict(generator=gen, device=device, dtype=torch.float32)
    wide = getattr(torch, dtype)
    if (h, p, n) == (32, 64, 128):
        buf = torch.nn.functional.silu(
            0.5 * torch.randn((b, s, h * p + 2 * n), **f32)).to(wide)
        x = buf[..., :h * p].reshape(b, s, h, p)
        B, C = buf[..., h * p:h * p + n], buf[..., h * p + n:]
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), **f32))
        A = -torch.linspace(1.0, 16.0, h, device=device)
        D = torch.ones(h, device=device)
        return x, dt, A, B, C, D
    x = torch.randn((b, s, h, p), **f32).to(wide)
    B = torch.randn((b, s, n), **f32).to(wide)
    C = torch.randn((b, s, n), **f32).to(wide)
    dt = torch.randn((b, s, h), **f32).abs() * 0.1 + 0.01
    A = -(torch.randn((h,), **f32).abs() + 0.5)
    D = torch.randn((h,), **f32).abs()
    return x, dt, A, B, C, D


def ssd_deviation(torch, got, want, dtype):
    """((y max |dev|, share of its limit), (state max |dev|, share)): y
    against SSD_TOL_F32 (fp32) or one bf16 ulp of the plain y (bf16); the
    state against SSD_TOL_F32 (1 + |s_plain|)."""
    dy = (got[0].float() - want[0].float()).abs()
    if dtype == "float32":
        limit = torch.full_like(dy, SSD_TOL_F32)
    else:
        limit = BF16_ULP * want[0].float().abs() + 1e-6
    ds = (got[1] - want[1]).abs()
    slimit = SSD_TOL_F32 * (1.0 + want[1].abs())
    return ((float(dy.max()), float((dy / limit).max())),
            (float(ds.max()), float((ds / slimit).max())))


def ssd_instances(torch, ops, case, dtype):
    """The instances of ``ssd_scan`` that take a case, the wrapper's
    choice first: the tensor-core one where ``ops.ssd_instance`` names it,
    the fp32-FMA one wherever its shared memory fits."""
    b, s, h, p, n, chunk = case
    chosen = ops.ssd_instance(getattr(torch, dtype), p, n, chunk)
    takes = [chosen]
    if chosen != "fma" and ops.ssd_smem_bytes(chunk, n) <= ops._SMEM_LIMIT:
        takes.append("fma")
    return takes


def ssd_checks(torch, ops, ref, device, devs: dict):
    """``ssd_scan`` against ``ref.ssd_scan`` on the same inputs: y and the
    final state; on the card each case runs on every instance that takes
    it (``ssd_instances``), each launch counted on its instance."""
    on_card = torch.device(device).type == "cuda"
    for i, case in enumerate(SSD_CASES):
        b, s, h, p, n, chunk = case
        for dtype in ("float32", "bfloat16"):
            args = ssd_inputs(torch, case, dtype, device, seed=i)
            want = ref.ssd_scan(*args, chunk=chunk)
            for instance in (ssd_instances(torch, ops, case, dtype)
                             if on_card else ["plain"]):
                ssd_check_one(torch, ops, case, dtype, args, want, instance,
                              devs)


def ssd_check_one(torch, ops, case, dtype, args, want, instance, devs):
    """One case of ``ssd_checks`` on one instance (``"plain"``: the CPU's
    wrapper)."""
    b, s, h, p, n, chunk = case
    before = dict(ops.ssd_launches)
    if instance in ("plain", ops.ssd_instance(
            args[0].dtype, p, n, chunk)):
        got = ops.ssd_scan(*args, chunk=chunk)
    else:
        got = ops._ssd_launch(*args, chunk, instance)
    if instance != "plain":
        ran = {k: v - before[k] for k, v in ops.ssd_launches.items()}
        check(ran == {k: int(k == instance)
                      for k in ops.SSD_INSTANCES},
              f"ssd_scan {case} {dtype}: launched {ran}, expected "
              f"one {instance} launch")
    what = (f"ssd_scan b={b} s={s} h={h} p={p} n={n} chunk={chunk} "
            f"{dtype} [{instance}]")
    check(tuple(got[0].shape) == (b, s, h, p)
          and got[0].dtype == args[0].dtype
          and tuple(got[1].shape) == (b, h, p, n)
          and got[1].dtype == torch.float32,
          f"{what}: outputs {tuple(got[0].shape)} {got[0].dtype}, "
          f"{tuple(got[1].shape)} {got[1].dtype}")
    check(bool(torch.isfinite(got[0]).all()
               and torch.isfinite(got[1]).all()),
          f"{what}: non-finite output")
    (dy, sy), (dst, sst) = ssd_deviation(torch, got, want, dtype)
    record(devs, "ssd_scan", dtype, max(dy, dst))
    check(sy <= 1.0, f"{what}: y max|dev| {dy:.3e} is {sy:.2f}x the "
          "limit")
    check(sst <= 1.0, f"{what}: state max|dev| {dst:.3e} is "
          f"{sst:.2f}x the limit")
    log(f"check {what}: y max|dev| {dy:.3e} ({sy:.3f} of the limit),"
        f" state max|dev| {dst:.3e} ({sst:.3f} of the limit)")


def ssd_bound(b, s, h, p, n, chunk, itemsize):
    """One scan: 2·b·h·s·(Q·n + Q·p + 2·p·n) flops (C B^T and its product
    with x·dt over full Q x Q tiles, the carry-in and the state update)
    against the peak of the input type, or x read and y written (itemsize),
    B and C read (itemsize), dt read and the final state written (fp32)
    against the memory rate (``kernels.cost.ssd_work``)."""
    from repro_torch.kernels import cost
    flops, nbytes = cost.ssd_work(b, s, h, p, n, chunk, itemsize)
    return bound(flops, nbytes, PEAK_BF16 if itemsize == 2 else PEAK_FP32)


def ssd_timings(torch, ops, ref, device):
    """The kernel beside its plain version and its bound at mamba2-370m's
    bf16 shapes; the first row is S = 2048.  The tensor-core instance
    runs, as on the main path; the fp32-FMA instance, the earlier design,
    is timed on the same inputs in turns: back-to-back calls (wgmma, fma,
    plain, plain, fma, wgmma: ``call_ms``, ``fma_call_ms``, host time
    included) and replays of a CUDA graph of one call (wgmma, fma, fma,
    wgmma: ``ms``, ``fma_ms``, the device's time; ``profile_ssd.graph_ms``).
    The tensor-core instance must take at most SSD_RATIO of the fp32-FMA
    one's device time.  No single torch call computes the scan, so there is
    no library time."""
    from repro_torch.launch.profile_ssd import graph_ms
    rows = []
    for S in (2048, 1023):
        case = (1, S, 32, 64, 128, 64)
        args = ssd_inputs(torch, case, "bfloat16", device, seed=S)
        check(ops.ssd_instance(torch.bfloat16, 64, 128, 64) == "wgmma",
              "mamba2-370m's scan does not take the tensor-core instance")
        kernel = lambda: ops.ssd_scan(*args, chunk=64)
        fma = lambda: ops._ssd_launch(*args, 64, "fma")
        plain = lambda: ref.ssd_scan(*args, chunk=64)
        k1, f1 = cuda_ms(torch, kernel, 20), cuda_ms(torch, fma, 20)
        p1, p2 = cuda_ms(torch, plain, 3), cuda_ms(torch, plain, 3)
        f2, k2 = cuda_ms(torch, fma, 20), cuda_ms(torch, kernel, 20)
        g1, h1 = graph_ms(kernel, 50), graph_ms(fma, 20)
        h2, g2 = graph_ms(fma, 20), graph_ms(kernel, 50)
        bms, by = ssd_bound(*case, 2)
        row = dict(ms=(g1 + g2) / 2, ms_samples=[g1, g2],
                   plain_ms=(p1 + p2) / 2, plain_ms_samples=[p1, p2],
                   fma_ms=(h1 + h2) / 2, fma_ms_samples=[h1, h2],
                   call_ms=(k1 + k2) / 2, call_ms_samples=[k1, k2],
                   fma_call_ms=(f1 + f2) / 2, fma_call_ms_samples=[f1, f2],
                   bound_ms=bms, bound_by=by, library_ms=None,
                   shape=f"x (1, {S}, 32, 64), B/C (1, {S}, 128) bf16 "
                         "strided, chunk 64")
        row["ratio"] = row["ms"] / row["fma_ms"]
        row["call_ratio"] = row["call_ms"] / row["fma_call_ms"]
        rows.append(row)
    for v in rows:
        log(f"time ssd_scan [{v['shape']}]: {v['ms']:.4f} ms on the device "
            f"(graph samples {v['ms_samples'][0]:.4f}, "
            f"{v['ms_samples'][1]:.4f}), {v['call_ms']:.4f} ms a call "
            f"(samples {v['call_ms_samples'][0]:.4f}, "
            f"{v['call_ms_samples'][1]:.4f}), plain {v['plain_ms']:.4f} ms, "
            f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}), library: none")
        log(f"time ssd_scan instances [{v['shape']}]: device wgmma "
            f"{v['ms']:.4f} ms, fma {v['fma_ms']:.4f} ms (samples "
            f"{v['fma_ms_samples'][0]:.4f}, {v['fma_ms_samples'][1]:.4f}), "
            f"wgmma/fma {v['ratio']:.3f}; a call: wgmma {v['call_ms']:.4f} "
            f"ms, fma {v['fma_call_ms']:.4f} ms, wgmma/fma "
            f"{v['call_ratio']:.3f}")
        check(v["ratio"] <= SSD_RATIO,
              f"ssd_scan [{v['shape']}]: the tensor-core instance takes "
              f"{v['ratio']:.3f}x the fp32-FMA one's device time, over "
              f"{SSD_RATIO}")
    return dict(rows[0], variants=rows[1:])


def plain_ssd(x, dt, A, B, C, D, cfg):
    """The plain scan on any device, at the kernel's chunk (the check's
    yardstick only)."""
    from repro_torch.kernels import ref
    return ref.ssd_scan(x, dt, A, B, C, D, chunk=cfg.ssm_chunk)


def ssd_vs_plain_in_model(torch, ops, cfg, params, *, label, tol,
                          prompt=MAMBA_PROMPT, seed=1):
    """Block-prefill logits and seeded SSM states of one prompt with the
    kernel and with the plain scan swapped in; returns (logits max |dev|,
    max |logit|, state max |dev|)."""
    import numpy as np
    from repro_torch.models import ssm
    from repro_torch.models.prefill import prefill
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (1, prompt))
    batch = {"tokens": toks}
    before = ops.launches["ssd_scan"]
    kern, kcache, _ = prefill(params, batch, cfg, prompt + 1)
    check(ops.launches["ssd_scan"] - before == cfg.num_layers,
          f"{label}: the prefill did not launch the kernel once per layer")
    kernel_ssd = ssm.ssd
    ssm.ssd = plain_ssd
    try:
        plain, pcache, _ = prefill(params, batch, cfg, prompt + 1)
    finally:
        ssm.ssd = kernel_ssd
    check(bool(torch.isfinite(kern).all()), f"{label}: non-finite logits")
    check(bool(torch.isfinite(kcache["layers"]["ssm"]).all()),
          f"{label}: non-finite SSM state")
    dev = float((kern.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    sdev = float((kcache["layers"]["ssm"] - pcache["layers"]["ssm"])
                 .abs().max())
    smax = float(pcache["layers"]["ssm"].abs().max())
    log(f"model {label}: prefill logits {tuple(kern.shape)}, kernel vs plain "
        f"scan max|dev| {dev:.4e} (limit {tol:g}), max|logit| {scale:.4f}; "
        f"seeded SSM state {tuple(kcache['layers']['ssm'].shape)} max|dev| "
        f"{sdev:.4e} (limit {tol:g}), max|state| {smax:.4f}")
    check(dev <= tol, f"{label}: logits max|dev| {dev:.4e} > {tol}")
    check(sdev <= tol, f"{label}: state max|dev| {sdev:.4e} > {tol}")
    return dev, scale, sdev


def trunk_flops(cfg, params, seqs: int, S: int) -> float:
    """Operations of ``extract_features``'s trunk on ``seqs`` sequences of
    S tokens, counted from the weights: two a token for every weight of a
    matrix of the block stack (every expert, as the dense MoE route runs
    them all; no embedding lookup, no LM head), plus the attention's
    4·H·D a (query, key) pair inside the trunk's window."""
    from repro_torch.optim import decsvm_head as head
    weights = sum(w.numel() for layer in params.layers
                  for w in layer.parameters() if w.dim() >= 2)
    pairs = attention_pairs(S, head.trunk_order(cfg)[1])
    return seqs * (2 * weights * S + kernel_layers(cfg) * 4
                   * cfg.num_heads * cfg.head_dim * pairs)


def head_phase(torch, core, ops, cfg, params, *, shape=HEAD_SHAPE,
               plain_seqs=HEAD_PLAIN_SEQS, fits=HEAD_FITS,
               tune_num=HEAD_TUNE_NUM, admm=HEAD_ADMM, seed=0):
    """The head on ``cfg``'s frozen features through the port's entry
    points.  ``optim.decsvm_head.extract_features`` of m·n sequences of S
    tokens (the counters set to 0 just before, read just after: one flash
    launch per attention layer and batch of 64, no other kernel), held
    against the same extraction with the plain attention on the first
    ``plain_seqs``; then each fit of ``fits`` under its kernel backend and
    the same call under ``jnp`` on the card, B within the fp32 fit tier
    (1e-5): "megakernel" (``train_decsvm_head``: one round launch),
    "pallas" (one ``csvm_local_update`` a round), "sharded"
    (``decsvm_fit_sharded``, gather at one rank, megakernel: one
    ``csvm_block_update`` a round), "tuned" (``tune=True``, batched: one
    round launch a grid point, the same lambda as under jnp); every
    launch on the stream instance.  Returns the launches by kernel and
    instance, the times and the fits' records."""
    import numpy as np
    from repro_torch.core.decentral import decsvm_fit_sharded
    from repro_torch.launch.decentralized_head import hyperplane_labels
    from repro_torch.launch.mesh import make_node_mesh
    from repro_torch.models import attention
    from repro_torch.optim import decsvm_head as head
    m, n, S = shape
    device = params.device
    on_card = device.type == "cuda"
    label = f"head {cfg.name}"
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (m * n, S))

    def timed(fn):
        synchronize(torch, device)
        t0 = time.perf_counter()
        out = fn()
        synchronize(torch, device)
        return out, time.perf_counter() - t0

    ops.reset_launches()
    feats, extract_s = timed(lambda: head.extract_features(params, cfg,
                                                           toks))
    launches = dict(ops.launches)
    flash_instances = dict(ops.flash_launches)
    want = kernel_layers(cfg) * math.ceil(m * n / 64)
    check(launches["flash_attention"] == want,
          f"{label}: {launches['flash_attention']} flash launches in the "
          f"extraction, expected {want} (one per attention layer and "
          "batch of 64)")
    for name, count in launches.items():
        check(name == "flash_attention" or count == 0,
              f"{label}: the extraction launched {name}")
    check(tuple(feats.shape) == (m * n, cfg.d_model)
          and bool(torch.isfinite(feats).all()),
          f"{label}: features {tuple(feats.shape)}, or non-finite")
    flops = trunk_flops(cfg, params, m * n, S)
    out = dict(extract_s=extract_s, shape=shape, trunk_flops=flops,
               extract_tflops=flops / extract_s / 1e12,
               flash_launches=launches["flash_attention"],
               flash_instances=flash_instances, fits={})
    if plain_seqs:
        kernel_attend = attention.self_attend
        attention.self_attend = plain_self_attend
        try:
            plain = head.extract_features(params, cfg, toks[:plain_seqs])
        finally:
            attention.self_attend = kernel_attend
        dev = float((feats[:plain_seqs].float() - plain.float()).abs().max())
        scale = float(plain.float().abs().max())
        log(f"{label}: features of {plain_seqs} sequences, kernel vs plain "
            f"attention max|dev| {dev:.4e}, max|feature| {scale:.4f} (limit "
            f"{FEATURE_TOL:g} x max|feature|)")
        check(dev <= FEATURE_TOL * scale,
              f"{label}: features max|dev| {dev:.4e} > {FEATURE_TOL} x "
              f"{scale:.4f}")
        out["features_kernel_vs_plain"] = dict(
            max_abs_dev=dev, max_abs_feature=scale, seqs=plain_seqs,
            tol=f"{FEATURE_TOL:g} max|feature|")
    F = feats.float().reshape(m, n, -1)
    y = hyperplane_labels(F.cpu().numpy(), rng)
    W = core.graph.ring(m)
    X, _, _ = head.standardize(F)
    yt = torch.as_tensor(y, device=device)

    def acfg(backend):
        return core.ADMMConfig(backend=backend, **admm)

    def untuned(backend):
        return head.train_decsvm_head(F, y, W, acfg(backend))

    def sharded(backend):
        return decsvm_fit_sharded(X, yt, W, acfg(backend),
                                  mesh=make_node_mesh(),
                                  schedule="gather"), None

    def tuned(backend):
        return head.train_decsvm_head(F, y, W, acfg(backend), tune=True,
                                      num=tune_num, mode="batched")

    it = admm["max_iter"]
    table = {  # fit: (call, its plain reference, backend, kernel, launches)
        "megakernel": (untuned, "untuned", "megakernel", "csvm_round_block",
                       1),
        "pallas": (untuned, "untuned", "pallas", "csvm_local_update", it),
        "sharded": (sharded, "sharded", "megakernel", "csvm_block_update",
                    it),
        "tuned": (tuned, "tuned", "megakernel", "csvm_round_block",
                  tune_num),
    }
    refs = {}
    round_instances = {k: 0 for k in ops.round_block_launches}
    two_pass = {name: {k: 0 for k in ops.two_pass_launches}
                for name in FIT_KERNELS if name != "csvm_round_block"}
    fit_launches = {name: 0 for name in FIT_KERNELS}
    for what in fits:
        fn, ref_key, backend, kernel, count = table[what]
        if ref_key not in refs:
            refs[ref_key] = timed(lambda: fn("jnp"))
        (ref, ref_info), ref_s = refs[ref_key]
        c0 = dict(ops.launches)
        r0, t0_ = dict(ops.round_block_launches), dict(ops.two_pass_launches)
        (B, info), secs = timed(lambda: fn(backend))
        ran = {k: ops.launches[k] - c0[k] for k in FIT_KERNELS}
        check(ran[kernel] == count and sum(ran.values()) == count,
              f"{label} {what}: launches {ran}, expected {count} of "
              f"{kernel}")
        for k in FIT_KERNELS:
            fit_launches[k] += ran[k]
        inst = {}
        if on_card:
            src = (ops.round_block_launches if kernel == "csvm_round_block"
                   else ops.two_pass_launches)
            base = r0 if kernel == "csvm_round_block" else t0_
            inst = {k: v - base[k] for k, v in src.items()}
            check(inst == {"stream": count, "direct": 0},
                  f"{label} {what}: {kernel} instances {inst}, expected all "
                  f"{count} on the stream instance")
            for k, v in inst.items():
                if kernel == "csvm_round_block":
                    round_instances[k] += v
                else:
                    two_pass[kernel][k] += v
        dev = float((B - ref).abs().max())
        Bn = B.cpu().numpy()
        check(bool(np.isfinite(Bn).all()) and Bn.shape == (m, cfg.d_model
                                                           + 1),
              f"{label} {what}: B {Bn.shape}, or non-finite")
        check(dev <= FIT_TOL["float32"],
              f"{label} {what}: max|dev| {dev:.3e} vs jnp > "
              f"{FIT_TOL['float32']}")
        if info is None:
            margins = torch.einsum("mnp,mp->mn", X, B).cpu().numpy()
            info = dict(train_accuracy=core.metrics.margin_accuracy(
                margins, y), mean_support=core.metrics.mean_support_size(
                Bn, tol=1e-6), lam=admm["lam"])
        else:
            check(info["lam"] == ref_info["lam"],
                  f"{label} {what}: lambda {info['lam']} where jnp picks "
                  f"{ref_info['lam']}")
        rec = dict(wall_s=secs, plain_wall_s=ref_s, max_abs_dev=dev,
                   kernel=kernel, launches=ran[kernel], instances=inst,
                   train_accuracy=info["train_accuracy"],
                   support=info["mean_support"], lam=info["lam"],
                   consensus_gap=core.metrics.consensus_gap(Bn))
        out["fits"][what] = rec
        log(f"{label} {what}: {secs:.3f} s wall (jnp on the card "
            f"{ref_s:.3f} s), {ran[kernel]} {kernel} launches {inst}, "
            f"max|dev| vs jnp {dev:.3e} (tol {FIT_TOL['float32']:g}), "
            f"lambda {info['lam']:.5f}, train accuracy "
            f"{rec['train_accuracy']:.3f}, support {rec['support']:.1f} of "
            f"{cfg.d_model + 1}, consensus gap {rec['consensus_gap']:.2e}")
    out.update(fit_launches=fit_launches, round_instances=round_instances,
               two_pass_instances=two_pass)
    log(f"{label}: {m} nodes x {n} sequences x {S} tokens, features "
        f"{tuple(feats.shape)} in {1e3 * extract_s:.1f} ms "
        f"({flops / 1e15:.4f} PFLOP of trunk, {out['extract_tflops']:.1f} "
        f"TFLOP/s; {launches['flash_attention']} flash launches "
        f"{json.dumps(flash_instances)}); fit launches "
        f"{json.dumps(fit_launches)}")
    return out


def moe_route_checks(torch, cfg, params, *, tokens=MODEL_PROMPT, seed=2):
    """The scatter route with a capacity that drops nothing against the
    dense route on layer 0's MoE (bf16 input, relative limit) and on the
    block-prefill logits of one prompt (MODEL_TOL); and two runs of the
    scatter route at the configured capacity, bit for bit."""
    import numpy as np
    from repro_torch.models import moe
    from repro_torch.models.prefill import prefill
    device = params.device
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    ample = dataclasses.replace(cfg, moe_routing="scatter",
                                moe_capacity_factor=E / k)
    check(moe.capacity(ample, tokens) > tokens,
          f"{cfg.name}: capacity {moe.capacity(ample, tokens)} drops tokens")
    layer = params.layers[0].moe
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h = torch.randn((1, tokens, cfg.d_model), generator=gen, device=device,
                    dtype=torch.float32).to(params.embed.dtype)
    dense, _ = moe.moe_forward_dense(layer, h, cfg)
    scat, _ = moe.moe_forward_scatter(layer, h, ample)
    dev = float((scat.float() - dense.float()).abs().max())
    scale = float(dense.float().abs().max())
    check(dev <= MOE_LAYER_TOL * scale,
          f"{cfg.name} layer 0: scatter vs dense max|dev| {dev:.4e} > "
          f"{MOE_LAYER_TOL} x {scale:.4f}")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (1, tokens))
    kl, _, _ = prefill(params, {"tokens": toks}, cfg, tokens + 1)
    sl, _, _ = prefill(params, {"tokens": toks}, ample, tokens + 1)
    ldev = float((kl.float() - sl.float()).abs().max())
    check(ldev <= MODEL_TOL["bfloat16"],
          f"{cfg.name}: logits scatter vs dense max|dev| {ldev:.4e} > "
          f"{MODEL_TOL['bfloat16']}")
    tight = dataclasses.replace(cfg, moe_routing="scatter")
    a, _ = moe.moe_forward_scatter(layer, h, tight)
    b, _ = moe.moe_forward_scatter(layer, h, tight)
    check(torch.equal(a, b), f"{cfg.name}: two scatter runs differ")
    _, idx, _ = moe._route(layer, h.reshape(tokens, -1), cfg)
    per_expert = torch.bincount(idx.reshape(-1), minlength=E)
    C = moe.capacity(tight, tokens)
    dropped = int(torch.clamp(per_expert - C, min=0).sum())
    log(f"{cfg.name} MoE routes: layer 0 scatter (capacity factor "
        f"{E / k:g}, nothing dropped) vs dense max|dev| {dev:.4e} (limit "
        f"{MOE_LAYER_TOL:g} x max|y| {scale:.4f}); prefill logits max|dev| "
        f"{ldev:.4e} (limit {MODEL_TOL['bfloat16']:g}); scatter at capacity "
        f"factor {cfg.moe_capacity_factor:g} (C = {C}, {dropped} of "
        f"{tokens * k} assignments dropped) bit for bit in two runs")
    return dict(layer_dev=dev, layer_scale=scale, logits_dev=ldev,
                deterministic=True, dropped=dropped, capacity=C)


def new_model(torch, model, configs, name):
    """``name``'s full-width model drawn on the card from seed 0, with its
    size logged; returns (cfg, params, weight bytes)."""
    from repro_torch.models import blocks
    cfg = configs.get(name)
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"model {cfg.name}: {cfg.num_layers} layers "
        f"{json.dumps(dict(collections.Counter(blocks.block_kinds(cfg))))}, "
        f"d_model "
        f"{cfg.d_model}, head_dim {cfg.head_dim}, vocab {cfg.padded_vocab} "
        f"(padded), {sum(p.numel() for p in params.parameters()) / 1e9:.3f} "
        f"B parameters, {nbytes / 1e9:.2f} GB {cfg.param_dtype}, drawn on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    return cfg, params, nbytes


def backbone_serving(torch, ops, engine, cfg, params, *, prompts, max_len,
                     instance, max_new=NEW_TOKENS):
    """The engine with block prefill on ``prompts`` (``serving_path``),
    every flash launch on ``instance``."""
    served = serving_path(torch, ops, engine, cfg, params, prompts=prompts,
                          max_new=max_new, max_len=max_len)
    if params.device.type == "cuda":
        n = served["launches"]["flash_attention"]
        check(served["flash_instances"] == {
            **{k: 0 for k in ops.flash_launches}, instance: n},
            f"{cfg.name} serving: flash launches by instance "
            f"{served['flash_instances']}, expected all {n} on {instance}")
    return served


def tokenwise_agreement(torch, engine, cfg, params, prompt, *, max_len,
                        tol=None, tokens=True):
    """One prompt through a one-slot engine with block prefill and token by
    token.  Where ``tol`` is given, the first generated token's logits (the
    same history on both paths) differ by at most ``tol``, and a control
    differs by more: the token-wise logits one position earlier, what a
    decode that dropped the prompt's last token would give.  With
    ``tokens``, the two paths must give the same greedy tokens.  Returns
    both paths' tokens, the deviation and the control's."""
    def run(block):
        eng = engine.ServeEngine(cfg, params, max_batch=1, max_len=max_len,
                                 block_prefill=block, device=params.device)
        logits = []
        decode = eng._decode

        def recorded(toks, pos):
            out, cache = decode(toks, pos)
            logits.append(out.float())
            return out, cache
        eng._decode = recorded
        eng.submit(engine.Request(rid=0, prompt=prompt, max_new=NEW_TOKENS))
        return eng.run()[0].generated, logits
    fast, fast_logits = run(True)
    slow, slow_logits = run(False)
    first = slow_logits[len(prompt) - 1]
    dev = float((fast_logits[0] - first).abs().max())
    control = float((fast_logits[0] - slow_logits[len(prompt) - 2])
                    .abs().max())
    top = torch.topk(first[0], 2).values
    label = (f"{cfg.name} {cfg.param_dtype}: a {len(prompt)}-token prompt "
             "with block prefill and token by token")
    log(f"{label}: first generated token's logits max|dev| {dev:.4e} "
        f"(limit {tol}; control, one position earlier, {control:.4e}; "
        f"max|logit| {float(first.abs().max()):.4f}, top-2 margin "
        f"{float(top[0] - top[1]):.4e}); tokens {fast} and {slow}")
    if tokens:
        check(fast == slow, f"{label}: tokens {fast} and {slow} differ")
    if tol is not None:
        check(dev <= tol, f"{label}: logits max|dev| {dev:.4e} > {tol}")
        check(control > tol, f"{label}: the control's logits max|dev| "
              f"{control:.4e} is within the limit {tol}")
    return dict(first_logits_dev=dev, control_dev=control, tol=tol,
                block=fast, tokenwise=slow, equal=fast == slow,
                dtype=cfg.param_dtype)


def in_model_instances(torch, ops, cfg, params, *, label, instance,
                       prompt=MODEL_PROMPT, tol=MODEL_TOL["bfloat16"],
                       controls=None):
    """``kernel_vs_plain_in_model`` at ``tol`` (the bf16 limit), with every
    kernel launch of it on ``instance``."""
    before = dict(ops.flash_launches)
    dev, scale = kernel_vs_plain_in_model(torch, ops, cfg, params,
                                          label=label, tol=tol,
                                          prompt=prompt, controls=controls)
    if params.device.type == "cuda":
        ran = {k: v - before[k] for k, v in ops.flash_launches.items()}
        check(ran[instance] == kernel_layers(cfg) and sum(ran.values())
              == ran[instance], f"{label}: flash launches by instance "
              f"{ran}, expected {kernel_layers(cfg)} on {instance}")
    return dev, scale


def window_mask(torch, S, Sk, window, device):
    """The causal sliding-window mask as a boolean (S, Sk) ``attn_mask``
    for ``scaled_dot_product_attention``: key j visible to query i when
    i - window < j <= i."""
    qi = torch.arange(S, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    return (ki <= qi) & (ki > qi - window)


def flash_d256_timing(torch, ops, ref, device, S=2048, window=2048):
    """recurrentgemma-2b's attention at S (q (1, 10, S, 256), kv (1, 1, S,
    256) bf16, causal, window 2048): the tensor-core instance (the
    wrapper's choice at D = 256) against plain, then both instances forced
    by name and timed in turns (wgmma, fma, fma, wgmma), the tensor-core
    one no slower, beside the bound and ``scaled_dot_product_attention``
    on the same inputs: causal alone where the window masks nothing (S <=
    window), else with the window as a boolean mask.  At S = 2048 the
    window masks nothing; the served 2,100-token prompt's prefill (S =
    2099) runs it with the window active.  On CPU tensors (a rehearsal)
    both names run the wrapper's plain version."""
    F = torch.nn.functional
    cuda = torch.device(device).type == "cuda"
    case = (1, 10, 1, S, 256, True, window)
    q, k, v = attention_inputs(torch, case, "bfloat16", device, seed=S)
    check(ops.flash_instance(q.dtype, 256, q, k, v) == "wgmma",
          "bf16 at D = 256 does not take the tensor-core instance")
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.mha(q, k, v, causal=True, window=window)
    dev, share = flash_deviation(torch, got, want, "bfloat16")
    check(share <= 1.0, f"flash D = 256: max|dev| {dev:.3e} is {share:.2f}x "
          "the limit")
    runs = {inst: (lambda inst=inst: ops._flash_launch(
        q, k, v, inst, causal=True, window=window, sm_scale=None))
        if cuda else (lambda: ops.flash_attention(q, k, v, causal=True,
                                                  window=window))
        for inst in ops.FLASH_INSTANCES}
    times = paired_ms(
        torch, runs["wgmma"],
        lambda: ref.mha(q, k, v, causal=True, window=window), 20, 2)
    fma = [cuda_ms(torch, runs["fma"], 5) for _ in range(2)]
    w2 = cuda_ms(torch, runs["wgmma"], 20)
    if S <= window:
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10)
        lib_how = "causal"
    else:
        mask = window_mask(torch, S, S, window, q.device)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), 10)
        lib_how = "a boolean window mask"
    bms, by = attention_bound(1, 10, 1, S, 256, 2, window)
    row = dict(times, bound_ms=bms, bound_by=by, library_ms=lib,
               library_how=lib_how, max_abs_dev=dev, instance="wgmma",
               fma_ms=sum(fma) / 2, fma_ms_samples=fma,
               wgmma_ms_in_turns=[times["ms_samples"][0], w2],
               shape=f"q (1, 10, {S}, 256), kv (1, 1, {S}, 256) bf16, "
                     f"causal, window {window}")
    log(f"time flash_attention [{row['shape']}] on the tensor-core "
        f"instance: {row['ms']:.4f} ms (samples {row['ms_samples'][0]:.4f}, "
        f"{row['ms_samples'][1]:.4f}; in turns with fma {w2:.4f}; "
        f"{bms / row['ms']:.3f} of the bound), plain {row['plain_ms']:.4f} "
        f"ms, bound {bms:.4f} ms ({by}), fp32-FMA instance forced "
        f"{row['fma_ms']:.4f} ms (samples {fma[0]:.4f}, {fma[1]:.4f}), "
        f"scaled_dot_product_attention {lib:.4f} ms ({lib_how}); max|dev| "
        f"{dev:.3e} ({share:.2f}x the limit)")
    if cuda:
        check(max(row["ms_samples"][0], w2) <= min(fma),
              f"flash D = 256 at S = {S}: the tensor-core instance "
              f"({row['ms_samples'][0]:.4f}, {w2:.4f} ms) is slower than "
              f"the fp32-FMA one ({fma[0]:.4f}, {fma[1]:.4f} ms)")
    return row


def rglru_timing(torch, cfg, params, S=2048, seed=3):
    """One RG-LRU layer's recurrence at S: ``rglru_scan`` (gates and the
    log-depth scan) and ``linear_scan`` alone, by CUDA events, on layer 0's
    weights and a bf16 input (1, S, lru_width)."""
    from repro_torch.models import rglru
    layer = params.layers[0].mixer
    gen = torch.Generator(device=params.device)
    gen.manual_seed(seed)
    x = torch.randn((1, S, cfg.lru_width), generator=gen,
                    device=params.device,
                    dtype=torch.float32).to(params.embed.dtype)
    log_a, b = rglru._gates(layer, x)
    a = torch.exp(log_a)
    scan_ms = cuda_ms(torch, lambda: rglru.rglru_scan(layer, x), 10)
    linear_ms = cuda_ms(torch, lambda: rglru.linear_scan(a, b), 10)
    rounds = math.ceil(math.log2(S))
    log(f"time rglru_scan [(1, {S}, {cfg.lru_width}) bf16, layer 0]: "
        f"{scan_ms:.4f} ms a layer (the scan alone, {rounds} Hillis-Steele "
        f"rounds: {linear_ms:.4f} ms)")
    return dict(scan_ms=scan_ms, linear_scan_ms=linear_ms, S=S,
                rounds=rounds)


def cross_inputs(torch, case, dtype, device, seed):
    """q (B, H, Sq, D), k and v (B, KV, Sk, D) from a seeded generator, as
    ``.transpose(1, 2)`` views of (B, S, heads, D) buffers, the way
    ``attention.cross_attend`` and ``self_attend`` feed the kernel."""
    B, H, KV, Sq, Sk, D = case
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(S, heads):
        return torch.randn((B, S, heads, D), generator=gen, device=device,
                           dtype=torch.float32).to(
                               getattr(torch, dtype)).transpose(1, 2)
    return draw(Sq, H), draw(Sk, KV), draw(Sk, KV)


def cross_checks(torch, ops, ref, device, devs: dict):
    """``flash_attention`` with keys of their own length (CROSS_CASES) and
    at the encoder's shape (ENCODER_CASE), non-causal, and at the causal
    shapes of the new models' paths (CAUSAL_PATH_CASES), against
    ``ref.mha`` on the same inputs, within the flash limits: fp32 on the
    fp32-FMA instance, bf16 on both (the tensor-core one, the wrapper's
    choice, and the fp32-FMA one by name), one launch of the instance
    each; then a causal and a windowed call with Sk != Sq must raise
    ValueError before any launch."""
    on_card = torch.device(device).type == "cuda"
    cases = [("encoder" if case == ENCODER_CASE else "cross", case, False)
             for case in CROSS_CASES + [ENCODER_CASE]]
    cases += [(path, (B, H, KV, S, S, D), True)
              for path, (B, H, KV, S, D) in CAUSAL_PATH_CASES]
    for i, (path, case, causal) in enumerate(cases):
        B, H, KV, Sq, Sk, D = case
        mask = "causal" if causal else "non-causal"
        for dtype in ("float32", "bfloat16"):
            q, k, v = cross_inputs(torch, case, dtype, device, seed=100 + i)
            want = ref.mha(q, k, v, causal=causal)
            runs = ["plain"]
            if on_card:
                runs = ["wgmma", "fma"] if dtype == "bfloat16" else ["fma"]
                check(ops.flash_instance(q.dtype, D, q, k, v) == runs[0],
                      f"flash_attention {path} {case} {dtype}: the wrapper "
                      f"does not pick {runs[0]}")
            for instance in runs:
                before = dict(ops.flash_launches)
                if instance == runs[0]:
                    got = ops.flash_attention(q, k, v, causal=causal)
                else:
                    got = ops._flash_launch(q, k, v, instance, causal=causal,
                                            window=None, sm_scale=None)
                what = (f"flash_attention {path} B={B} H={H} KV={KV} "
                        f"Sq={Sq} Sk={Sk} D={D} {mask} {dtype} "
                        f"[{instance}]")
                if on_card:
                    ran = {n: c - before[n]
                           for n, c in ops.flash_launches.items()}
                    check(ran[instance] == 1 and sum(ran.values()) == 1,
                          f"{what}: launched {ran}")
                check(tuple(got.shape) == tuple(q.shape)
                      and got.dtype == q.dtype,
                      f"{what}: output {tuple(got.shape)} {got.dtype}")
                check(bool(torch.isfinite(got).all()),
                      f"{what}: non-finite output")
                dev, share = flash_deviation(torch, got, want, dtype)
                record(devs, "flash_attention", dtype, dev)
                check(share <= 1.0, f"{what}: max|dev| {dev:.3e} is "
                      f"{share:.2f}x the limit")
                log(f"check {what}: max|dev| {dev:.3e} ({share:.3f} of the "
                    "limit)")
    q, k, v = cross_inputs(torch, CROSS_CASES[1], "bfloat16", device, seed=0)
    before = dict(ops.launches), dict(ops.flash_launches)
    for kw in (dict(causal=True), dict(causal=False, window=64)):
        try:
            ops.flash_attention(q, k, v, **kw)
        except ValueError:
            continue
        check(False, f"flash_attention with Sk != Sq and {kw} did not raise")
    check((dict(ops.launches), dict(ops.flash_launches)) == before,
          "a refused flash_attention call launched a kernel")
    log("check flash_attention with Sk != Sq under a causal mask or a "
        "window: ValueError, no launch")


def cross_timings(torch, ops, ref, device):
    """seamless-m4t-large-v2's two non-causal flash paths at the lockstep
    batch's shapes in bf16: the encoder (q and kv (4, 16, 1024, 64)) and
    the cross-attention of 1000-token prompts over the 1024 frames.  The
    kernel (the tensor-core instance, as on the path) against its plain
    version, then the two in turns, beside the bound and
    ``scaled_dot_product_attention`` on the same inputs.  Returns one row
    each."""
    F = torch.nn.functional
    rows = []
    for path, case in (("encoder", (4, 16, 16, 1024, 1024, 64)),
                       ("cross", (4, 16, 16, 1000, 1024, 64))):
        B, H, KV, Sq, Sk, D = case
        q, k, v = cross_inputs(torch, case, "bfloat16", device, seed=Sq)
        check(ops.flash_instance(q.dtype, D, q, k, v) == "wgmma",
              f"seamless's {path} attention does not take the tensor-core "
              "instance")
        got = ops.flash_attention(q, k, v, causal=False)
        dev, share = flash_deviation(
            torch, got, ref.mha(q, k, v, causal=False), "bfloat16")
        check(share <= 1.0, f"flash {path}: max|dev| {dev:.3e} is "
              f"{share:.2f}x the limit")
        times = paired_ms(
            torch, lambda: ops.flash_attention(q, k, v, causal=False),
            lambda: ref.mha(q, k, v, causal=False), 20, 3)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=False), 20)
        bms, by = attention_bound(B, H, KV, Sq, D, 2, Sk=Sk, causal=False)
        row = dict(times, bound_ms=bms, bound_by=by, library_ms=lib,
                   max_abs_dev=dev, instance="wgmma",
                   tflops=4 * B * H * D * Sq * Sk / times["ms"] / 1e9,
                   shape=f"{path}: q ({B}, {H}, {Sq}, {D}), kv ({B}, {KV}, "
                         f"{Sk}, {D}) bf16, non-causal")
        log(f"time flash_attention [{row['shape']}]: {row['ms']:.4f} ms "
            f"(samples {row['ms_samples'][0]:.4f}, "
            f"{row['ms_samples'][1]:.4f}; {row['tflops']:.1f} TFLOP/s, "
            f"{bms / row['ms']:.3f} of the bound), plain "
            f"{row['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"scaled_dot_product_attention {lib:.4f} ms; max|dev| "
            f"{dev:.3e} ({share:.2f}x the limit)")
        rows.append(row)
    return rows


def media_forward(torch, ops, cfg, params, *, rows=2, text=VLM_TEXT,
                  seed=4, tol=MODEL_TOL["bfloat16"], control=False):
    """``model.forward`` of a VLM behind a media prefix, (rows,
    frontend_len, d_model) from a seeded generator, in front of ``text``
    tokens a row, with the counters set to 0 just before and read just
    after: one flash launch per layer over prefix and text, no other
    kernel; logits of the text positions only, finite; against the same
    forward with the plain attention swapped in (within ``tol``; with
    ``control``, also ``position_control``), and against the text alone
    (logged: what the prefix moves).  Returns the launches, the time and
    the deviations."""
    import numpy as np
    from repro_torch.models import attention, model
    device = params.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    media = torch.randn((rows, cfg.frontend_len, cfg.d_model), generator=gen,
                        device=device,
                        dtype=torch.float32).to(params.embed.dtype)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (rows, text))
    batch = {"tokens": toks, "media": media}
    label = (f"{cfg.name} forward, media prefix ({rows}, {cfg.frontend_len}, "
             f"{cfg.d_model}) + {text} tokens")
    synchronize(torch, device)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, batch, cfg)
    synchronize(torch, device)
    ms = 1e3 * (time.perf_counter() - t0)
    launches, instances = dict(ops.launches), dict(ops.flash_launches)
    check(launches["flash_attention"] == kernel_layers(cfg),
          f"{label}: {launches['flash_attention']} flash launches, expected "
          f"{kernel_layers(cfg)}")
    for name, count in launches.items():
        check(name == "flash_attention" or count == 0,
              f"{label}: launched {name}")
    check(tuple(logits.shape) == (rows, text, cfg.padded_vocab),
          f"{label}: logits {tuple(logits.shape)}, expected the text "
          "positions only")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    kernel_attend = attention.self_attend
    attention.self_attend = plain_self_attend
    try:
        plain, _ = model.forward(params, batch, cfg)
    finally:
        attention.self_attend = kernel_attend
    dev = float((logits.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    text_only, _ = model.forward(params, {"tokens": toks}, cfg)
    moved = float((logits.float() - text_only.float()).abs().max())
    log(f"model {label}: {ms:.2f} ms, logits {tuple(logits.shape)}, "
        f"{launches['flash_attention']} flash launches "
        f"{json.dumps(instances)}; kernel vs plain attention max|dev| {dev:.4e} (limit {tol:g}), "
        f"max|logit| {scale:.4f}; the prefix moves the text logits by up to "
        f"{moved:.4f}")
    check(dev <= tol, f"{label}: max|dev| {dev:.4e} > {tol}")
    ctrl = (position_control(torch, logits, plain, tol, label) if control
            else None)
    return dict(launches=launches["flash_attention"], instances=instances,
                ms=ms, max_abs_dev=dev, max_abs_logit=scale,
                prefix_moves=moved, tol=tol, control_dev=ctrl)


def plain_cross_attend(q, k, v):
    """The plain cross-attention on any device (the check's yardstick)."""
    import torch
    from repro_torch.models import attention
    return attention._attend(q, k, v, torch.arange(q.shape[1],
                                                   device=q.device),
                             torch.arange(k.shape[1], device=q.device),
                             causal=False, window=None)


@contextlib.contextmanager
def flash_paths(ops, counts):
    """Within the block, ``counts`` (a Counter) gathers the flash launches
    of each attention path of an encoder-decoder — "encoder" (non-causal
    self-attention), "decoder" (causal self-attention), "cross" — as the
    change of ``ops.launches["flash_attention"]`` around each call of
    ``attention.self_attend`` and ``attention.cross_attend``."""
    from repro_torch.models import attention
    self_attend, cross_attend = attention.self_attend, attention.cross_attend

    def counted(fn, path_of):
        def run(*args, **kw):
            before = ops.launches["flash_attention"]
            out = fn(*args, **kw)
            counts[path_of(kw)] += ops.launches["flash_attention"] - before
            return out
        return run
    attention.self_attend = counted(
        self_attend, lambda kw: "decoder" if kw["causal"] else "encoder")
    attention.cross_attend = counted(cross_attend, lambda kw: "cross")
    try:
        yield counts
    finally:
        attention.self_attend = self_attend
        attention.cross_attend = cross_attend


def encdec_generate(torch, ops, cfg, params, tokens, enc_media, *,
                    new=ENCDEC_NEW, max_len=ENCDEC_LEN, instance="wgmma"):
    """An encoder-decoder's serving path, the one the JAX package's tests
    drive: ``prefill({"tokens", "enc_media"})`` of a lockstep batch, then
    greedy ``decode_step``s over the seeded cache, ``new`` tokens a row
    (the first from the prefill's last logits).  The counters are set to 0
    just before and read just after: one flash launch per encoder layer,
    per decoder layer and per cross-attention, no other kernel (decode
    attends in plain torch), all on ``instance`` on the card.  Returns the
    tokens, the launches by path and the encoder (inside the prefill),
    prefill and decode times."""
    from repro_torch.models import model
    from repro_torch.models.prefill import prefill
    device = params.device
    B, S = tokens.shape
    encoder_ms = []
    encode = model.encode

    def timed_encode(*args, **kw):
        synchronize(torch, device)
        t0 = time.perf_counter()
        out = encode(*args, **kw)
        synchronize(torch, device)
        encoder_ms.append(1e3 * (time.perf_counter() - t0))
        return out
    counts = collections.Counter()
    decode_ms = []
    model.encode = timed_encode
    ops.reset_launches()
    try:
        with flash_paths(ops, counts):
            synchronize(torch, device)
            t0 = time.perf_counter()
            logits, cache, pos = prefill(
                params, {"tokens": tokens, "enc_media": enc_media}, cfg,
                max_len)
            tok = torch.argmax(logits[:, -1], dim=-1)
            synchronize(torch, device)
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            out = [tok]
            for t in range(new - 1):
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, tok,
                                                  pos + t, cfg)
                tok = torch.argmax(logits, dim=-1)
                synchronize(torch, device)
                decode_ms.append(1e3 * (time.perf_counter() - t0))
                out.append(tok)
    finally:
        model.encode = encode
    launches, instances = dict(ops.launches), dict(ops.flash_launches)
    E, L = cfg.num_encoder_layers, cfg.num_layers
    label = f"{cfg.name} lockstep B={B} S={S}"
    check(dict(counts) == {"encoder": E, "decoder": L, "cross": L},
          f"{label}: flash launches by path {dict(counts)}, expected "
          f"encoder {E}, decoder {L}, cross {L}")
    check(launches["flash_attention"] == E + 2 * L,
          f"{label}: {launches['flash_attention']} flash launches")
    for name, count in launches.items():
        check(name == "flash_attention" or count == 0,
              f"{label}: launched {name}")
    if device.type == "cuda":
        check(instances == {**{k: 0 for k in instances},
                            instance: E + 2 * L},
              f"{label}: flash launches by instance {instances}, expected "
              f"all on {instance}")
    gen = torch.stack(out, dim=1).cpu()
    check(tuple(gen.shape) == (B, new) and bool(
        ((gen >= 0) & (gen < cfg.padded_vocab)).all()),
        f"{label}: generated {gen.tolist()}")
    steps = sorted(decode_ms)
    log(f"encdec {label} + {new} new: encoder {encoder_ms[0]:.2f} ms, "
        f"prefill {prefill_ms:.2f} ms (the encoder included), decode median "
        f"{steps[len(steps) // 2]:.2f} ms a step (min {steps[0]:.2f}, max "
        f"{steps[-1]:.2f}); flash launches by path {json.dumps(counts)}, by "
        f"instance {json.dumps(instances)}; first tokens "
        f"{gen[:, :4].tolist()}")
    return dict(B=B, S=S, tokens=gen.tolist(), launches_by_path=dict(counts),
                launches=launches["flash_attention"], instances=instances,
                encoder_ms=encoder_ms[0], prefill_ms=prefill_ms,
                decode_ms=decode_ms)


def encdec_kernel_vs_plain(torch, ops, cfg, params, tokens, enc_media, *,
                           label, tol, controls=None):
    """Prefill logits of an encoder-decoder with the kernel on its three
    attention paths (one launch per encoder layer, decoder layer and
    cross-attention) and with the plain attention swapped in on all
    three; returns (max |dev|, max |logit|).  With a ``controls`` dict,
    the limit also gets ``position_control``, stored there under
    ``label``."""
    from repro_torch.models import attention
    from repro_torch.models.prefill import prefill
    batch = {"tokens": tokens, "enc_media": enc_media}
    max_len = tokens.shape[1] + 1
    want = cfg.num_encoder_layers + 2 * cfg.num_layers
    before = ops.launches["flash_attention"]
    kern, _, _ = prefill(params, batch, cfg, max_len)
    check(ops.launches["flash_attention"] - before == want,
          f"{label}: the prefill did not launch the kernel {want} times")
    kernels = attention.self_attend, attention.cross_attend
    attention.self_attend = plain_self_attend
    attention.cross_attend = plain_cross_attend
    try:
        plain, _, _ = prefill(params, batch, cfg, max_len)
    finally:
        attention.self_attend, attention.cross_attend = kernels
    check(bool(torch.isfinite(kern).all()), f"{label}: non-finite logits")
    dev = float((kern.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    log(f"model {label}: prefill logits {tuple(kern.shape)}, kernel vs plain "
        f"attention on the encoder, decoder and cross paths max|dev| "
        f"{dev:.4e} (limit {tol:g}), max|logit| {scale:.4f}")
    check(dev <= tol, f"{label}: max|dev| {dev:.4e} > {tol}")
    if controls is not None:
        controls[label] = position_control(torch, kern, plain, tol, label)
    return dev, scale


def encdec_tokenwise(torch, cfg, params, prompt, enc_media, *, tol=None,
                     tokens=True, new=NEW_TOKENS, max_len=ENCDEC_LEN):
    """One prompt with its frames through block prefill and token by
    token.  Block: ``prefill`` of all but the prompt's last token (as the
    engine splices a prompt), then ``decode_step`` from the last one.
    Token-wise: ``init_cache``, its cross_kv from ``build_cross_cache``,
    then ``decode_step`` over every prompt token.  As
    ``tokenwise_agreement``: the first generated token's logits within
    ``tol`` with a control above it (the token-wise logits one position
    earlier), and with ``tokens`` the same greedy tokens.  Returns both
    paths' tokens and the deviations."""
    from repro_torch.models import model
    from repro_torch.models.prefill import prefill
    toks = torch.as_tensor(prompt, device=params.device)[None]

    def greedy(cache, tok, pos, logits):
        out = []
        for i in range(new):
            lg, cache = model.decode_step(params, cache, tok, pos + i, cfg)
            logits.append(lg.float())
            tok = torch.argmax(lg, dim=-1)
            out.append(int(tok[0]))
        return out

    fast_logits, slow_logits = [], []
    _, cache, pos = prefill(params, {"tokens": toks[:, :-1],
                                     "enc_media": enc_media}, cfg, max_len)
    fast = greedy(cache, toks[:, -1], pos, fast_logits)
    cache = model.init_cache(cfg, 1, max_len, device=params.device)
    cache["cross_kv"] = model.build_cross_cache(params, enc_media, cfg)
    for t in range(len(prompt) - 1):
        lg, cache = model.decode_step(params, cache, toks[:, t], t, cfg)
        slow_logits.append(lg.float())
    slow = greedy(cache, toks[:, -1], len(prompt) - 1, slow_logits)
    first = slow_logits[len(prompt) - 1]
    dev = float((fast_logits[0] - first).abs().max())
    control = float((fast_logits[0] - slow_logits[len(prompt) - 2])
                    .abs().max())
    top = torch.topk(first[0], 2).values
    label = (f"{cfg.name} {cfg.param_dtype}: a {len(prompt)}-token prompt "
             "with its frames, block prefill and token by token from "
             "build_cross_cache")
    log(f"{label}: first generated token's logits max|dev| {dev:.4e} "
        f"(limit {tol}; control, one position earlier, {control:.4e}; "
        f"max|logit| {float(first.abs().max()):.4f}, top-2 margin "
        f"{float(top[0] - top[1]):.4e}); tokens {fast} and {slow}")
    if tokens:
        check(fast == slow, f"{label}: tokens {fast} and {slow} differ")
    if tol is not None:
        check(dev <= tol, f"{label}: logits max|dev| {dev:.4e} > {tol}")
        check(control > tol, f"{label}: the control's logits max|dev| "
              f"{control:.4e} is within the limit {tol}")
    return dict(first_logits_dev=dev, control_dev=control, tol=tol,
                block=fast, tokenwise=slow, equal=fast == slow,
                dtype=cfg.param_dtype)


def encdec_phase(torch, ops, cfg, params, *, prompts=ENCDEC_PROMPTS,
                 seed=5):
    """An encoder-decoder at full width: each batch of ``prompts`` (equal
    lengths a batch) with its own frames (a seeded generator, in the
    model's dtype) through ``encdec_generate``; the prefill logits of the
    first batch's first row with the kernel against the plain attention
    (ENCDEC_MODEL_TOL, with its control); the last batch's first prompt
    through ``encdec_tokenwise`` at the bf16 limit.  Returns the runs, the
    in-model deviation and its control, the token-wise record, and that
    prompt with its frames (for an fp32 copy)."""
    import numpy as np
    device = params.device
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    runs, inputs = [], []
    for lengths in prompts:
        toks = rng.integers(0, cfg.vocab_size, (len(lengths), lengths[0]))
        media = torch.randn((len(lengths), cfg.frontend_len, cfg.d_model),
                            generator=gen, device=device,
                            dtype=torch.float32).to(params.embed.dtype)
        inputs.append((toks, media))
        runs.append(encdec_generate(torch, ops, cfg, params, toks, media))
    toks, media = inputs[0]
    controls = {}
    in_model = encdec_kernel_vs_plain(
        torch, ops, cfg, params, toks[:1], media[:1],
        label=f"{cfg.name} {cfg.param_dtype} {cfg.num_encoder_layers} + "
              f"{cfg.num_layers} layers", tol=ENCDEC_MODEL_TOL,
        controls=controls)
    short, short_media = inputs[-1][0][0].tolist(), inputs[-1][1][:1]
    tokenwise = [encdec_tokenwise(torch, cfg, params, short, short_media,
                                  tol=ENCDEC_TOKENWISE_TOL, tokens=False)]
    return dict(runs=runs, in_model=in_model,
                in_model_control=controls.popitem()[1], tokenwise=tokenwise,
                short=(short, short_media))


def backward_inputs(torch, ops, case, dtype, device, seed):
    """q, k, v and do as the model's (B, rows, heads, D) buffers seen
    through ``.transpose(1, 2)``, and o = flash_attention(q, k, v) (the
    kernel on the card)."""
    B, H, KV, S, Sk, D, causal, window = case
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(heads, rows):
        return torch.randn((B, rows, heads, D), generator=gen, device=device,
                           dtype=torch.float32).to(
                               getattr(torch, dtype)).transpose(1, 2)
    q, k, v, do = draw(H, S), draw(KV, Sk), draw(KV, Sk), draw(H, S)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return q, k, v, o, do


def backward_deviation(torch, got, want, dtype):
    """(max |dev|, max |dev| / max |want|, the share of the limit used)
    of one gradient: fp32 against BACKWARD_TOL_F32 max |want|, bf16
    against one bf16 ulp of each plain entry plus that floor."""
    dev = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    worst = float(dev.max())
    floor = BACKWARD_TOL_F32 * scale
    if dtype == "float32":
        share = worst / floor if floor > 0 else (0.0 if worst == 0 else
                                                 math.inf)
    else:
        share = float((dev / (BF16_ULP * want.float().abs() + floor)).max())
    return worst, worst / max(scale, 1e-30), share


def backward_checks(torch, ops, ref, device, devs: dict, *,
                    cases=None, dtypes=("float32", "bfloat16"),
                    delta=False):
    """At every case of ``cases`` (BACKWARD_CASES), in each of ``dtypes``
    (fp32 and bf16; with ``delta``, both sides of the backward given
    delta = rowsum(do * o) from the plain fp32 output, as the training
    path gives it from the forward's unrounded o): the forward
    ``flash_attention`` against ``ref.mha`` (one launch of the instance
    ``ops.flash_instance`` names, within FLASH_TOL_F32 or one bf16 ulp);
    then ``flash_attention_backward`` against ``ref.mha_backward``, both
    fed the plain o (two launches of the instance
    ``ops.flash_backward_instance`` names: bf16 at D = 64/128 on the
    tensor cores): each of dq, dk, dv within its limit, in its input's
    dtype and layout, finite; two launches on the same inputs equal bit
    for bit; the control above the limit.  Returns the readings."""
    cuda = torch.device(device).type == "cuda"
    readings = []
    for i, (label, case) in enumerate(BACKWARD_CASES if cases is None
                                      else cases):
        B, H, KV, S, Sk, D, causal, window = case
        for dtype in dtypes:
            kw = dict(causal=causal, window=window)
            shape = (f"{label} B={B} H={H} KV={KV} S={S} Sk={Sk} D={D} "
                     f"causal={causal} window={window} {dtype}")
            before = dict(ops.flash_launches)
            q, k, v, o, do = backward_inputs(torch, ops, case, dtype, device,
                                             seed=100 + i)
            instance = "plain"
            if cuda:
                instance = ops.flash_instance(q.dtype, D, q, k, v)
                ran = {name: n - before[name]
                       for name, n in ops.flash_launches.items()}
                check(ran[instance] == 1 and sum(ran.values()) == 1,
                      f"flash_attention {shape}: launched {ran}, expected "
                      f"one {instance} launch")
            plain_o = ref.mha(q, k, v, **kw)
            check(bool(torch.isfinite(o).all()),
                  f"flash_attention {shape}: non-finite output")
            dev, share = flash_deviation(torch, o, plain_o, dtype)
            record(devs, "flash_attention", dtype, dev)
            log(f"check flash_attention {shape} [{instance}]: max|dev| "
                f"{dev:.3e} ({share:.3f} of the limit)")
            check(share <= 1.0, f"flash_attention {shape}: max|dev| "
                  f"{dev:.3e} is {share:.2f}x the limit")
            o = plain_o
            if delta:
                full = ref.mha(q.float(), k.float(), v.float(), **kw)
                kw["delta"] = (do.float() * full).sum(-1)
                shape += " delta from the fp32 o"
                del full
            before = ops.launches["flash_attention_backward"]
            by = dict(ops.flash_backward_launches)
            got = ops.flash_attention_backward(q, k, v, o, do, **kw)
            again = ops.flash_attention_backward(q, k, v, o, do, **kw)
            what = f"flash_attention_backward {shape}"
            if cuda:
                instance = ops.flash_backward_instance(q.dtype, D, q, k, v, o,
                                                       do)
                what += f" [{instance}]"
                check(ops.launches["flash_attention_backward"] - before == 2
                      and ops.flash_backward_launches[instance]
                      - by[instance] == 2,
                      f"{what}: did not launch the kernel twice on its "
                      "instance")
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{what}: two launches on the same inputs differ")
            del again
            want = ref.mha_backward(q, k, v, o, do, **kw)
            reading = {}
            for name, g, w, t in zip(("dq", "dk", "dv"), got, want,
                                     (q, k, v)):
                check(tuple(g.shape) == tuple(t.shape) and g.dtype == t.dtype
                      and (not cuda or g.stride() == t.stride()),
                      f"{what}: {name} {tuple(g.shape)} {g.dtype} "
                      f"{g.stride()} is not laid out as its input")
                check(bool(torch.isfinite(g).all()),
                      f"{what}: non-finite {name}")
                reading[name] = backward_deviation(torch, g, w, dtype)
            splits = ops.backward_splits(H, KV, S, D, instance)
            whole = None
            if cuda and splits > 1 and D < 256:
                # the earlier instance, the whole group in one block of
                # pass B: read, not gated
                whole = {n: backward_deviation(torch, g, w, dtype)[2]
                         for n, g, w in zip(("dq", "dk", "dv"),
                                            ops._flash_backward_launch(
                                                q, k, v, o, do, instance,
                                                sm_scale=None, splits=1,
                                                **kw), want)}
                log(f"check {what}: pass B over {H // KV // splits} of the "
                    f"group's {H // KV} heads a block ({splits} splits); "
                    "the whole group in one block (splits 1) reads "
                    + ", ".join(f"{n} {sh:.3f}" for n, sh in whole.items())
                    + " of the limit")
            control = float((got[0][:, :, 1:].float()
                             - want[0][:, :, :-1].float()).abs().max()) / max(
                float(want[0].float().abs().max()), 1e-30)
            log(f"check {what}: " + ", ".join(
                f"max|d{n[1:]} dev| {d:.3e} ({r:.2e} of max|{n}|, {sh:.3f} "
                f"of the limit)" for n, (d, r, sh) in reading.items())
                + f"; control (dq one row earlier) {control:.3e} of max|dq|")
            for name, (_, _, share) in reading.items():
                check(share <= 1.0, f"{what}: {name} at {share:.3f}x its "
                      "limit")
            check(control > BACKWARD_TOL_F32, f"{what}: the control "
                  f"{control:.3e} is within the fp32 limit")
            record(devs, "flash_attention_backward", dtype,
                   max(d for d, _, _ in reading.values()))
            readings.append(dict(case=label, dtype=dtype, control=control,
                                 instance=instance, splits=splits,
                                 unsplit_share=whole,
                                 **{n: dict(max_abs_dev=d, rel=r, share=sh)
                                    for n, (d, r, sh) in reading.items()}))
            del q, k, v, o, do, got, want, plain_o
            if cuda:
                torch.cuda.empty_cache()
    return readings


def backward_executed(instance: str, D: int) -> int:
    """Flops a visible (query, key) pair per D that a backward instance
    executes: fp32 FMAs 16 (s, dP and dS in passes 2 and 3, dV, dK, dQ);
    tensor cores 22 at D = 64/128 (s three times, dP twice, and dV, dK, dQ
    each with two bf16 terms of P or dS) and 26 at D = 256, where the two
    blocks that split dk and dv over D each compute s and dP again."""
    if instance == "fma":
        return 16
    return 26 if D == 256 else 22


def backward_bound(case, itemsize=2):
    """The least time of one backward: 10 D flops a visible (query, key)
    pair (s, dP, dV, dK, dQ: two each) at the bf16 tensor peak, or q, k,
    v, o, do read and dq, dk, dv written once at the memory rate
    (``kernels.cost.attention_backward_work``)."""
    from repro_torch.kernels import cost
    flops, nbytes, pairs = cost.attention_backward_work(*case, itemsize)
    return bound(flops, nbytes, PEAK_BF16), pairs


def sdpa_backward_ms(torch, q, k, v, do, causal, window):
    """The library's time: the backward of one
    ``scaled_dot_product_attention`` call on the same inputs (autograd
    of its q, k, v; the forward outside the timed region).  Without a
    window the dispatcher picks the backend (``is_causal``); with one, the
    causal window goes in as a boolean ``attn_mask`` built once, and the
    memory-efficient backend runs it where it takes the call (GQA by
    ``enable_gqa``, else with k and v repeated to the query heads inside
    the graph), else the math backend.  Returns (ms, backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    H, KV = q.shape[1], k.shape[1]
    if window is None:
        tries = [("default", None, False)]
        kw = dict(is_causal=causal)
    else:
        S, Sk = q.shape[2], k.shape[2]
        kw = dict(attn_mask=window_mask(torch, S, Sk, window, q.device))
        tries = [("efficient, enable_gqa", SDPBackend.EFFICIENT_ATTENTION,
                  False),
                 ("efficient, k and v repeated to the query heads",
                  SDPBackend.EFFICIENT_ATTENTION, True),
                 ("math, enable_gqa", SDPBackend.MATH, False)]
    for backend, which, repeat in tries:
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

        def forward():
            kk, vv = ks, vs
            if repeat:
                kk, vv = (t.repeat_interleave(H // KV, dim=1)
                          for t in (ks, vs))
            return F.scaled_dot_product_attention(
                qs, kk, vv, enable_gqa=H != KV and not repeat, **kw)
        try:
            if which is None:
                out = forward()
            else:
                with sdpa_kernel([which]):
                    out = forward()
        except RuntimeError as err:
            log(f"scaled_dot_product_attention [{backend}] refused "
                f"q {tuple(q.shape)} kv {tuple(k.shape)} window {window}: "
                f"{str(err).splitlines()[0][:160]}")
            continue
        ms = cuda_ms(torch, lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), 10)
        del out
        return ms, backend
    check(False, f"no backend of scaled_dot_product_attention took q "
          f"{tuple(q.shape)} kv {tuple(k.shape)} window {window}")


def backward_timings(torch, ops, ref, device, *, cases=None, reps=None,
                     delta=False):
    """The kernel beside ``ref.mha_backward`` (in turns), its bound and
    the backward of ``scaled_dot_product_attention`` on the same bf16
    inputs (the library's time, ``sdpa_backward_ms``), at every case of
    ``cases`` (BACKWARD_CASES: the first row is qwen3-14b's, also timed on
    fp32 inputs, ``fp32_ms``).  ``reps``: (kernel, plain) calls a sample
    at every case, and no fp32 row.  ``delta``: both given delta, as the
    training path gives it."""
    rows = []
    for i, (label, case) in enumerate(BACKWARD_CASES if cases is None
                                      else cases):
        B, H, KV, S, Sk, D, causal, window = case
        q, k, v, o, do = backward_inputs(torch, ops, case, "bfloat16", device,
                                         seed=200 + i)
        kw = dict(causal=causal, window=window)
        if delta:
            kw["delta"] = (do.float() * o.float()).sum(-1)
        big = i == 0 and reps is None
        times = paired_ms(
            torch, lambda: ops.flash_attention_backward(q, k, v, o, do, **kw),
            lambda: ref.mha_backward(q, k, v, o, do, **kw),
            *(reps or ((3, 1) if big else (10, 3))))
        lib, backend = sdpa_backward_ms(torch, q, k, v, do, causal, window)
        (bms, by), pairs = backward_bound(case)
        instance = ops.flash_backward_instance(q.dtype, D, q, k, v, o, do)
        per_pair = backward_executed(instance, D)
        splits = ops.backward_splits(H, KV, S, D, instance)
        if splits > 1 and D < 256:
            # the split pass B against the whole group in one block (the
            # instance before the split), in turns
            both = paired_ms(
                torch, lambda: ops.flash_attention_backward(q, k, v, o, do,
                                                            **kw),
                lambda: ops._flash_backward_launch(
                    q, k, v, o, do, instance, sm_scale=None, splits=1, **kw),
                (reps or (10,))[0], (reps or (10,))[0])
            times.update(unsplit_ms=both["plain_ms"],
                         unsplit_ms_samples=both["plain_ms_samples"],
                         split_ms_in_turns=both["ms"])
        row = dict(times, bound_ms=bms, bound_by=by, library_ms=lib,
                   library_backend=backend, case=label, instance=instance,
                   splits=splits,
                   tflops=per_pair * B * H * pairs * D / times["ms"] / 1e9,
                   shape=f"q (B={B}, H={H}, S={S}, D={D}), kv (KV={KV}, "
                         f"Sk={Sk}) bf16, causal={causal}, window={window}")
        if big:
            q32, k32, v32, o32, do32 = (t.float() for t in (q, k, v, o, do))
            row["fp32_ms"] = cuda_ms(torch, lambda: ops.flash_attention_backward(
                q32, k32, v32, o32, do32, **kw), 2)
            del q32, k32, v32, o32, do32
        rows.append(row)
        lib_text = f"{lib:.4f} ms [{backend}]"
        log(f"time flash_attention_backward {label} [{row['shape']}] "
            f"[{instance}]: {row['ms']:.4f} ms (samples "
            f"{row['ms_samples'][0]:.4f}, {row['ms_samples'][1]:.4f}; "
            f"{row['tflops']:.2f} TFLOP/s at {per_pair} D a pair, "
            f"{bms / row['ms']:.4f} of the bound), plain "
            f"{row['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"scaled_dot_product_attention backward {lib_text}"
            + (f"; fp32 inputs {row['fp32_ms']:.4f} ms" if big else "")
            + (f"; pass B in {splits} splits {row['split_ms_in_turns']:.4f} "
               f"ms against the whole group in one block "
               f"{row['unsplit_ms']:.4f} ms (samples "
               f"{row['unsplit_ms_samples'][0]:.4f}, "
               f"{row['unsplit_ms_samples'][1]:.4f}), in turns"
               if "unsplit_ms" in row else ""))
        del q, k, v, o, do
        torch.cuda.empty_cache()
    return dict(rows[0], variants=rows[1:])


def kernel_split(torch, fn, reps: int = 3):
    """{kernel<args>: device ms a call} of the kernels ``fn`` launches,
    from ``torch.profiler`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"(\w+<[^()]*>)", e.name)
            split[name.group(1) if name else e.name[:60]] += (
                e.time_range.elapsed_us() / 1e3 / reps)
    return dict(split)


def forward_instance_checks(torch, ops, ref, device, devs: dict):
    """Phase 16, the forward: at every case of BACKWARD_CASES, in bf16,
    both instances of ``flash_attention`` forced by name on the same
    inputs (the model's transposed buffers) against ``ref.mha``: each
    within one bf16 ulp (plus 1e-6) of the plain output, two launches
    equal bit for bit and counted on their instance; then the two timed in
    turns (wgmma, fma, fma, wgmma; CUDA events), the tensor-core one no
    slower.  On CPU tensors (a rehearsal) both names run the wrapper's
    plain version and nothing is timed.  Returns a row a case."""
    cuda = torch.device(device).type == "cuda"
    rows = []
    for i, (label, case) in enumerate(BACKWARD_CASES):
        B, H, KV, S, Sk, D, causal, window = case
        kw = dict(causal=causal, window=window)
        q, k, v, _, _ = backward_inputs(torch, ops, case, "bfloat16", device,
                                        seed=400 + i)
        want = ref.mha(q, k, v, **kw)
        runs = {inst: (lambda inst=inst: ops._flash_launch(
            q, k, v, inst, sm_scale=None, **kw))
            if cuda else (lambda: ops.flash_attention(q, k, v, **kw))
            for inst in ops.FLASH_INSTANCES}
        row = dict(case=label, shape=f"q (B={B}, H={H}, S={S}, D={D}), kv "
                   f"(KV={KV}, Sk={Sk}) bf16, causal={causal}, "
                   f"window={window}")
        for inst, run in runs.items():
            what = f"flash_attention {label} bf16 [{inst}, forced]"
            before = dict(ops.flash_launches)
            got, again = run(), run()
            if cuda:
                check(ops.flash_launches[inst] - before[inst] == 2,
                      f"{what}: did not launch its instance twice")
            check(torch.equal(got, again),
                  f"{what}: two launches on the same inputs differ")
            dev, share = flash_deviation(torch, got, want, "bfloat16")
            log(f"check {what}: max|dev| {dev:.3e} ({share:.3f} of the "
                "limit)")
            check(share <= 1.0, f"{what}: max|dev| {dev:.3e} is "
                  f"{share:.2f}x the limit")
            record(devs, "flash_attention", "bfloat16", dev)
            row[inst] = dict(max_abs_dev=dev, share=share)
            del got, again
        if cuda:
            w1 = cuda_ms(torch, runs["wgmma"], 20)
            f1 = cuda_ms(torch, runs["fma"], 3)
            f2 = cuda_ms(torch, runs["fma"], 3)
            w2 = cuda_ms(torch, runs["wgmma"], 20)
            for inst, (t1, t2) in (("wgmma", (w1, w2)), ("fma", (f1, f2))):
                row[inst].update(ms=(t1 + t2) / 2, ms_samples=[t1, t2])
            row["bound_ms"], row["bound_by"] = attention_bound(
                B, H, KV, S, D, 2, window, Sk, causal)
            log(f"time flash_attention instances {label} [{row['shape']}]: "
                f"wgmma {row['wgmma']['ms']:.4f} ms (samples {w1:.4f}, "
                f"{w2:.4f}), fma {row['fma']['ms']:.4f} ms (samples "
                f"{f1:.4f}, {f2:.4f}), bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}); wgmma / fma "
                f"{row['wgmma']['ms'] / row['fma']['ms']:.4f}")
            check(row["wgmma"]["ms"] <= row["fma"]["ms"],
                  f"flash_attention {label}: the tensor-core instance "
                  f"({row['wgmma']['ms']:.4f} ms) is slower than the "
                  f"fp32-FMA one ({row['fma']['ms']:.4f} ms)")
        rows.append(row)
        del q, k, v, want, runs
        if cuda:
            torch.cuda.empty_cache()
    return rows


def backward_instance_checks(torch, ops, ref, device, devs: dict):
    """Phase 16: at every case of BACKWARD_CASES (D = 64, 128 and 256:
    the tensor-core instance takes them all), in bf16, both instances of
    ``flash_attention_backward`` forced by name on the same inputs (o the
    plain forward's) against ``ref.mha_backward``: each of dq, dk, dv
    within the bf16 limit, two launches equal bit for bit and counted on
    their instance, the control above the limit; then the two timed in
    turns (wgmma, fma, fma, wgmma; CUDA events), the tensor-core one no
    slower, and each instance's device time split by kernel
    (``kernel_split``).  On CPU tensors (a rehearsal) both names run the wrapper's
    plain version and nothing is timed.  Returns a row a case."""
    cuda = torch.device(device).type == "cuda"
    rows = []
    for i, (label, case) in enumerate(BACKWARD_CASES):
        B, H, KV, S, Sk, D, causal, window = case
        kw = dict(causal=causal, window=window)
        q, k, v, _, do = backward_inputs(torch, ops, case, "bfloat16", device,
                                         seed=300 + i)
        o = ref.mha(q, k, v, **kw)
        want = ref.mha_backward(q, k, v, o, do, **kw)
        runs = {}
        for inst in ops.FLASH_BACKWARD_INSTANCES:
            def run(inst=inst):
                if not cuda:
                    return ops.flash_attention_backward(q, k, v, o, do, **kw)
                return ops._flash_backward_launch(q, k, v, o, do, inst,
                                                  sm_scale=None, **kw)
            runs[inst] = run
        row = dict(case=label, shape=f"q (B={B}, H={H}, S={S}, D={D}), kv "
                   f"(KV={KV}, Sk={Sk}) bf16, causal={causal}, "
                   f"window={window}")
        for inst, run in runs.items():
            what = f"flash_attention_backward {label} bf16 [{inst}, forced]"
            before = dict(ops.flash_backward_launches)
            got, again = run(), run()
            if cuda:
                check(ops.flash_backward_launches[inst] - before[inst] == 2,
                      f"{what}: did not launch its instance twice")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{what}: two launches on the same inputs differ")
            reading = {name: backward_deviation(torch, g, w, "bfloat16")
                       for name, g, w in zip(("dq", "dk", "dv"), got, want)}
            control = float((got[0][:, :, 1:].float()
                             - want[0][:, :, :-1].float()).abs().max()) / max(
                float(want[0].float().abs().max()), 1e-30)
            log(f"check {what}: " + ", ".join(
                f"max|d{n[1:]} dev| {d:.3e} ({sh:.3f} of the limit)"
                for n, (d, _, sh) in reading.items())
                + f"; control {control:.3e} of max|dq|")
            for name, (_, _, share) in reading.items():
                check(share <= 1.0, f"{what}: {name} at {share:.3f}x its "
                      "limit")
            check(control > BACKWARD_TOL_F32, f"{what}: the control "
                  f"{control:.3e} is within the fp32 limit")
            record(devs, "flash_attention_backward", "bfloat16",
                   max(d for d, _, _ in reading.values()))
            row[inst] = dict(control=control, **{
                n: dict(max_abs_dev=d, share=sh)
                for n, (d, _, sh) in reading.items()})
            del got, again
        if cuda:
            big = S * H * B >= 2 ** 18
            reps = {"wgmma": 10 if big else 20, "fma": 2 if big else 5}
            w1 = cuda_ms(torch, runs["wgmma"], reps["wgmma"])
            f1 = cuda_ms(torch, runs["fma"], reps["fma"])
            f2 = cuda_ms(torch, runs["fma"], reps["fma"])
            w2 = cuda_ms(torch, runs["wgmma"], reps["wgmma"])
            (bms, by), pairs = backward_bound(case)
            for inst, (t1, t2) in (("wgmma", (w1, w2)), ("fma", (f1, f2))):
                ms = (t1 + t2) / 2
                row[inst].update(ms=ms, ms_samples=[t1, t2],
                                 tflops=backward_executed(inst, D) * B * H
                                 * pairs * D / ms / 1e9)
            row.update(bound_ms=bms, bound_by=by)
            for inst, run in runs.items():
                row[inst]["kernels_ms"] = kernel_split(torch, run)
            log(f"time flash_attention_backward instances {label} "
                f"[{row['shape']}]: wgmma {row['wgmma']['ms']:.4f} ms "
                f"(samples {w1:.4f}, {w2:.4f}; "
                f"{row['wgmma']['tflops']:.1f} TFLOP/s at "
                f"{backward_executed('wgmma', D)} D a pair), fma "
                f"{row['fma']['ms']:.4f} ms (samples {f1:.4f}, {f2:.4f}; "
                f"{row['fma']['tflops']:.2f} TFLOP/s at 16 D a pair), bound "
                f"{bms:.4f} ms ({by}); wgmma / fma "
                f"{row['wgmma']['ms'] / row['fma']['ms']:.4f}; device ms "
                f"a call by kernel (torch.profiler): " + ", ".join(
                    f"{name} {ms:.4f}" for inst in runs
                    for name, ms in row[inst]["kernels_ms"].items()))
            check(row["wgmma"]["ms"] <= row["fma"]["ms"],
                  f"flash_attention_backward {label}: the tensor-core "
                  f"instance ({row['wgmma']['ms']:.4f} ms) is slower than "
                  f"the fp32-FMA one ({row['fma']['ms']:.4f} ms)")
        rows.append(row)
        del q, k, v, o, do, want, runs
        if cuda:
            torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def counted_calls(targets):
    """Counts the calls of each ``(module, name)`` function of ``targets``
    inside the block, by name, and puts the functions back after."""
    calls = collections.Counter()
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name, fn in saved:
        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def counted_plain(ref, attention):
    """Counts the calls of the plain attention and its plain backward
    (``ref.mha``, ``ref.mha_backward``, ``attention._attend``) inside the
    block."""
    return counted_calls([(ref, "mha"), (ref, "mha_backward"),
                          (attention, "_attend")])


def leaf_deviation(torch, got, want) -> float:
    """max |got - want| / max |want| of one gradient leaf."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def attention_calls(cfg) -> int:
    """Calls of the flash kernel in one forward pass of ``cfg``'s model:
    one an attention layer; an encoder-decoder's encoder layers and its
    decoder layers' cross-attention too."""
    calls = kernel_layers(cfg)
    if cfg.is_encoder_decoder:
        calls += cfg.num_encoder_layers + kernel_layers(cfg)
    return calls


def step_grads(model, lm, cfg, batch):
    """(loss, {name: gradient}) of one step of ``model.loss_fn`` on
    ``batch`` from ``lm``'s weights, the gradients cleared from ``lm``
    after."""
    lm.zero_grad(set_to_none=True)
    loss = model.loss_fn(lm, batch, cfg)
    loss.backward()
    grads = {n: p.grad for n, p in lm.named_parameters()}
    lm.zero_grad(set_to_none=True)
    return loss.detach(), grads


def train_step_vs_plain(torch, ops, ref, model, cfg, batch, other, *,
                        loss_tol=TRAIN_LOSS_TOL, grad_tol=TRAIN_GRAD_TOL,
                        device="cuda"):
    """The step's loss and gradients with the kernels against the same
    step with the plain attention swapped in (self- and cross-attention),
    from the same weights and batch; the control is the kernel step's
    gradients of ``other``.  The kernel step must launch the flash forward
    twice a call of ``attention_calls`` (the pass and its remat) and the
    backward once, every launch on the tensor-core instances, and call no
    plain attention.  On the CPU (a rehearsal, stand-in counters) the
    instances and the plain calls are not read."""
    from repro_torch.models import attention
    on_card = torch.device(device).type == "cuda"
    lm = model.init_params(cfg, seed=0, device=device, trainable=True)
    L = attention_calls(cfg)

    def loss_and_grads(b):
        return step_grads(model, lm, cfg, b)

    ops.reset_launches()
    with counted_plain(ref, attention) as calls:
        loss_k, grads_k = loss_and_grads(batch)
        synchronize(torch, device)
    ran = dict(ops.launches)
    check(not on_card or sum(calls.values()) == 0, "train step: a CUDA "
          f"tensor under grad reached the plain attention: {dict(calls)}")
    check(ran["flash_attention"] == 2 * L
          and ran["flash_attention_backward"] == L,
          f"train step: launches {ran}, expected {2 * L} flash forward "
          f"(pass + remat) and {L} backward")
    check(not on_card or (ops.flash_launches["wgmma"] == 2 * L
                          and ops.flash_backward_launches["wgmma"] == L),
          f"train step: forward launches by instance {ops.flash_launches}, "
          f"backward {ops.flash_backward_launches}, expected all on wgmma")
    kernel_attend = attention.self_attend, attention.cross_attend
    attention.self_attend = plain_self_attend
    attention.cross_attend = plain_cross_attend
    try:
        ops.reset_launches()
        loss_p, grads_p = loss_and_grads(batch)
        check(ops.launches["flash_attention"] == 0
              and ops.launches["flash_attention_backward"] == 0,
              f"train step with the plain attention launched {ops.launches}")
    finally:
        attention.self_attend, attention.cross_attend = kernel_attend
    _, grads_c = loss_and_grads(other)
    devs = {n: leaf_deviation(torch, g, grads_p[n])
            for n, g in grads_k.items()}
    ctl = {n: leaf_deviation(torch, g, grads_p[n])
           for n, g in grads_c.items()}
    loss_dev = abs(float(loss_k) - float(loss_p))
    worst = max(devs, key=devs.get)
    log(f"train step {cfg.name} B={batch['tokens'].shape[0]} "
        f"S={batch['tokens'].shape[1]}: loss kernel {float(loss_k):.6f}, "
        f"plain {float(loss_p):.6f}, |dev| {loss_dev:.4e} (limit "
        f"{loss_tol:g}); gradients, max over {len(devs)} parameters "
        f"of max|g_k - g_p| / max|g_p|: {devs[worst]:.4e} at {worst} "
        f"(limit {grad_tol:g}), median "
        f"{sorted(devs.values())[len(devs) // 2]:.4e}; control (another "
        f"batch's kernel gradients) max {max(ctl.values()):.4e}, min "
        f"{min(ctl.values()):.4e}")
    for n in sorted(devs, key=devs.get)[-6:]:
        log(f"train step leaf {n}: {devs[n]:.4e} (control {ctl[n]:.4e})")
    check(bool(torch.isfinite(loss_k)) and loss_dev <= loss_tol,
          f"train step: loss |dev| {loss_dev:.4e} > {loss_tol}")
    check(devs[worst] <= grad_tol, f"train step: {worst} gradient "
          f"{devs[worst]:.4e} > {grad_tol}")
    check(min(ctl.values()) > grad_tol, "train step: the control "
          f"{min(ctl.values()):.4e} is within the limit at "
          f"{min(ctl, key=ctl.get)}")
    out = dict(loss_kernel=float(loss_k), loss_plain=float(loss_p),
               loss_dev=loss_dev, loss_tol=loss_tol,
               grad_dev_max=devs[worst], grad_dev_leaf=worst,
               grad_tol=grad_tol, control_max=max(ctl.values()),
               control_min=min(ctl.values()),
               batch=int(batch["tokens"].shape[0]))
    del lm, grads_k, grads_p, grads_c
    if on_card:
        torch.cuda.empty_cache()
    return out


class HostMark:
    """A CUDA event's stand-in on the CPU (the rehearsals): the host
    clock at its making."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


@contextlib.contextmanager
def step_events(torch, train, device="cuda"):
    """CUDA events around the two halves of each step that
    ``train.make_train_step`` builds, recorded inside the block: at the
    call of ``model.loss_fn`` (the forward, then its backward), at the
    call of ``adamw_update`` and at its return.  Yields a list that gets
    one dict a step: the events, the loss and gnorm.  On the CPU (a
    rehearsal) host-clock marks stand in for the events."""
    steps = []
    loss_fn, update = train.model.loss_fn, train.adamw_update
    on_card = torch.device(device).type == "cuda"

    def mark():
        if not on_card:
            return HostMark()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def timed_loss(*a, **kw):
        start = mark()
        loss = loss_fn(*a, **kw)
        steps.append(dict(start=start, loss=loss))
        return loss

    def timed_update(*a, **kw):
        mid = mark()
        out = update(*a, **kw)
        steps[-1].update(mid=mid, end=mark(), gnorm=out[2])
        return out
    train.model.loss_fn, train.adamw_update = timed_loss, timed_update
    try:
        yield steps
    finally:
        train.model.loss_fn, train.adamw_update = loss_fn, update


def timed_loop(torch, ops, train, run, batch: int, seq: int, steps: int,
               device="cuda"):
    """``run()`` — ``steps`` train steps at batch x seq, returning their
    losses — with the counters set to 0 just before and read just after;
    each step timed by CUDA events from the call of ``loss_fn`` to the end
    of ``adamw_update`` (``step_events``), every loss and gnorm finite.
    Returns the launches (by kernel and by instance), the step times and
    the peak memory (0 on the CPU)."""
    on_card = torch.device(device).type == "cuda"
    synchronize(torch, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with step_events(torch, train, device) as events:
        losses = run()
    synchronize(torch, device)
    wall = time.perf_counter() - t0
    check(len(events) == steps and all("end" in e for e in events),
          f"train_loop: {len(events)} steps timed, expected {steps}")
    history = [dict(loss=float(e["loss"]), gnorm=float(e["gnorm"]),
                    ms=e["start"].elapsed_time(e["end"]),
                    fwd_bwd_ms=e["start"].elapsed_time(e["mid"]),
                    opt_ms=e["mid"].elapsed_time(e["end"])) for e in events]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for i, h in enumerate(history):
        log(f"train step {i}: loss {h['loss']:.6f} gnorm {h['gnorm']:.6f} "
            f"{h['ms']:.2f} ms (forward + backward {h['fwd_bwd_ms']:.2f}, "
            f"optimizer {h['opt_ms']:.2f})")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["gnorm"])
              for h in history), "train_loop: a non-finite loss or gnorm")

    def median(key):
        return float(sorted(h[key] for h in history)[len(history) // 2])
    med = median("ms")
    return dict(launches=dict(ops.launches),
                flash_instances=dict(ops.flash_launches),
                backward_instances=dict(ops.flash_backward_launches),
                ssd_instances=dict(ops.ssd_launches),
                ssd_backward_instances=dict(ops.ssd_backward_launches),
                median_step_ms=med,
                fwd_bwd_ms=median("fwd_bwd_ms"), opt_ms=median("opt_ms"),
                tokens_per_s=batch * seq / med * 1e3, peak_bytes=peak,
                wall_s=wall, steps=history, losses=losses)


def timed_train_loop(torch, ops, train, cfg, batch: int, seq: int,
                     steps: int = TRAIN_STEPS, device="cuda"):
    """``timed_loop`` of ``train_loop`` for ``steps`` steps at batch x seq
    on ``token_stream``."""
    def run():
        _, losses = train.train_loop(cfg, steps=steps, batch=batch, seq=seq,
                                     lr=3e-4, log_every=1, seed=0,
                                     device=device)
        return losses
    return timed_loop(torch, ops, train, run, batch, seq, steps, device)


def train_run(torch, ops, train, cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              steps=TRAIN_STEPS):
    """``timed_train_loop`` for ``steps`` steps at batch x seq: each step
    2 flash forward launches an attention layer (pass and remat) on the
    tensor-core instance and one backward, on the tensor-core instance
    too, nothing else launched.  Returns the launches and the times."""
    L = kernel_layers(cfg)
    run = timed_train_loop(torch, ops, train, cfg, batch, seq, steps)
    launches, instances = run["launches"], run["flash_instances"]
    backward_instances = run["backward_instances"]
    want = {name: 0 for name in ops.KERNELS}
    want.update(flash_attention=2 * L * steps,
                flash_attention_backward=L * steps)
    check(launches == want, f"train_loop launches {launches}, expected "
          f"{want}")
    check(instances == {"wgmma": 2 * L * steps, "fma": 0},
          f"train_loop: flash forward launches by instance {instances}, "
          "expected every one on the tensor-core instance")
    check(backward_instances == {"wgmma": L * steps, "fma": 0},
          f"train_loop: backward launches by instance {backward_instances}, "
          "expected every one on the tensor-core instance")
    losses = run.pop("losses")
    log(f"train {cfg.name} {cfg.num_layers} layers ({L} attention), "
        f"B={batch} S={seq}: "
        f"{steps} steps in {run['wall_s']:.2f} s, median step "
        f"{run['median_step_ms']:.2f} ms ({run['tokens_per_s']:.1f} "
        f"tokens/s; forward + backward {run['fwd_bwd_ms']:.2f} ms, "
        f"optimizer {run['opt_ms']:.2f} ms, CUDA events), peak memory "
        f"{run['peak_bytes'] / 1e9:.2f} GB (torch.cuda.max_memory_allocated);"
        f" launches {launches['flash_attention']} flash forward ({L} + {L} "
        f"remat a step), {launches['flash_attention_backward']} backward "
        f"{json.dumps(backward_instances)}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    return run


def checkpoint_resume(torch, configs, model, train, data, ckpt,
                      arch=CKPT_ARCH, *, stream=None, device="cuda",
                      path=None):
    """At ``arch``'s reduced config on the card: two steps, a checkpoint,
    step 3; then a fresh model and state restored from it take step 3
    again; the loss, gnorm, parameters and moments must equal bit for
    bit.  ``stream``: a function of the reduced config giving its batches
    (default ``token_stream`` at CKPT_BATCH x CKPT_SEQ)."""
    import shutil
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = configs.get_reduced(arch)
    lm = model.init_params(cfg, seed=0, device=device, trainable=True)
    state = adamw_init(lm)
    step = train.make_train_step(cfg, AdamWConfig(lr=1e-3), total_steps=10)
    if stream is None:
        stream = functools.partial(data.token_stream, batch=CKPT_BATCH,
                                   seq=CKPT_SEQ, seed=2, device=device)
    batches = stream(cfg)
    batches = [next(batches) for _ in range(3)]
    for b in batches[:2]:
        lm, state, _ = step(lm, state, b)
    path = Path(path) if path is not None else ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(path, ignore_errors=True)
    ckpt.save_train_state(path, lm, state, cfg, step=2)
    lm, state, m = step(lm, state, batches[2])
    lm2, state2, at = ckpt.restore_train_state(path, cfg, device=device)
    lm2, state2, m2 = step(lm2, state2, batches[2])
    shutil.rmtree(path, ignore_errors=True)
    own = dict(lm2.named_parameters())
    same = (at == 2 and torch.equal(m["loss"], m2["loss"])
            and torch.equal(m["gnorm"], m2["gnorm"])
            and all(torch.equal(p, own[n]) for n, p in lm.named_parameters())
            and all(torch.equal(t, state2[key][n]) for key in ("m", "v")
                    for n, t in state[key].items())
            and torch.equal(state["step"], state2["step"]))
    B, S = batches[2]["tokens"].shape
    log(f"checkpoint {cfg.name} ({cfg.param_dtype}, B={B} S={S}"
        f"{''.join(f', {k} {tuple(v.shape)}' for k, v in batches[2].items() if k.endswith('media'))}"
        f"): step 3 after restoring step 2's checkpoint "
        f"{'equals' if same else 'differs from'} the continued run's bit "
        f"for bit (loss {float(m['loss']):.6f}, gnorm "
        f"{float(m['gnorm']):.6f})")
    check(same, "checkpoint resume: step 3 differs from the continued run")
    return dict(loss=float(m["loss"]), gnorm=float(m["gnorm"]))


def training_phase(torch, ops, ref, devs: dict):
    """Phase 15: the backward kernel's checks and times, the kernel step
    against the plain one and ``train_loop`` at qwen3-14b's full width (4
    layers), and the checkpoint resume.  Returns the phase's numbers."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs
    from repro_torch.data import synthetic as data
    from repro_torch.launch import train
    from repro_torch.models import model
    t0 = time.perf_counter()
    readings = backward_checks(torch, ops, ref, "cuda", devs)
    timing = backward_timings(torch, ops, ref, "cuda")
    full = configs.get(TRAIN_ARCH)
    cfg = configs.get(TRAIN_ARCH, num_layers=TRAIN_LAYERS)
    log(f"train {cfg.name}: the one cut is depth, {full.num_layers} -> "
        f"{cfg.num_layers} layers; d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads over {cfg.num_kv_heads}, D {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.padded_vocab} (padded), {cfg.param_dtype}")
    stream = data.token_stream(cfg, PLAIN_STEP_BATCH, TRAIN_SEQ, seed=1,
                               device="cuda")
    step_check = train_step_vs_plain(torch, ops, ref, model, cfg,
                                     next(stream), next(stream))
    run = train_run(torch, ops, train, cfg)
    resume = checkpoint_resume(torch, configs, model, train, data, ckpt)
    seconds = time.perf_counter() - t0
    log(f"phase 15: {seconds:.1f} s")
    return dict(readings=readings, timing=timing, step_check=step_check,
                run=run, resume=resume, seconds=seconds)


# --------------------------------------------------------------------------
# phase 17: the ssd_scan backward kernel and mamba2 training
# --------------------------------------------------------------------------

def ssd_backward_inputs(torch, case, dtype, device, seed, dfinal: bool):
    """``ssd_inputs`` of the case, then dy (b, s, h, p) in the inputs'
    dtype (standard normal) and dfinal (b, h, p, n) fp32 (standard normal)
    or None."""
    b, s, h, p, n = case[:5]
    args = ssd_inputs(torch, case, dtype, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1000)
    f32 = dict(generator=gen, device=device, dtype=torch.float32)
    dy = torch.randn((b, s, h, p), **f32).to(args[0].dtype)
    final = torch.randn((b, h, p, n), **f32) if dfinal else None
    return (*args, dy, final)


def ssd_backward_deviation(torch, name, got, want, dtype):
    """(max |dev|, max |dev| / max |want|, the share of the limit used) of
    one gradient: fp32 outputs (all in fp32; ddt, dA, dD in bf16) against
    SSD_BACKWARD_TOL[name] max |want|, bf16 dx, dB, dC against one bf16
    ulp of each plain entry plus that floor."""
    dev = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    worst = float(dev.max())
    floor = SSD_BACKWARD_TOL[name] * scale
    if dtype == "float32" or got.dtype == torch.float32:
        share = worst / floor if floor > 0 else (0.0 if worst == 0 else
                                                 math.inf)
    else:
        share = float((dev / (BF16_ULP * want.float().abs() + floor)).max())
    return worst, worst / max(scale, 1e-30), share


def ssd_backward_checks(torch, ops, ref, device, devs: dict,
                        cases=SSD_BACKWARD_CASES):
    """At every case, fp32 and bf16, with dfinal None and drawn:
    ``ssd_scan_backward`` against ``ref.ssd_scan_backward`` on the same
    inputs (mamba2-370m's x, B, C as strided slices of one conv output):
    two launches, equal bit for bit; each of the six gradients in its
    dtype and shape, finite, within its limit; the control (the kernel's
    gradients against plain's for dy one row later) above each fp32
    limit.  Returns the readings."""
    cuda = torch.device(device).type == "cuda"
    readings = []
    for i, case in enumerate(cases):
        b, s, h, p, n, chunk = case
        for dtype in ("float32", "bfloat16"):
            for with_final in (False, True):
                args = ssd_backward_inputs(torch, case, dtype, device,
                                           seed=300 + i, dfinal=with_final)
                what = (f"ssd_scan_backward b={b} s={s} h={h} p={p} n={n} "
                        f"chunk={chunk} {dtype} dfinal "
                        f"{'drawn' if with_final else 'None'}")
                before = ops.launches["ssd_scan_backward"]
                got = ops.ssd_scan_backward(*args, chunk=chunk)
                again = ops.ssd_scan_backward(*args, chunk=chunk)
                if cuda:
                    check(ops.launches["ssd_scan_backward"] - before == 2,
                          f"{what}: did not launch the kernel twice")
                    check(all(torch.equal(a, c) for a, c in zip(got, again)),
                          f"{what}: two launches on the same inputs differ")
                del again
                want = ref.ssd_scan_backward(*args, chunk=chunk)
                x, dy = args[0], args[6]
                shifted = ref.ssd_scan_backward(
                    *args[:6], dy.roll(1, dims=1), args[7], chunk=chunk)
                shapes = ((b, s, h, p), (b, s, h), (h,), (b, s, n),
                          (b, s, n), (h,))
                dtypes = (x.dtype, torch.float32, torch.float32, x.dtype,
                          x.dtype, torch.float32)
                reading, control = {}, {}
                for name, g, w, c, shape, dt in zip(
                        SSD_GRADS, got, want, shifted, shapes, dtypes):
                    check(tuple(g.shape) == shape and g.dtype == dt,
                          f"{what}: {name} {tuple(g.shape)} {g.dtype}, "
                          f"expected {shape} {dt}")
                    check(bool(torch.isfinite(g).all()),
                          f"{what}: non-finite {name}")
                    reading[name] = ssd_backward_deviation(torch, name, g, w,
                                                           dtype)
                    control[name] = float((g.float() - c.float()).abs().max(
                    )) / max(float(c.float().abs().max()), 1e-30)
                log(f"check {what}: " + ", ".join(
                    f"{n} {r:.2e} of max ({sh:.3f} of the limit)"
                    for n, (_, r, sh) in reading.items())
                    + "; control (dy one row later) " + ", ".join(
                        f"{n} {c:.2e}" for n, c in control.items()))
                for name, (_, _, share) in reading.items():
                    check(share <= 1.0, f"{what}: {name} at {share:.3f}x "
                          "its limit")
                    check(control[name] > SSD_BACKWARD_TOL[name],
                          f"{what}: the control of {name} "
                          f"{control[name]:.3e} is within its limit")
                record(devs, "ssd_scan_backward", dtype,
                       max(d for d, _, _ in reading.values()))
                readings.append(dict(
                    case=list(case), dtype=dtype, dfinal=with_final,
                    control=control,
                    **{n: dict(max_abs_dev=d, rel=r, share=sh)
                       for n, (d, r, sh) in reading.items()}))
                del got, want, shifted, args
                if cuda:
                    torch.cuda.empty_cache()
    return readings


def ssd_backward_work(b, s, h, p, n, chunk, itemsize, dfinal=True):
    """(flops, bytes) of one ``ssd_scan_backward`` call
    (``kernels.cost.ssd_backward_work``, which states the count)."""
    from repro_torch.kernels import cost
    return cost.ssd_backward_work(b, s, h, p, n, chunk, itemsize, dfinal)


def ssd_backward_bound(b, s, h, p, n, chunk, itemsize, dfinal=True):
    """The least time of one ``ssd_scan_backward`` call (``bound``): the
    flops of ``ssd_backward_work`` at the peak of the input type (bf16:
    the tensor cores), or its bytes at the memory rate."""
    flops, nbytes = ssd_backward_work(b, s, h, p, n, chunk, itemsize,
                                      dfinal)
    return bound(flops, nbytes, PEAK_BF16 if itemsize == 2 else PEAK_FP32)


def ssd_backward_timings(torch, ops, ref, device):
    """The kernel beside ``ref.ssd_scan_backward`` (in turns: kernel,
    plain, plain, kernel; CUDA events) and its bound, at mamba2-370m's
    training shape (the first row; its device time split by kernel with
    ``kernel_split``) and at one 2048-token sequence, bf16 inputs as the
    model gives them, dfinal None (as in training).  No single torch call
    computes the scan's gradient: no library time."""
    rows = []
    for case in (SSD_TRAIN_CASE, (1, 2048, 32, 64, 128, 64)):
        args = ssd_backward_inputs(torch, case, "bfloat16", device,
                                   seed=case[0], dfinal=False)
        chunk = case[5]
        kernel = lambda: ops.ssd_scan_backward(*args, chunk=chunk)
        plain = lambda: ref.ssd_scan_backward(*args, chunk=chunk)
        times = paired_ms(torch, kernel, plain, 5, 2)
        bms, by = ssd_backward_bound(*case, 2, dfinal=False)
        flops, nbytes = ssd_backward_work(*case, 2, dfinal=False)
        row = dict(times, bound_ms=bms, bound_by=by, library_ms=None,
                   flops=flops, bytes=nbytes,
                   tflops=flops / times["ms"] / 1e9,
                   shape=f"x (b={case[0]}, s={case[1]}, h=32, p=64), B/C "
                         f"(n=128) bf16 strided, chunk 64")
        if case == SSD_TRAIN_CASE:
            row["split"] = kernel_split(torch, kernel)
        rows.append(row)
        log(f"time ssd_scan_backward [{row['shape']}]: {row['ms']:.4f} ms "
            f"(samples {row['ms_samples'][0]:.4f}, "
            f"{row['ms_samples'][1]:.4f}; {row['tflops']:.2f} TFLOP/s of "
            f"the function's {flops / 1e9:.2f} GFLOP, {bms / row['ms']:.4f} "
            f"of the bound), plain {row['plain_ms']:.4f} ms (samples "
            f"{row['plain_ms_samples'][0]:.4f}, "
            f"{row['plain_ms_samples'][1]:.4f}), bound {bms:.4f} ms ({by}; "
            f"{nbytes / 1e9:.4f} GB), library: none"
            + ("; by kernel " + json.dumps(
                {k: round(v, 4) for k, v in row["split"].items()})
               if "split" in row else ""))
        del args
        torch.cuda.empty_cache()
    return dict(rows[0], variants=rows[1:])


def counted_plain_scan(ref, ssm):
    """Counts the calls of the plain scans and the plain backward
    (``ref.ssd_scan``, ``ref.ssd_scan_backward``, ``ssm.ssd_chunked``)
    inside the block."""
    return counted_calls([(ref, "ssd_scan"), (ref, "ssd_scan_backward"),
                          (ssm, "ssd_chunked")])


def autograd_ssd(x, dt, A, B, C, D, cfg):
    """The plain scan under torch autograd on any device: the port's
    ``ssd_chunked`` at the JAX package's chunk (the plain step's
    yardstick only)."""
    from repro_torch.models import ssm
    return ssm.ssd_chunked(x, dt, A, B, C,
                           ssm.jax_chunk(cfg.ssm_chunk, x.shape[1]), D=D)


def mamba_step_vs_plain(torch, ops, ref, model, cfg, batch, other):
    """mamba2's training step with the kernels against the same step with
    the plain scan under torch autograd swapped in (``autograd_ssd``),
    from the same weights and batch, within ``MAMBA_STEP_TOL`` of the
    config's dtype; the control is the kernel step's gradients of
    ``other``.  The kernel step must launch ``ssd_scan`` twice a layer (the
    pass and its remat) and ``ssd_scan_backward`` once, bf16 on their
    tensor-core instances and fp32 on the fp32-FMA ones, and call no plain
    scan."""
    from repro_torch.models import ssm
    lm = model.init_params(cfg, seed=0, device="cuda", trainable=True)
    L = cfg.num_layers
    tol = MAMBA_STEP_TOL[cfg.param_dtype]
    instance = "wgmma" if cfg.param_dtype == "bfloat16" else "fma"

    def loss_and_grads(b):
        lm.zero_grad(set_to_none=True)
        loss = model.loss_fn(lm, b, cfg)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in lm.named_parameters()}
        lm.zero_grad(set_to_none=True)
        return loss.detach(), grads

    ops.reset_launches()
    with counted_plain_scan(ref, ssm) as calls:
        loss_k, grads_k = loss_and_grads(batch)
        torch.cuda.synchronize()
    ran = dict(ops.launches)
    want = {name: 0 for name in ops.KERNELS}
    want.update(ssd_scan=2 * L, ssd_scan_backward=L)
    check(sum(calls.values()) == 0, f"mamba train step: a CUDA tensor "
          f"under grad reached a plain scan: {dict(calls)}")
    check(ran == want, f"mamba train step: launches {ran}, expected {want}")
    check(ops.ssd_launches == {k: 2 * L * (k == instance)
                               for k in ops.SSD_INSTANCES},
          f"mamba train step: ssd_scan by instance {ops.ssd_launches}")
    check(ops.ssd_backward_launches == {
        k: L * (k == instance) for k in ops.SSD_BACKWARD_INSTANCES},
        f"mamba train step: ssd_scan_backward by instance "
        f"{ops.ssd_backward_launches}")
    kernel_ssd = ssm.ssd
    ssm.ssd = autograd_ssd
    try:
        ops.reset_launches()
        loss_p, grads_p = loss_and_grads(batch)
        check(ops.launches == {name: 0 for name in ops.KERNELS},
              f"train step with the plain scan launched {ops.launches}")
    finally:
        ssm.ssd = kernel_ssd
    _, grads_c = loss_and_grads(other)
    devs = {n: leaf_deviation(torch, g, grads_p[n])
            for n, g in grads_k.items() if float(grads_p[n].abs().max()) > 0}
    ctl = {n: leaf_deviation(torch, grads_c[n], grads_p[n]) for n in devs}
    loss_dev = abs(float(loss_k) - float(loss_p))
    worst = max(devs, key=devs.get)
    log(f"train step {cfg.name} {L} layers {cfg.param_dtype} "
        f"B={batch['tokens'].shape[0]} S={batch['tokens'].shape[1]}: loss "
        f"kernel {float(loss_k):.6f}, plain scan {float(loss_p):.6f}, |dev| "
        f"{loss_dev:.4e} (limit {tol['loss']:g}); gradients, max over "
        f"{len(devs)} parameters (of {len(grads_k)}; the rest have no "
        f"gradient on either side) of max|g_k - g_p| / max|g_p|: "
        f"{devs[worst]:.4e} at {worst} (limit {tol['grad']:g}), median "
        f"{sorted(devs.values())[len(devs) // 2]:.4e}; control (another "
        f"batch's kernel gradients) max {max(ctl.values()):.4e}, min "
        f"{min(ctl.values()):.4e}")
    for n in sorted(devs, key=devs.get)[-6:]:
        log(f"train step leaf {n}: {devs[n]:.4e} (control {ctl[n]:.4e})")
    for n in sorted(n for n in devs if n.endswith(("A_log", ".D",
                                                   "dt_bias")))[:6]:
        log(f"train step leaf {n}: {devs[n]:.4e} (control {ctl[n]:.4e})")
    what = f"mamba train step ({cfg.param_dtype}, {L} layers)"
    check(bool(torch.isfinite(loss_k)) and loss_dev <= tol["loss"],
          f"{what}: loss |dev| {loss_dev:.4e} > {tol['loss']}")
    check(devs[worst] <= tol["grad"], f"{what}: {worst} gradient "
          f"{devs[worst]:.4e} > {tol['grad']}")
    check(min(ctl.values()) > tol["grad"], f"{what}: the control "
          f"{min(ctl.values()):.4e} is within the limit at "
          f"{min(ctl, key=ctl.get)}")
    ssm_leaves = {n: devs[n] for n in devs
                  if n.endswith(("A_log", ".D", "dt_bias"))}
    out = dict(dtype=cfg.param_dtype, layers=L, loss_kernel=float(loss_k),
               loss_plain=float(loss_p), loss_dev=loss_dev,
               loss_tol=tol["loss"], grad_dev_max=devs[worst],
               grad_dev_leaf=worst,
               grad_dev_median=sorted(devs.values())[len(devs) // 2],
               grad_dev_ssm_leaves_max=max(ssm_leaves.values()),
               grad_tol=tol["grad"], control_max=max(ctl.values()),
               control_min=min(ctl.values()),
               batch=int(batch["tokens"].shape[0]))
    del lm, grads_k, grads_p, grads_c
    torch.cuda.empty_cache()
    return out


def mamba_train_run(torch, ops, train, cfg):
    """``timed_train_loop`` for TRAIN_STEPS steps at MAMBA_TRAIN_BATCH x
    MAMBA_TRAIN_SEQ: each step 2 ``ssd_scan`` launches a layer (pass and
    remat) and one ``ssd_scan_backward``, every one on its tensor-core
    instance, nothing else launched.  Returns the launches and
    the times."""
    L = cfg.num_layers
    run = timed_train_loop(torch, ops, train, cfg, MAMBA_TRAIN_BATCH,
                           MAMBA_TRAIN_SEQ)
    launches = run["launches"]
    want = {name: 0 for name in ops.KERNELS}
    want.update(ssd_scan=2 * L * TRAIN_STEPS,
                ssd_scan_backward=L * TRAIN_STEPS)
    check(launches == want, f"train_loop launches {launches}, expected "
          f"{want}")
    check(run["ssd_instances"] == {"wgmma": 2 * L * TRAIN_STEPS, "fma": 0},
          f"train_loop: ssd_scan launches by instance "
          f"{run['ssd_instances']}, expected every one on the tensor-core "
          "instance")
    check(run["ssd_backward_instances"] == {"wgmma": L * TRAIN_STEPS,
                                            "fma": 0},
          f"train_loop: ssd_scan_backward launches by instance "
          f"{run['ssd_backward_instances']}, expected every one on the "
          "tensor-core instance")
    losses = run.pop("losses")
    log(f"train {cfg.name} {L} layers, B={MAMBA_TRAIN_BATCH} "
        f"S={MAMBA_TRAIN_SEQ}: {TRAIN_STEPS} steps in {run['wall_s']:.2f} s,"
        f" median step {run['median_step_ms']:.2f} ms "
        f"({run['tokens_per_s']:.1f} tokens/s; forward + backward "
        f"{run['fwd_bwd_ms']:.2f} ms, optimizer {run['opt_ms']:.2f} ms, CUDA "
        f"events), peak memory {run['peak_bytes'] / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated); launches "
        f"{launches['ssd_scan']} ssd_scan ({L} + {L} remat a step, "
        f"{json.dumps(run['ssd_instances'])}), "
        f"{launches['ssd_scan_backward']} ssd_scan_backward "
        f"({json.dumps(run['ssd_backward_instances'])}); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return run


# --------------------------------------------------------------------------
# phase 18: the backward's two instances, mamba2's fp32 step at full depth,
# and its training step split by kernel
# --------------------------------------------------------------------------

@contextlib.contextmanager
def forced_backward_instance(ops, instance):
    """Inside the block every ``ssd_scan_backward`` call, the model's
    included, runs ``instance``: ``ops.ssd_backward_instance`` answers it."""
    chooser = ops.ssd_backward_instance
    ops.ssd_backward_instance = lambda *a, **k: instance
    try:
        yield
    finally:
        ops.ssd_backward_instance = chooser


def mamba_depth_check(torch, ops, ref, model, cfg, batch, other):
    """An fp32 copy of ``cfg`` at all its layers: ``mamba_step_vs_plain``
    under MAMBA_STEP_TOL["float32"].  If it fails, the same at
    MAMBA_DEPTH_BISECT layers is logged before the failure is raised, so
    the run shows where the deviation grows."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    try:
        return mamba_step_vs_plain(torch, ops, ref, model, cfg32, batch,
                                   other)
    except SmokeFailure:
        for layers in MAMBA_DEPTH_BISECT:
            try:
                mamba_step_vs_plain(torch, ops, ref, model, dataclasses.replace(
                    cfg32, num_layers=layers), batch, other)
            except SmokeFailure as err:
                log(f"mamba depth bisection, {layers} layers: {err}")
        raise


def backward_kernels_ms(split) -> float:
    """Device ms of ``ssd_scan_backward``'s kernels in a ``kernel_split``."""
    return sum(ms for name, ms in split.items() if "bwd_" in name)


def mamba_step_split(torch, ops, model, data, cfg, instance):
    """One forward + backward of ``cfg`` at MAMBA_TRAIN_BATCH x
    MAMBA_TRAIN_SEQ (a ``train_loop`` step without the optimizer) split by
    kernel (``kernel_split``, device ms a step), with every
    ``ssd_scan_backward`` on ``instance``; logs the 12 largest items and
    the backward kernel's share.  Returns the split and its sums."""
    batch, seq = MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ
    lm = model.init_params(cfg, seed=0, device="cuda", trainable=True)
    tokens = next(data.token_stream(cfg, batch, seq, seed=0, device="cuda"))

    def step():
        lm.zero_grad(set_to_none=True)
        model.loss_fn(lm, tokens, cfg).backward()
    ops.reset_launches()
    with forced_backward_instance(ops, instance):
        split = kernel_split(torch, step, reps=2)
    launched = ops.ssd_backward_launches[instance]
    check(launched == 3 * cfg.num_layers, f"mamba step split [{instance}]: "
          f"{launched} ssd_scan_backward launches on it, expected "
          f"{3 * cfg.num_layers} (a warm-up and two profiled steps)")
    total = sum(split.values())
    back = backward_kernels_ms(split)
    items = sorted(split.items(), key=lambda kv: -kv[1])
    log(f"split {cfg.name} {cfg.num_layers} layers B={batch} S={seq} "
        f"forward + backward, ssd_scan_backward on [{instance}] "
        f"(torch.profiler, device ms a step): total {total:.2f}, "
        f"ssd_scan_backward {back:.2f} ({back / total:.4f} of it); largest: "
        + "; ".join(f"{name} {ms:.2f}" for name, ms in items[:12]))
    del lm
    torch.cuda.empty_cache()
    return dict(instance=instance, total_ms=total, backward_ms=back,
                backward_share=back / total,
                largest={name: ms for name, ms in items[:12]},
                split=split)


def ssd_backward_instance_checks(torch, ops, ref, device, devs: dict,
                                 cases=SSD_BACKWARD_CASES):
    """At every case the tensor-core instance takes (bf16, chunk 64, p and
    n multiples of 16), dfinal drawn: both instances of
    ``ssd_scan_backward`` forced by name on the same inputs against
    ``ref.ssd_scan_backward``, each gradient within phase 17's limit, the
    control (dy one row later) above each fp32 limit, two launches equal
    bit for bit and counted on their instance; on the card then the two
    timed in turns (wgmma, fma, fma, wgmma; CUDA events) beside the bound
    (``ssd_backward_bound``), each split by kernel (``kernel_split``), the
    tensor-core one no slower at the training shape.  On CPU tensors (a
    rehearsal) both names run the wrapper's plain version and nothing is
    timed.  Returns a row a case."""
    cuda = torch.device(device).type == "cuda"
    rows = []
    for i, case in enumerate(cases):
        b, s, h, p, n, chunk = case
        if ops.ssd_backward_instance(torch.bfloat16, p, n, chunk) != "wgmma":
            continue
        args = ssd_backward_inputs(torch, case, "bfloat16", device,
                                   seed=500 + i, dfinal=True)
        want = ref.ssd_scan_backward(*args, chunk=chunk)
        shifted = ref.ssd_scan_backward(*args[:6], args[6].roll(1, dims=1),
                                        args[7], chunk=chunk)
        runs = {inst: (lambda inst=inst: ops._ssd_backward_launch(
                    *args, chunk, inst) if cuda
                    else ops.ssd_scan_backward(*args, chunk=chunk))
                for inst in ops.SSD_BACKWARD_INSTANCES}
        row = dict(case=list(case), shape=f"x (b={b}, s={s}, h={h}, p={p}), "
                   f"B/C (n={n}) bf16 strided, chunk {chunk}, dfinal drawn")
        for inst, run in runs.items():
            what = f"ssd_scan_backward {row['shape']} [{inst}, forced]"
            before = dict(ops.ssd_backward_launches)
            got, again = run(), run()
            if cuda:
                ran = {k: v - before[k]
                       for k, v in ops.ssd_backward_launches.items()}
                check(ran == {k: 2 * (k == inst)
                              for k in ops.SSD_BACKWARD_INSTANCES},
                      f"{what}: launched {ran}, expected two on {inst}")
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"{what}: two launches on the same inputs differ")
            reading = {name: ssd_backward_deviation(torch, name, g, w,
                                                    "bfloat16")
                       for name, g, w in zip(SSD_GRADS, got, want)}
            control = {name: float((g.float() - c.float()).abs().max())
                       / max(float(c.float().abs().max()), 1e-30)
                       for name, g, c in zip(SSD_GRADS, got, shifted)}
            log(f"check {what}: " + ", ".join(
                f"{nm} {r:.2e} of max ({sh:.3f} of the limit)"
                for nm, (_, r, sh) in reading.items())
                + "; control " + ", ".join(
                    f"{nm} {c:.2e}" for nm, c in control.items()))
            for name, (_, _, share) in reading.items():
                check(bool(torch.isfinite(got[SSD_GRADS.index(name)]
                                          .float()).all()),
                      f"{what}: non-finite {name}")
                check(share <= 1.0, f"{what}: {name} at {share:.3f}x its "
                      "limit")
                check(control[name] > SSD_BACKWARD_TOL[name],
                      f"{what}: the control of {name} {control[name]:.3e} "
                      "is within its limit")
            record(devs, "ssd_scan_backward", "bfloat16",
                   max(d for d, _, _ in reading.values()))
            row[inst] = dict(control=control, **{
                nm: dict(max_abs_dev=d, rel=r, share=sh)
                for nm, (d, r, sh) in reading.items()})
            del got, again
        if cuda:
            big = b * s >= 8192
            reps = {"wgmma": 5 if big else 20, "fma": 2 if big else 10}
            w1 = cuda_ms(torch, runs["wgmma"], reps["wgmma"])
            f1 = cuda_ms(torch, runs["fma"], reps["fma"])
            f2 = cuda_ms(torch, runs["fma"], reps["fma"])
            w2 = cuda_ms(torch, runs["wgmma"], reps["wgmma"])
            bms, by = ssd_backward_bound(*case, 2)
            flops, _ = ssd_backward_work(*case, 2)
            for inst, (t1, t2) in (("wgmma", (w1, w2)), ("fma", (f1, f2))):
                ms = (t1 + t2) / 2
                row[inst].update(ms=ms, ms_samples=[t1, t2],
                                 tflops=flops / ms / 1e9,
                                 kernels_ms=kernel_split(torch, runs[inst]))
            row.update(bound_ms=bms, bound_by=by,
                       ratio=row["wgmma"]["ms"] / row["fma"]["ms"])
            log(f"time ssd_scan_backward instances [{row['shape']}]: wgmma "
                f"{row['wgmma']['ms']:.4f} ms (samples {w1:.4f}, {w2:.4f}; "
                f"{row['wgmma']['tflops']:.2f} TFLOP/s, "
                f"{bms / row['wgmma']['ms']:.4f} of the bound), fma "
                f"{row['fma']['ms']:.4f} ms (samples {f1:.4f}, {f2:.4f}), "
                f"bound {bms:.4f} ms ({by}); wgmma / fma {row['ratio']:.4f}; "
                "device ms a call by kernel (torch.profiler): " + "; ".join(
                    f"{inst} " + ", ".join(
                        f"{k} {v:.4f}" for k, v in
                        row[inst]["kernels_ms"].items())
                    for inst in runs))
            if case == SSD_TRAIN_CASE:
                check(row["wgmma"]["ms"] <= row["fma"]["ms"],
                      f"ssd_scan_backward {row['shape']}: the tensor-core "
                      f"instance ({row['wgmma']['ms']:.4f} ms) is slower "
                      f"than the fp32-FMA one ({row['fma']['ms']:.4f} ms)")
        rows.append(row)
        del args, want, shifted, runs
        if cuda:
            torch.cuda.empty_cache()
    return rows


def ssd_backward_phase(torch, ops, ref, devs: dict):
    """Phase 18: mamba2-370m's fp32 step at all 48 layers against the
    plain-scan step (``mamba_depth_check``); both instances of
    ``ssd_scan_backward`` forced on the same inputs, checked and timed
    (``ssd_backward_instance_checks``); one forward + backward of
    mamba2-370m (bf16, 48 layers, B = 8 x 2048) split by kernel with each
    instance forced (``mamba_step_split``).  Returns the phase's numbers."""
    from repro_torch import configs
    from repro_torch.data import synthetic as data
    from repro_torch.models import model
    t0 = time.perf_counter()
    cfg = configs.get(MAMBA_TRAIN_ARCH)
    stream = data.token_stream(cfg, MAMBA_STEP_BATCH, MAMBA_TRAIN_SEQ,
                               seed=1, device="cuda")
    batch, other = next(stream), next(stream)
    depth = mamba_depth_check(torch, ops, ref, model, cfg, batch, other)
    del batch, other, stream
    torch.cuda.empty_cache()
    instances = ssd_backward_instance_checks(torch, ops, ref, "cuda", devs)
    splits = {inst: mamba_step_split(torch, ops, model, data, cfg, inst)
              for inst in ("fma", "wgmma")}
    saved = splits["fma"]["backward_ms"] - splits["wgmma"]["backward_ms"]
    log(f"split {cfg.name}: ssd_scan_backward {splits['fma']['backward_ms']:.2f}"
        f" ms a step on fma, {splits['wgmma']['backward_ms']:.2f} on wgmma "
        f"({saved:.2f} ms less); forward + backward on the device "
        f"{splits['fma']['total_ms']:.2f} -> {splits['wgmma']['total_ms']:.2f}"
        " ms")
    seconds = time.perf_counter() - t0
    log(f"phase 18: {seconds:.1f} s")
    return dict(depth=depth, instances=instances, splits=splits,
                seconds=seconds)


def mamba_training_phase(torch, ops, ref, devs: dict):
    """Phase 17: ``ssd_scan_backward``'s checks and times, then mamba2-370m
    as configured: the kernel step against the plain-scan step (B = 2 x S
    = 2048; again in an fp32 copy cut to MAMBA_FP32_LAYERS layers),
    ``train_loop`` (B = 8 x S = 2048), and the checkpoint resume at the
    reduced config.  Returns the phase's numbers."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs
    from repro_torch.data import synthetic as data
    from repro_torch.launch import train
    from repro_torch.models import model
    t0 = time.perf_counter()
    readings = ssd_backward_checks(torch, ops, ref, "cuda", devs)
    timing = ssd_backward_timings(torch, ops, ref, "cuda")
    cfg = configs.get(MAMBA_TRAIN_ARCH)
    log(f"train {cfg.name}: as configured, no cut; {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.ssm_nheads} heads x {cfg.ssm_headdim},"
        f" state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab "
        f"{cfg.padded_vocab} (padded), {cfg.param_dtype}")
    stream = data.token_stream(cfg, MAMBA_STEP_BATCH, MAMBA_TRAIN_SEQ,
                               seed=1, device="cuda")
    batch, other = next(stream), next(stream)
    step_check = {"bfloat16": mamba_step_vs_plain(
        torch, ops, ref, model, cfg, batch, other)}
    cfg32 = dataclasses.replace(cfg, num_layers=MAMBA_FP32_LAYERS,
                                param_dtype="float32")
    step_check["float32"] = mamba_step_vs_plain(torch, ops, ref, model,
                                                cfg32, batch, other)
    run = mamba_train_run(torch, ops, train, cfg)
    resume = checkpoint_resume(torch, configs, model, train, data, ckpt,
                               arch=MAMBA_TRAIN_ARCH)
    seconds = time.perf_counter() - t0
    log(f"phase 17: {seconds:.1f} s")
    return dict(readings=readings, timing=timing, step_check=step_check,
                run=run, resume=resume, seconds=seconds)


# --------------------------------------------------------------------------
# phase 19: the remat policies and the sharded train step
# --------------------------------------------------------------------------

def remat_policies(torch, ops, model, train, cfg, batch):
    """Phase 19 (a): one step's loss and gradients under each policy of
    REMAT_POLICIES from the same weights and batch, "dots" and "names"
    against "full" (each leaf by ``leaf_deviation``), every flash launch
    on "wgmma" (2 forward a layer, pass and remat, and 1 backward); then
    REMAT_STEPS timed steps of each (CUDA events around each step after
    one warm-up) and its peak memory."""
    from repro_torch.optim import AdamWConfig, adamw_init
    L = cfg.num_layers
    lm = model.init_params(cfg, seed=0, device="cuda", trainable=True)
    got, out = {}, dict(policies={})
    for policy in REMAT_POLICIES:
        pcfg = dataclasses.replace(cfg, remat_policy=policy)
        lm.zero_grad(set_to_none=True)
        ops.reset_launches()
        loss = model.loss_fn(lm, batch, pcfg)
        loss.backward()
        torch.cuda.synchronize()
        check(ops.flash_launches == {"wgmma": 2 * L, "fma": 0}
              and ops.flash_backward_launches == {"wgmma": L, "fma": 0},
              f"remat {policy}: flash launches {ops.flash_launches}, "
              f"backward {ops.flash_backward_launches}, expected {2 * L} "
              f"and {L} on wgmma")
        got[policy] = (loss.detach(), {n: p.grad
                                       for n, p in lm.named_parameters()})
        out["policies"][policy] = dict(
            loss=float(loss.detach()), flash=dict(ops.flash_launches),
            flash_backward=dict(ops.flash_backward_launches))
        lm.zero_grad(set_to_none=True)
    loss_f, grads_f = got.pop("full")
    for policy, (loss, grads) in got.items():
        devs = {n: leaf_deviation(torch, g, grads_f[n])
                for n, g in grads.items()}
        worst = max(devs, key=devs.get)
        loss_dev = abs(float(loss) - float(loss_f))
        log(f"remat {policy} {cfg.name} {L} layers B={TRAIN_BATCH} "
            f"S={TRAIN_SEQ}: loss {float(loss):.6f} against full's "
            f"{float(loss_f):.6f} (|dev| {loss_dev:.4e}); gradients, max "
            f"over {len(devs)} parameters of max|g - g_full| / "
            f"max|g_full|: {devs[worst]:.4e} at {worst} (limit "
            f"{REMAT_TOL:g})")
        check(loss_dev <= REMAT_TOL and devs[worst] <= REMAT_TOL,
              f"remat {policy}: loss |dev| {loss_dev:.4e}, gradient "
              f"{devs[worst]:.4e} at {worst}, limit {REMAT_TOL:g}")
        out["policies"][policy].update(loss_dev=loss_dev,
                                       grad_dev_max=devs[worst],
                                       grad_dev_leaf=worst)
    del got, grads_f, grads
    torch.cuda.empty_cache()
    state = adamw_init(lm)
    for policy in REMAT_POLICIES:
        pcfg = dataclasses.replace(cfg, remat_policy=policy)
        step = train.make_train_step(pcfg, AdamWConfig(), total_steps=10)
        lm, state, _ = step(lm, state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(REMAT_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lm, state, m = step(lm, state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            check(math.isfinite(float(m["loss"])), f"remat {policy}: a "
                  "non-finite loss")
        med = float(sorted(times)[len(times) // 2])
        peak = torch.cuda.max_memory_allocated()
        out["policies"][policy].update(step_ms=times, median_step_ms=med,
                                       peak_bytes=peak)
        log(f"remat {policy} {cfg.name} {L} layers B={TRAIN_BATCH} "
            f"S={TRAIN_SEQ}: step {', '.join(f'{t:.2f}' for t in times)} "
            f"ms (median {med:.2f}, {TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f}"
            f" tokens/s), peak memory {peak / 1e9:.2f} GB")
    del lm, state
    torch.cuda.empty_cache()
    return out


def sharded_reference(torch, model, train, cfg, batch, other, ref_dir):
    """Phase 19 (b)'s one-rank run: ``make_train_step`` from
    ``init_params(cfg, seed=0)`` on ``batch``; its weights and moments
    saved whole in ``ref_dir``; the control's loss and gnorm, another
    batch's from the same weights.  Frees the card."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import global_norm
    torch.cuda.reset_peak_memory_stats()
    lm = model.init_params(cfg, seed=0, device="cuda", trainable=True)
    loss_o = model.loss_fn(lm, other, cfg)
    loss_o.backward()
    gnorm_o = global_norm({n: p.grad for n, p in lm.named_parameters()})
    lm.zero_grad(set_to_none=True)
    state = adamw_init(lm)
    step = train.make_train_step(cfg, AdamWConfig(lr=SHARD_LR),
                                 total_steps=10)
    lm, state, m = step(lm, state, batch)
    ref_dir.mkdir(parents=True, exist_ok=True)
    torch.save({n: p.detach() for n, p in lm.named_parameters()},
               ref_dir / "params.pt")
    for key in ("m", "v"):
        torch.save(state[key], ref_dir / f"{key}.pt")
    out = dict(loss=float(m["loss"]), gnorm=float(m["gnorm"]),
               control_loss=float(loss_o.detach()),
               control_gnorm=float(gnorm_o),
               peak_bytes=torch.cuda.max_memory_allocated())
    del lm, state, loss_o
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def sharded_step(torch, ops, model, train, cfg, batch, other):
    """Phase 19 (b): the one-rank reference (``sharded_reference``), then
    four ranks of ``train.check_rank`` on SHARD_MESH; every rank's loss
    and gnorm equal and within SHARD_TOL of the reference's, each weight
    and moment block within its limit and each control above it, every
    flash launch on "wgmma" (per rank 2 forward a layer and 1 backward)."""
    import shutil
    from repro_torch.launch import ranks
    ref_dir = ROOT / "build" / "phase19_reference"
    shutil.rmtree(ref_dir, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        one = sharded_reference(torch, model, train, cfg, batch, other,
                                ref_dir)
        ref_s = time.perf_counter() - t0
        n = math.prod(SHARD_MESH)
        backend, cards = ranks.placement(n)
        log(f"sharded {cfg.name} {cfg.num_layers} layers, mesh {SHARD_MESH},"
            f" B={SHARD_BATCH} S={SHARD_SEQ}: the one-rank step {ref_s:.1f} s"
            f" (loss {one['loss']:.6f}, gnorm {one['gnorm']:.6f}, peak "
            f"{one['peak_bytes'] / 1e9:.2f} GB); {n} ranks, backend "
            f"{backend}, cards {cards}; before the ranks this process holds "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        t1 = time.perf_counter()
        # four ranks share card 0 under gloo: the ranks' allocators grow
        # their segments rather than cut new ones (less fragmentation)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        recs = ranks.spawn(train.check_rank, n, (
            cfg, SHARD_MESH, {k: v.cpu() for k, v in batch.items()},
            SHARD_LR, 0, str(ref_dir), "cuda"), deadline_s=900.0,
            timeout_s=600.0)
        spawn_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    L = cfg.num_layers
    for r in recs:
        log(f"sharded rank {r['rank']} ({r['backend']}, {r['card']}): loss "
            f"{r['loss']:.6f} gnorm {r['gnorm']:.6f}; step {r['step_ms']:.1f}"
            f" ms, collectives {sum(r['comm_ms'].values()):.1f} ms (CUDA "
            f"events; the host clock where gloo sums in host memory; by op "
            f"{json.dumps(r['comm_ms'])}), peak "
            f"{r['peak_gb'] or 0:.2f} GB; flash forward {r['flash']} backward "
            f"{r['flash_backward']}; weights max {r['params']['max']:.4e} "
            f"at {r['params']['leaf']} (median {r['params']['median']:.4e}),"
            f" m max {r['m']['max']:.4e} at {r['m']['leaf']}, v max "
            f"{r['v']['max']:.4e} at {r['v']['leaf']}")
        check(r["flash"] == {"wgmma": 2 * L, "fma": 0}
              and r["flash_backward"] == {"wgmma": L, "fma": 0},
              f"sharded rank {r['rank']}: flash launches {r['flash']}, "
              f"backward {r['flash_backward']}, expected {2 * L} and {L} on "
              "wgmma")
        check(r["loss"] == recs[0]["loss"] and r["gnorm"] == recs[0]["gnorm"],
              f"sharded rank {r['rank']}: loss {r['loss']} gnorm "
              f"{r['gnorm']} differ from rank 0's")
    loss_dev = abs(recs[0]["loss"] - one["loss"])
    gnorm_dev = abs(recs[0]["gnorm"] - one["gnorm"]) / one["gnorm"]
    ctl_loss = abs(one["control_loss"] - one["loss"])
    ctl_gnorm = abs(one["control_gnorm"] - one["gnorm"]) / one["gnorm"]
    worst = {key: max(r[key]["max"] for r in recs)
             for key in ("params", "m", "v")}
    log(f"sharded against one rank: loss |dev| {loss_dev:.4e} (limit "
        f"{SHARD_TOL['loss']:g}, control {ctl_loss:.4e}), gnorm |dev| / "
        f"gnorm {gnorm_dev:.4e} (limit {SHARD_TOL['gnorm']:g}, control "
        f"{ctl_gnorm:.4e}), weights {worst['params']:.4e} (limit "
        f"{SHARD_TOL['params']:g}, control 1), m {worst['m']:.4e} (limit "
        f"{SHARD_TOL['m']:g}, control 1), v {worst['v']:.4e} (limit "
        f"{SHARD_TOL['v']:g}, control 1); {spawn_s:.1f} s in the ranks")
    check(loss_dev <= SHARD_TOL["loss"] < ctl_loss,
          f"sharded: loss |dev| {loss_dev:.4e}, control {ctl_loss:.4e}, "
          f"limit {SHARD_TOL['loss']:g}")
    check(gnorm_dev <= SHARD_TOL["gnorm"] < ctl_gnorm,
          f"sharded: gnorm dev {gnorm_dev:.4e}, control {ctl_gnorm:.4e}, "
          f"limit {SHARD_TOL['gnorm']:g}")
    for key, dev in worst.items():
        check(dev <= SHARD_TOL[key] < 1.0,
              f"sharded: {key} {dev:.4e} over the limit {SHARD_TOL[key]:g}")
    return dict(one=one, ranks=recs, backend=backend, cards=cards,
                loss_dev=loss_dev, gnorm_dev=gnorm_dev,
                control_loss_dev=ctl_loss, control_gnorm_dev=ctl_gnorm,
                worst=worst, tol=SHARD_TOL, reference_s=ref_s,
                spawn_s=spawn_s)


def sharded_phase(torch, ops):
    """Phase 19: the remat policies (a), then the sharded step on four
    ranks (b).  Returns both records and the flash launches of each."""
    from repro_torch import configs
    from repro_torch.data import synthetic as data
    from repro_torch.launch import train
    from repro_torch.models import model
    t0 = time.perf_counter()
    cfg = configs.get(TRAIN_ARCH, num_layers=TRAIN_LAYERS)
    batch = next(data.token_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=1,
                                   device="cuda"))
    remat = remat_policies(torch, ops, model, train, cfg, batch)
    scfg = configs.get(SHARD_ARCH, num_layers=SHARD_LAYERS)
    stream = data.token_stream(scfg, SHARD_BATCH, SHARD_SEQ, seed=3,
                               device="cuda")
    sharded = sharded_step(torch, ops, model, train, scfg, next(stream),
                           next(stream))
    seconds = time.perf_counter() - t0
    log(f"phase 19: {seconds:.1f} s")
    launches = {
        "flash_attention": sum(p["flash"]["wgmma"] + p["flash"]["fma"]
                               for p in remat["policies"].values())
        + sum(sum(r["flash"].values()) for r in sharded["ranks"]),
        "flash_attention_backward": sum(
            sum(p["flash_backward"].values())
            for p in remat["policies"].values())
        + sum(sum(r["flash_backward"].values()) for r in sharded["ranks"])}
    return dict(remat=remat, sharded=sharded, launches=launches,
                seconds=seconds)


# --------------------------------------------------------------------------
# phase 20: the sharded serve step
# --------------------------------------------------------------------------

def serve_sharded_phase(torch, device="cuda", arch=SERVE_ARCH,
                        layers=SERVE_LAYERS, reduced=False):
    """Phase 20: the one-rank references (fp32 and bf16, saved under
    build/), then four ranks of ``serve.serve_rank`` on SERVE_MESH: the
    fp32 copy on its own tokens and bf16 fed the reference's, each held
    to SERVE_TOL (the bf16 control above it), no ``Gather`` forward in
    the steps, no kernel launched (decode runs none, as in JAX).  Returns
    the phase's records.  ``reduced`` (the CPU rehearsal) takes the
    registry's reduced config."""
    import shutil
    from repro_torch import configs
    from repro_torch.launch import ranks
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    get = configs.get_reduced if reduced else configs.get
    cfgs = {dt: get(arch, num_layers=layers, param_dtype=dt)
            for dt in ("float32", "bfloat16")}
    ref_dir = ROOT / "build" / "phase20_reference"
    shutil.rmtree(ref_dir, ignore_errors=True)
    ref_dir.mkdir(parents=True, exist_ok=True)
    n = math.prod(SERVE_MESH)
    new = SERVE_STEPS - SERVE_PROMPT + 1
    try:
        one = {dt: serve.reference_run(cfg, SHARD_SERVE_BATCH, SERVE_PROMPT,
                                       SERVE_STEPS, 0, str(ref_dir / dt),
                                       device)
               for dt, cfg in cfgs.items()}
        ref_s = time.perf_counter() - t0
        backend, cards = ranks.placement(n, device)
        runs = [dict(cfg=cfgs[dt], shape=SERVE_MESH, batch=SHARD_SERVE_BATCH,
                     prompt_len=SERVE_PROMPT, max_new=new,
                     max_len=SERVE_MAX_LEN, seed=0, device=device,
                     ref_path=str(ref_dir / dt), teacher=dt == "bfloat16")
                for dt in cfgs]
        if device == "cuda":
            os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                                  "expandable_segments:True")
        t1 = time.perf_counter()
        recs = ranks.spawn(serve.serve_rank_runs, n, (runs,), device=device,
                           deadline_s=600.0, timeout_s=300.0)
        spawn_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    cfg = cfgs["bfloat16"]
    log(f"serve-sharded {cfg.name} {cfg.num_layers} layers, mesh "
        f"{SERVE_MESH}, B={SHARD_SERVE_BATCH}, {SERVE_STEPS} steps, cache "
        f"{SERVE_MAX_LEN}: {n} ranks, backend {backend}, cards {cards}; the "
        f"one-rank references {ref_s:.1f} s (eager step fp32 "
        f"{one['float32']['ms']:.2f} ms, bf16 {one['bfloat16']['ms']:.2f} "
        f"ms), the ranks {spawn_s:.1f} s")
    out = dict(one=one, ranks={}, backend=backend, cards=cards,
               tol=SERVE_TOL, reference_s=ref_s, spawn_s=spawn_s)
    for rank_recs in recs:
        for rec in rank_recs:
            s = serve.summary(rec)
            log("serve-sharded " + serve.rank_line(rec))
            dt = rec["dtype"]
            out["ranks"].setdefault(dt, []).append(dict(
                s, launches=rec["launches"], teacher=rec["teacher"]))
            check(s["gather_forwards"] == 0, f"serve-sharded rank "
                  f"{rec['rank']} {dt}: {s['gather_forwards']} Gather "
                  "forwards in the steps")
            check(sum(rec["launches"].values()) == 0, f"serve-sharded rank "
                  f"{rec['rank']} {dt}: kernel launches {rec['launches']}")
            tol = SERVE_TOL[dt]
            check(s["dev"] <= tol, f"serve-sharded rank {rec['rank']} {dt}: "
                  f"logits max|dev| {s['dev']:.4e} over the limit {tol:g}")
            if dt == "float32":
                check(s["next_equal"], f"serve-sharded rank {rec['rank']} "
                      "fp32: predictions differ from the one-rank step's")
            else:
                check(s["control"] > tol, f"serve-sharded rank "
                      f"{rec['rank']} bf16: the control {s['control']:.4e} "
                      f"is within the limit {tol:g}")
    seconds = time.perf_counter() - t0
    per = out["ranks"]["bfloat16"][0]
    log(f"serve-sharded: bf16 {per['ms']:.2f} ms a step on rank 0, "
        f"collectives {per['comm_ms']:.2f} ms and "
        f"{per['comm_bytes'] / 1e6:.4f} MB a step (one token a row), the "
        f"small leaves gathered once {per['leaf_bytes'] / 1e6:.4f} MB; "
        f"phase 20: {seconds:.1f} s")
    out["seconds"] = seconds
    return out


# --------------------------------------------------------------------------
# phase 21: fit serving across ranks
# --------------------------------------------------------------------------

def fit_serving_ranks_phase(torch, device="cuda", small=False):
    """Phase 21: ``DecsvmFitServer`` on FIT_RANKS ranks placed as
    ``ranks.spawn`` places them (gloo on card 0 with one card, NCCL with a
    card a rank), through ``ranks.run_fit_serving``: rank 0 serves the
    full-size chunked request on FIT_RANKS_NUM points of phase 4c's grid
    and a dense one (m <= 4) by ``run()``, then a warm (KKT) and an LLA +
    threshold request at the design size through ``start()`` /
    ``result()`` / ``stop()``, while the others follow.  Every result is
    held to the one-rank server's on the same requests and to plain
    (1e-5, the same best lambda, table lambdas and stops, support flips
    only within the tolerance), each follower's to rank 0's bit for bit,
    the buckets' engine tags, every two-pass launch on "stream", no
    collective in the dense bucket.  A ``RankFailure`` or a failed gate
    fails the run.  Returns the records (the ranks' launches by kernel
    and instance, summed over the ranks).  ``small`` (the CPU rehearsal)
    shrinks the full-size problem to X (16, 64, 64)."""
    from repro_torch.launch import ranks
    t0 = time.perf_counter()
    check(ranks.TOL == FIT_TOL["float32"], "fitserve-ranks: the gate's "
          f"tolerance {ranks.TOL} is not FIT_TOL {FIT_TOL['float32']}")
    try:
        rec = ranks.run_fit_serving(FIT_RANKS, log=log, num=FIT_RANKS_NUM,
                                    device=device, small=small)
    except ranks.RankFailure as err:
        check(False, f"fitserve-ranks: {err}")
    rec["seconds"] = time.perf_counter() - t0
    log(f"fitserve-ranks phase: launches {json.dumps(rec['launches'])}, "
        f"by instance {json.dumps(rec['instances'])}; phase 21: "
        f"{rec['seconds']:.1f} s")
    return rec


# --------------------------------------------------------------------------
# phase 22: the dry runs against the card
# --------------------------------------------------------------------------

def _card_line(device: str = "cuda") -> str:
    if device != "cuda":
        return "the CPU (a rehearsal)"
    return subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dry_against_card(torch, ops, kind: str, card: str, device="cuda",
                     reduced=False):
    """(a) or (b) of phase 22 (``kind`` "train" or "decode"): the dry run
    of the step on mesh (1, 1), then the same step once on the card; the
    argument bytes gated, the peaks printed.  Returns the record.
    ``device="cpu"`` with ``reduced`` (the CPU rehearsal) takes the
    reduced configs and reads no peak."""
    from repro_torch import configs
    from repro_torch.data.synthetic import InputShape
    from repro_torch.launch import dryrun, serve, train
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model
    from repro_torch.optim import AdamWConfig
    t0 = time.perf_counter()
    names = ("data", "model")
    get = configs.get_reduced if reduced else configs.get
    if kind == "train":
        cfg = get(TRAIN_ARCH, num_layers=TRAIN_LAYERS)
        sh = InputShape("train", TRAIN_SEQ // (64 if reduced else 1),
                        TRAIN_BATCH, "train")
    else:
        cfg = get(DRY_SERVE_ARCH)
        sh = InputShape("decode", DRY_SERVE_LEN // (32 if reduced else 1),
                        DRY_SERVE_BATCH, "decode")
    rec = dryrun.run_one(cfg, sh, M.abstract_mesh((1, 1), names),
                         verbose=False)
    dry_s = time.perf_counter() - t0
    mesh = M._make((1, 1), names)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if kind == "train":
        params = shd.init_sharded(cfg, mesh, seed=0, device=dev)
        opt = shd.init_opt_state(cfg, mesh, dev)
        batch = {k: torch.randint(0, cfg.vocab_size, (sh.global_batch,
                                                     sh.seq_len),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        step, _ = train.make_jitted_train_step(cfg, AdamWConfig(), mesh,
                                               batch)
        inputs = (list(shd.blocks(params).values())
                  + list(opt["m"].values()) + list(opt["v"].values())
                  + [opt["step"]] + list(batch.values()))
        call = lambda: step(params, opt, batch)  # noqa: E731
    else:
        params = shd.init_sharded(cfg, mesh, seed=0, device=dev, fsdp=False,
                                  trainable=False)
        cache = shd.init_cache_blocks(cfg, mesh, sh.global_batch,
                                      sh.seq_len, device=dev)
        step, _ = serve.make_jitted_serve_step(cfg, mesh, sh.global_batch,
                                               sh.seq_len)
        token = torch.randint(0, cfg.vocab_size, (sh.global_batch,),
                              generator=gen, device=dev, dtype=torch.int32)
        pos = torch.tensor(sh.seq_len // 2, dtype=torch.int32, device=dev)
        inputs = (list(shd.blocks(params).values())
                  + [t for t, _ in model.cache_leaves(cache)] + [token, pos])
        serve.serve_leaves(params, mesh)      # its one-off, as the dry run's
        call = lambda: step(params, cache, token, pos)  # noqa: E731
    arg_bytes = _tensor_bytes(inputs)
    before = peak = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    ops.reset_launches()
    t1 = time.perf_counter()
    with M.bound(mesh):
        out = call()
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    step_s = time.perf_counter() - t1
    launches = dict(ops.launches)
    if kind == "train":
        check(bool(torch.isfinite(out[2]["loss"])), f"dry {kind}: the real "
              "step's loss is not finite")
    else:
        check(bool(torch.isfinite(out[1]).all()), f"dry {kind}: the real "
              "step's logits are not finite")
    del out, call, params, inputs
    if on_card:
        torch.cuda.empty_cache()
    mem = rec["memory_analysis"]
    what = (f"dry {kind} {cfg.name} {cfg.num_layers} layers "
            f"{cfg.param_dtype}, B={sh.global_batch}, "
            f"{'S' if kind == 'train' else 'cache'}={sh.seq_len}, mesh (1, 1)")
    check(mem["argument_bytes"] == arg_bytes, f"{what}: dry argument bytes "
          f"{mem['argument_bytes']} against {arg_bytes} of the step's input "
          "tensors on the card")
    temp = peak - before
    out = dict(kind=kind, arch=cfg.name, layers=cfg.num_layers,
               batch=sh.global_batch, seq=sh.seq_len, card=card,
               argument_bytes=mem["argument_bytes"], input_bytes=arg_bytes,
               predicted_peak_bytes=mem["peak_bytes"],
               measured_peak_bytes=peak,
               peak_ratio=mem["peak_bytes"] / max(peak, 1),
               predicted_temp_bytes=mem["temp_bytes"],
               measured_temp_bytes=temp,
               temp_ratio=mem["temp_bytes"] / max(temp, 1),
               allocated_before=before, roofline=rec["roofline"],
               comm_bytes=rec["comm_bytes"], kernels=rec["kernels"],
               launches=launches, dry_s=dry_s, step_s=step_s,
               seconds=time.perf_counter() - t0)
    log(f"{what} [{card}]: argument bytes {mem['argument_bytes']} = the "
        f"inputs' {arg_bytes} on the card; predicted peak "
        f"{mem['peak_bytes'] / 1e9:.3f} GB (argument + temp "
        f"{mem['temp_bytes'] / 1e9:.3f}) against "
        f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB (ratio "
        f"{out['peak_ratio']:.4f}; above the {before / 1e9:.3f} GB allocated "
        f"before the step {temp / 1e9:.3f} GB, ratio "
        f"{out['temp_ratio']:.4f}); roofline least time "
        f"{1e3 * max(rec['roofline'][k] for k in ('compute_s', 'memory_s', 'collective_s')):.3f}"
        f" ms ({rec['roofline']['dominant']}) against the real step's "
        f"{1e3 * step_s:.3f} ms (one call, the first); kernels on meta "
        f"{ {k: v['instances'] for k, v in rec['kernels'].items()} }, "
        f"launched on the card { {k: v for k, v in launches.items() if v} }")
    return out


def dryrun_phase(torch, ops, device="cuda", reduced=False):
    """Phase 22: the dry runs (``launch.dryrun``, ``launch.dryrun_decsvm``)
    against the card (see DRY_*).  (d) starts first in processes of its
    own (the dry runs need no card), (a)-(c) run meanwhile.  Returns the
    records.  ``device="cpu"`` with ``reduced`` (the CPU rehearsal): the
    reduced configs, and (d) on qwen3-14b's decode shape alone."""
    import shutil
    from repro_torch import configs
    from repro_torch.data.synthetic import InputShape
    from repro_torch.launch import dryrun, dryrun_decsvm
    from repro_torch.launch import mesh as M
    t0 = time.perf_counter()
    card = _card_line(device)
    out_dir = ROOT / "build" / "phase22_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = max(1, min(DRY_JOBS, (os.cpu_count() or 2) - 1))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    all_log = out_dir / "dryrun_all.log"
    which = (["--arch", "qwen3_14b", "--shape", "decode_32k"] if reduced
             else ["--all"])
    with open(all_log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *which,
             "--mesh", "both", "--out", str(out_dir / "lm"), "--jobs",
             str(jobs)], stdout=fh, stderr=subprocess.STDOUT, env=env,
            cwd=str(ROOT))
    get = configs.get_reduced if reduced else configs.get
    try:
        rec = dict(card=card, jobs=jobs)
        rec["train"] = dry_against_card(torch, ops, "train", card, device,
                                        reduced)
        rec["decode"] = dry_against_card(torch, ops, "decode", card, device,
                                         reduced)
        four = []
        for kind, arch, shape, batch, seq, measured in DRY_FOUR_CARD:
            sh = InputShape(kind, seq, batch, kind)
            r = dryrun.run_one(get(arch), sh, M.abstract_mesh(
                shape, ("data", "model")), verbose=False)
            roof = r["roofline"]
            least = max(roof[k] for k in ("compute_s", "memory_s",
                                          "collective_s"))
            comm = sum(r["comm_bytes"].values())
            four.append(dict(kind=kind, arch=arch, mesh=list(shape),
                             batch=batch, seq=seq, roofline=roof,
                             least_s=least,
                             peak_bytes=r["memory_analysis"]["peak_bytes"],
                             comm_bytes=r["comm_bytes"],
                             leaf_gather_bytes=r["leaf_gather_bytes"],
                             measured=measured))
            log(f"dry four-card {kind} {arch} mesh {shape} B={batch} "
                f"{'S' if kind == 'train' else 'max_len'}={seq} [{card}; "
                f"predictions for four such cards]: least time "
                f"{1e3 * least:.3f} ms a step ({roof['dominant']}: compute "
                f"{1e3 * roof['compute_s']:.3f}, memory "
                f"{1e3 * roof['memory_s']:.3f}, collectives "
                f"{1e3 * roof['collective_s']:.3f} at NVLink's rate), peak "
                f"{r['memory_analysis']['peak_bytes'] / 1e9:.3f} GB a card, "
                f"collectives {comm / 1e6:.6f} MB a step "
                f"{r['comm_bytes']} (small leaves gathered once "
                f"{sum(r['leaf_gather_bytes'].values()) / 1e6:.4f} MB); "
                f"measured ({measured})")
        rec["four_card"] = four
        t1 = time.perf_counter()
        decsvm = []
        n, p = (16, 127) if reduced else (2048, 131072)
        with contextlib.redirect_stdout(sys.stderr):
            for sched in ("gather", "ring"):
                for multi in (False, True):
                    decsvm.append(dryrun_decsvm.run_one(
                        256, n, p, sched, multi, out_dir / "decsvm"))
        for r in decsvm:
            log(f"dry decsvm {r['shape']} {r['mesh']} [{card}; a round, one "
                f"node a card]: argument {r['memory_analysis']['argument_bytes']}"
                f" bytes, collectives {r['collective_bytes']}, final gather "
                f"{r['final_gather_bytes']['hlo']}, least time "
                f"{1e3 * max(r['roofline'][k] for k in ('compute_s', 'memory_s', 'collective_s')):.4f}"
                f" ms ({r['roofline']['dominant']})")
        rec["decsvm"] = dict(wall_s=time.perf_counter() - t1,
                             records=len(decsvm))
        try:
            rc = proc.wait(timeout=max(1.0, DRY_DEADLINE_S
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            rc = None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = all_log.read_text()
    failures = [ln for ln in text.splitlines() if ln.startswith("FAILURES")]
    records = sorted((out_dir / "lm").glob("*.json"))
    bad = [p.stem for p in records
           if not json.loads(p.read_text()).get("ok")]
    rec["all"] = dict(rc=rc, records=len(records), failures=bad,
                      wall_s=time.perf_counter() - t0)
    log(f"dry --all --mesh both: rc {rc}, {len(records)} records, failures "
        f"{bad or failures}, {jobs} processes, done "
        f"{rec['all']['wall_s']:.1f} s into the phase; dryrun_decsvm: "
        f"{rec['decsvm']['records']} records in "
        f"{rec['decsvm']['wall_s']:.2f} s [{card}]")
    check(rc == 0 and not bad and len(records) == (2 if reduced else 80),
          f"dry --all --mesh both: rc {rc}, {len(records)} records, "
          f"failures {bad or failures} (log {all_log})")
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 22: {rec['seconds']:.1f} s")
    return rec


# --------------------------------------------------------------------------
# phase 23: recurrentgemma-2b training
# --------------------------------------------------------------------------

def rg_training_phase(torch, ops, ref):
    """Phase 23: recurrentgemma-2b as configured trains on the card — the
    kernel step against the plain-attention step (``train_step_vs_plain``
    at RG_STEP_TOL), ``train_loop`` with the counters read around it
    (``train_run``: every flash launch, forward and backward, on the
    tensor-core instances), and a checkpoint resume at the reduced config.
    Returns the phase's numbers."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs
    from repro_torch.data import synthetic as data
    from repro_torch.launch import train
    from repro_torch.models import model
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get(RG_TRAIN_ARCH)
    log(f"train {cfg.name}: as configured, no cut; {cfg.num_layers} layers "
        f"({kernel_layers(cfg)} attention), d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads}, D {cfg.head_dim}, "
        f"window {cfg.sliding_window}, lru_width {cfg.lru_width}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.padded_vocab} (padded, tied), "
        f"{cfg.param_dtype}")
    stream = data.token_stream(cfg, RG_STEP_BATCH, RG_TRAIN_SEQ, seed=1,
                               device="cuda")
    step_check = train_step_vs_plain(
        torch, ops, ref, model, cfg, next(stream), next(stream),
        loss_tol=RG_STEP_TOL["loss"], grad_tol=RG_STEP_TOL["grad"])
    del stream
    # the earlier steps' models and gradients can outlive them in reference
    # cycles until the collector runs (phase 22 has read 0.34 or 6.1 GB
    # held before its decode step from one run to the next); the loop's
    # ~68 GB peak leaves no room for them
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"train {cfg.name}: {held / 1e9:.3f} GB allocated before train_loop "
        "(after gc.collect)")
    run = train_run(torch, ops, train, cfg, RG_TRAIN_BATCH, RG_TRAIN_SEQ,
                    FAMILY_TRAIN_STEPS)
    run["held_before_bytes"] = held
    torch.cuda.empty_cache()
    resume = checkpoint_resume(torch, configs, model, train, data, ckpt,
                               arch=RG_TRAIN_ARCH)
    seconds = time.perf_counter() - t0
    log(f"phase 23: {seconds:.1f} s")
    return dict(step_check=step_check, run=run, resume=resume,
                seconds=seconds)


# --------------------------------------------------------------------------
# phases 24-26: granite-moe-3b-a800m, internvl2-1b and seamless-m4t-large-v2
# train on the card
# --------------------------------------------------------------------------

def forward_shape_checks(torch, ops, ref, cases, device, devs: dict):
    """``flash_attention`` at each case of ``cases`` (label, (B, H, KV, Sq,
    Sk, D, causal, window)) on bf16 inputs in the model's transposed
    layout: against ``ref.mha`` (one bf16 ulp), two launches of the
    tensor-core instance equal bit for bit, the second also writing its
    unrounded output (``o32``, as under grad): within FLASH_TOL_F32 of the
    plain fp32 output and rounding to the first; on the card the kernel and
    ``ref.mha`` timed in turns beside the bound and
    ``scaled_dot_product_attention`` (timed only, never on the path).
    Returns a row a case."""
    from repro_torch.kernels import cost
    F = torch.nn.functional
    on_card = torch.device(device).type == "cuda"
    rows = []
    for i, (label, case) in enumerate(cases):
        B, H, KV, S, Sk, D, causal, window = case
        kw = dict(causal=causal, window=window)
        before = dict(ops.flash_launches)
        q, k, v, o, _ = backward_inputs(torch, ops, case, "bfloat16", device,
                                        seed=300 + i)
        o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        again = ops.flash_attention(q, k, v, o32=o32, **kw)
        shape = (f"{label} B={B} H={H} KV={KV} Sq={S} Sk={Sk} D={D} "
                 f"causal={causal} window={window} bfloat16")
        instance = "plain"
        if on_card:
            instance = ops.flash_instance(q.dtype, D, q, k, v)
            ran = {n: c - before[n] for n, c in ops.flash_launches.items()}
            check(instance == "wgmma" and ran == {"wgmma": 2, "fma": 0},
                  f"flash_attention {shape}: launched {ran}, expected two "
                  "wgmma launches")
        check(torch.equal(o, again), f"flash_attention {shape}: two "
              "launches on the same inputs differ")
        check(torch.equal(o32.to(o.dtype), o), f"flash_attention {shape}: "
              "the unrounded output does not round to the output")
        dev32 = float((o32 - ref.mha(q.float(), k.float(), v.float(), **kw))
                      .abs().max())
        check(dev32 <= FLASH_TOL_F32, f"flash_attention {shape}: the "
              f"unrounded output's max|dev| {dev32:.3e} > {FLASH_TOL_F32}")
        check(tuple(o.shape) == tuple(q.shape) and o.dtype == q.dtype
              and bool(torch.isfinite(o).all()),
              f"flash_attention {shape}: output {tuple(o.shape)} {o.dtype}")
        dev, share = flash_deviation(torch, o, ref.mha(q, k, v, **kw),
                                     "bfloat16")
        record(devs, "flash_attention", "bfloat16", dev)
        log(f"check flash_attention {shape} [{instance}]: max|dev| "
            f"{dev:.3e} ({share:.3f} of the limit), relaunched bit for bit; "
            f"its unrounded output (o32) against the plain fp32 one max|dev| "
            f"{dev32:.3e} (limit {FLASH_TOL_F32:g}), rounding to it")
        check(share <= 1.0, f"flash_attention {shape}: max|dev| {dev:.3e} "
              f"is {share:.2f}x the limit")
        row = dict(case=label, instance=instance, max_abs_dev=dev,
                   share=share, o32_dev=dev32)
        if on_card:
            times = paired_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                              lambda: ref.mha(q, k, v, **kw), 10, 2)
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=H != KV), 10)
            bms, by = attention_bound(B, H, KV, S, D, 2, window, Sk=Sk,
                                      causal=causal)
            flops, _ = cost.attention_work(B, H, KV, S, D, 2, window, Sk,
                                           causal)
            row.update(times, bound_ms=bms, bound_by=by, library_ms=lib,
                       tflops=flops / times["ms"] / 1e9)
            log(f"time flash_attention {shape} [{instance}]: "
                f"{row['ms']:.4f} ms (samples {row['ms_samples'][0]:.4f}, "
                f"{row['ms_samples'][1]:.4f}; {row['tflops']:.1f} TFLOP/s, "
                f"{bms / row['ms']:.4f} of the bound), plain "
                f"{row['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
                f"scaled_dot_product_attention {lib:.4f} ms")
        rows.append(row)
        del q, k, v, o, again, o32
        if on_card:
            torch.cuda.empty_cache()
    return rows


def family_kernel_checks(torch, ops, ref, cases, device, devs: dict):
    """The forward (``forward_shape_checks``) and the backward
    (``backward_checks`` in bf16: against ``ref.mha_backward``, relaunched
    bit for bit, the control above the limit; on the card
    ``backward_timings``) at ``cases``."""
    out = dict(forward=forward_shape_checks(torch, ops, ref, cases, device,
                                            devs))
    out["backward"] = backward_checks(torch, ops, ref, device, devs,
                                      cases=cases, dtypes=("bfloat16",),
                                      delta=True)
    if torch.device(device).type == "cuda":
        out["backward_timing"] = backward_timings(torch, ops, ref, device,
                                                  cases=cases, reps=(5, 1),
                                                  delta=True)
    return out


def ssd_train_timing(torch, ops, ref, device="cuda"):
    """``ssd_scan`` at mamba2-370m's training shape (SSD_TRAIN_CASE, where
    960 of its launches run: the pass and remat of ``train_loop``):
    against ``ref.ssd_scan`` (phase 8's
    bf16 limits), then the device time of a call by CUDA-graph replay (and
    a call's time, host included) beside the bound and the plain version,
    in turns.  No single torch call computes the scan: no library time."""
    from repro_torch.launch.profile_ssd import graph_ms
    b, s, h, p, n, chunk = case = SSD_TRAIN_CASE
    args = ssd_inputs(torch, case, "bfloat16", device, seed=7)
    x, B, C = args[0], args[3], args[4]
    check(ops.ssd_instance(torch.bfloat16, p, n, chunk, x, B, C) == "wgmma",
          "mamba2-370m's training scan does not take the tensor-core "
          "instance")
    (ydev, yshare), (sdev, sshare) = ssd_deviation(
        torch, ops.ssd_scan(*args, chunk=chunk),
        ref.ssd_scan(*args, chunk=chunk), "bfloat16")
    check(yshare <= 1.0 and sshare <= 1.0, f"ssd_scan {case}: y at "
          f"{yshare:.3f}, the state at {sshare:.3f} of the limit")
    kernel = lambda: ops.ssd_scan(*args, chunk=chunk)  # noqa: E731
    plain = lambda: ref.ssd_scan(*args, chunk=chunk)  # noqa: E731
    g1 = graph_ms(kernel, 20)
    p1, p2 = cuda_ms(torch, plain, 2), cuda_ms(torch, plain, 2)
    g2 = graph_ms(kernel, 20)
    call = cuda_ms(torch, kernel, 10)
    bms, by = ssd_bound(*case, 2)
    row = dict(ms=(g1 + g2) / 2, ms_samples=[g1, g2], call_ms=call,
               plain_ms=(p1 + p2) / 2, plain_ms_samples=[p1, p2],
               bound_ms=bms, bound_by=by, library_ms=None, y_dev=ydev,
               y_share=yshare, state_dev=sdev, state_share=sshare,
               shape=f"x ({b}, {s}, {h}, {p}), B/C ({b}, {s}, {n}) bf16 "
                     f"strided, chunk {chunk}")
    log(f"time ssd_scan training [{row['shape']}] [wgmma]: {row['ms']:.4f} "
        f"ms on the device (graph samples {g1:.4f}, {g2:.4f}; "
        f"{bms / row['ms']:.4f} of the bound), {call:.4f} ms a call, plain "
        f"{row['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}), library: "
        f"none; against plain y {ydev:.3e} ({yshare:.3f} of the limit), "
        f"state {sdev:.3e} ({sshare:.3f})")
    del args
    torch.cuda.empty_cache()
    return row


def dry_step(cfg, batch: int, seq: int, card: str, kind: str = "train"):
    """The dry run (``launch.dryrun.run_one``) of ``cfg``'s ``kind`` step
    ("train" at batch x seq, "decode" of ``batch`` slots over a cache of
    ``seq``) on mesh (1, 1), at ``cfg``'s depth (the cut one where
    ``family_training_phase`` cuts it): argument bytes, predicted peak and
    the roofline's least time."""
    from repro_torch.data.synthetic import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    t0 = time.perf_counter()
    rec = dryrun.run_one(cfg, InputShape(kind, seq, batch, kind),
                         M.abstract_mesh((1, 1), ("data", "model")),
                         verbose=False)
    mem, roof = rec["memory_analysis"], rec["roofline"]
    least = max(roof[k] for k in ("compute_s", "memory_s", "collective_s"))
    out = dict(batch=batch, seq=seq, argument_bytes=mem["argument_bytes"],
               predicted_peak_bytes=mem["peak_bytes"],
               predicted_temp_bytes=mem["temp_bytes"], least_s=least,
               dominant=roof["dominant"],
               kernels={k: v["instances"] for k, v in rec["kernels"].items()},
               seconds=time.perf_counter() - t0)
    log(f"dry-{kind} {cfg.name} {cfg.num_layers} layers {cfg.param_dtype}, "
        f"B={batch} {'S' if kind == 'train' else 'cache'}={seq}, mesh (1, 1) "
        f"[{card}; a prediction]: argument "
        f"bytes {mem['argument_bytes']}, predicted peak "
        f"{mem['peak_bytes'] / 1e9:.3f} GB (argument + temp "
        f"{mem['temp_bytes'] / 1e9:.3f}), least time {1e3 * least:.3f} ms "
        f"({roof['dominant']}), kernels on meta {out['kernels']}; "
        f"{out['seconds']:.1f} s")
    return out


def family_batches(torch, cfg, batch: int, seq: int, seed: int, device):
    """Endless training batches of ``cfg`` at JAX's train shape of ``seq``
    positions: {"tokens", "labels"} from ``token_stream`` (seq less the
    VLM's media prefix: ``synthetic._text_len``) and, as
    ``synthetic.sample_batch`` draws them, the VLM's "media" (batch,
    frontend_len, d) or the encoder-decoder's "enc_media" (batch,
    ``synthetic._enc_len(cfg, seq)``, d): N(0, 0.02^2) from a numpy
    generator of ``seed``, in the model's dtype."""
    import numpy as np
    from repro_torch.data import synthetic as data
    text = data.token_stream(cfg, batch, data._text_len(cfg, seq),
                             seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    dt = getattr(torch, cfg.param_dtype)

    def draw(rows):
        return data._floats(rng.standard_normal((batch, rows, cfg.d_model))
                            * 0.02, dt, device)
    while True:
        b = next(text)
        if cfg.frontend == "vision":
            b["media"] = draw(cfg.frontend_len)
        if cfg.is_encoder_decoder:
            b["enc_media"] = draw(data._enc_len(cfg, seq))
        yield b


def expected_paths(cfg, steps: int) -> dict:
    """Flash forward launches by path (``flash_paths``) of ``steps`` train
    steps: each call of ``attention_calls`` twice a step (pass and
    remat)."""
    L = kernel_layers(cfg)
    paths = dict(decoder=2 * L * steps)
    if cfg.is_encoder_decoder:
        paths.update(encoder=2 * cfg.num_encoder_layers * steps,
                     cross=2 * L * steps)
    return paths


def family_train_run(torch, ops, train, model, cfg, batch: int, seq: int, *,
                     steps: int = TRAIN_STEPS, device="cuda"):
    """``steps`` train steps at batch x seq with the counters read around
    them (``timed_loop``): through ``train_loop`` on ``token_stream`` where
    the config takes no media, else ``make_train_step`` in a loop of its
    own on ``family_batches`` (``train_loop`` feeds ``token_stream`` only,
    which has neither "media" nor "enc_media"), from the same seed, lr
    and schedule.  Each step launches the flash forward twice a call of
    ``attention_calls`` (pass and remat; by path as ``expected_paths``)
    and the backward once, on the card all on the tensor-core instances,
    nothing else.  Returns the run."""
    from repro_torch.optim import AdamWConfig, adamw_init
    on_card = torch.device(device).type == "cuda"
    calls = attention_calls(cfg)
    if cfg.frontend == "vision" or cfg.is_encoder_decoder:
        def run():
            lm = model.init_params(cfg, seed=0, device=device,
                                   trainable=True)
            state = adamw_init(lm)
            step = train.make_train_step(cfg, AdamWConfig(lr=3e-4),
                                         total_steps=steps)
            stream = family_batches(torch, cfg, batch, seq, seed=0,
                                    device=device)
            losses = []
            for _ in range(steps):
                lm, state, m = step(lm, state, next(stream))
                losses.append(float(m["loss"]))
            return losses
    else:
        def run():
            _, losses = train.train_loop(cfg, steps=steps, batch=batch,
                                         seq=seq, lr=3e-4, log_every=1,
                                         seed=0, device=device)
            return losses
    with flash_paths(ops, collections.Counter()) as paths:
        out = timed_loop(torch, ops, train, run, batch, seq, steps, device)
    out["launches_by_path"] = dict(paths)
    want = {name: 0 for name in ops.KERNELS}
    want.update(flash_attention=2 * calls * steps,
                flash_attention_backward=calls * steps)
    check(out["launches"] == want, f"train {cfg.name}: launches "
          f"{out['launches']}, expected {want}")
    check(out["launches_by_path"] == expected_paths(cfg, steps),
          f"train {cfg.name}: flash forward launches by path "
          f"{out['launches_by_path']}, expected {expected_paths(cfg, steps)}")
    check(not on_card or (
        out["flash_instances"] == {"wgmma": 2 * calls * steps, "fma": 0}
        and out["backward_instances"] == {"wgmma": calls * steps, "fma": 0}),
        f"train {cfg.name}: launches by instance, forward "
        f"{out['flash_instances']}, backward {out['backward_instances']}; "
        "expected every one on the tensor-core instance")
    return out


def scatter_route_checks(torch, ops, model, cfg, batch, other, *,
                         tol=SCATTER_STEP_TOL, device="cuda"):
    """granite's scatter route under grad, from one set of weights, through
    the kernels.  (a) One step's loss and every gradient at capacity
    factor E / k (nothing drops) against the dense route's on ``batch``;
    the control: the scatter route's gradients of ``other``.  (b) The
    step at the configured capacity factor twice: the loss and every
    gradient equal bit for bit (the dispatch's backward gathers and sums
    by index, no atomic add).  Returns the readings."""
    from repro_torch.models import moe
    on_card = torch.device(device).type == "cuda"
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = int(batch["tokens"].numel())
    ample = dataclasses.replace(cfg, moe_routing="scatter",
                                moe_capacity_factor=E / k)
    tight = dataclasses.replace(cfg, moe_routing="scatter")
    check(moe.capacity(ample, T) > T, f"{cfg.name}: capacity "
          f"{moe.capacity(ample, T)} drops tokens")
    lm = model.init_params(cfg, seed=0, device=device, trainable=True)

    def loss_and_grads(c, b):
        return step_grads(model, lm, c, b)

    loss_d, grads_d = loss_and_grads(cfg, batch)
    loss_s, grads_s = loss_and_grads(ample, batch)
    _, grads_c = loss_and_grads(ample, other)
    devs = {n: leaf_deviation(torch, g, grads_d[n])
            for n, g in grads_s.items()}
    ctl = {n: leaf_deviation(torch, g, grads_d[n])
           for n, g in grads_c.items()}
    del grads_d, grads_s, grads_c
    loss_dev = abs(float(loss_s) - float(loss_d))
    worst = max(devs, key=devs.get)
    log(f"scatter {cfg.name} B={batch['tokens'].shape[0]} "
        f"S={batch['tokens'].shape[1]}, capacity factor {E / k:g} (C = "
        f"{moe.capacity(ample, T)}, nothing dropped) against the dense "
        f"route: loss {float(loss_s):.6f} against {float(loss_d):.6f}, "
        f"|dev| {loss_dev:.4e} (limit {tol['loss']:g}); gradients, max over "
        f"{len(devs)} parameters of max|g_s - g_d| / max|g_d|: "
        f"{devs[worst]:.4e} at {worst} (limit {tol['grad']:g}), median "
        f"{sorted(devs.values())[len(devs) // 2]:.4e}; control (another "
        f"batch's scatter gradients) min {min(ctl.values()):.4e} at "
        f"{min(ctl, key=ctl.get)}")
    for n in sorted(devs, key=devs.get)[-4:]:
        log(f"scatter leaf {n}: {devs[n]:.4e} (control {ctl[n]:.4e})")
    check(bool(torch.isfinite(loss_s)) and loss_dev <= tol["loss"],
          f"scatter vs dense: loss |dev| {loss_dev:.4e} > {tol['loss']}")
    check(devs[worst] <= tol["grad"], f"scatter vs dense: {worst} gradient "
          f"{devs[worst]:.4e} > {tol['grad']}")
    check(min(ctl.values()) > tol["grad"], "scatter vs dense: the control "
          f"{min(ctl.values()):.4e} is within the limit at "
          f"{min(ctl, key=ctl.get)}")
    drops = []
    slots = moe._slots

    def counted_slots(idx, c):
        C, slot = slots(idx, c)
        drops.append(int((slot >= C).sum()))
        return C, slot
    moe._slots = counted_slots
    try:
        first = loss_and_grads(tight, batch)
    finally:
        moe._slots = slots
    second = loss_and_grads(tight, batch)
    same = torch.equal(first[0], second[0]) and all(
        torch.equal(g, second[1][n]) for n, g in first[1].items())
    L = kernel_layers(cfg)
    dropped = sum(drops[:L])
    log(f"scatter {cfg.name} at capacity factor {cfg.moe_capacity_factor:g} "
        f"(C = {moe.capacity(tight, T)}; {dropped} of {T * k * L} "
        f"assignments dropped over {L} layers): two steps from the same "
        f"weights and batch {'equal' if same else 'differ'} bit for bit "
        f"(loss {float(first[0]):.6f} and every gradient)")
    check(same, f"{cfg.name}: two scatter steps differ")
    del lm, first, second
    if on_card:
        torch.cuda.empty_cache()
    return dict(loss_dense=float(loss_d), loss_scatter=float(loss_s),
                loss_dev=loss_dev, grad_dev_max=devs[worst],
                grad_dev_leaf=worst, control_min=min(ctl.values()), tol=tol,
                capacity_ample=moe.capacity(ample, T),
                capacity=moe.capacity(tight, T), dropped=dropped,
                assignments=T * k * L, bit_equal=same)


def moe_route_split(torch, model, cfg, batch: int, seq: int, card: str,
                    device="cuda"):
    """One step's forward + backward at batch x seq on each MoE route
    (the config's dense one, then scatter at its capacity factor), by
    device kernel (``kernel_split``: torch.profiler, after a warm-up):
    each route's device ms and its six largest items."""
    lm = model.init_params(cfg, seed=0, device=device, trainable=True)
    b = next(family_batches(torch, cfg, batch, seq, seed=3, device=device))
    rows = {}
    for c in (cfg, dataclasses.replace(cfg, moe_routing="scatter")):
        split = kernel_split(torch, lambda: step_grads(model, lm, c, b),
                             reps=1)
        top = sorted(split.items(), key=lambda kv: -kv[1])[:6]
        rows[c.moe_routing] = dict(device_ms=sum(split.values()), top=top)
        log(f"split {cfg.name} {c.moe_routing} route B={batch} S={seq} "
            f"[{card}]: {rows[c.moe_routing]['device_ms']:.2f} ms of device "
            f"time in one forward + backward; largest: "
            + "; ".join(f"{k[:60]} {v:.2f}" for k, v in top))
    del lm
    torch.cuda.empty_cache()
    return rows


def family_training_phase(torch, ops, ref, devs: dict, arch: str,
                          number, step_tol: dict, *, device="cuda",
                          reduced=False, cases=None,
                          steps=FAMILY_TRAIN_STEPS, seq=FAMILY_SEQ,
                          ckpt_dir=None, layers=None,
                          scatter_tol=SCATTER_STEP_TOL):
    """Phases 24-29: ``arch`` as configured (the reduced config with
    ``reduced``, the CPU rehearsals), its depth cut to ``layers`` where
    given, trains on the card.  The kernels at
    its training shapes (``family_kernel_checks`` at ``cases``, by default
    FAMILY_KERNEL_CASES); the dry run of its step at FAMILY_BATCH x seq
    (B = 1 where the predicted peak passes FAMILY_PEAK_LIMIT); one step
    through the kernels against the plain-attention step at
    FAMILY_STEP_BATCH x seq (``train_step_vs_plain`` at ``step_tol``); a
    MoE config's ``scatter_route_checks``; ``steps`` steps with the
    counters read around them (``family_train_run``), the peak beside the
    dry run's; a MoE config's scatter route timed beside them and, on the
    card, both routes split by kernel (``moe_route_split``); a checkpoint
    resume at the reduced config on the family's batches.
    Returns the phase's numbers."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs
    from repro_torch.data import synthetic as data
    from repro_torch.launch import train
    from repro_torch.models import model
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    card = _card_line(device)
    cfg = (configs.get_reduced if reduced else configs.get)(arch)
    full = configs.get(arch)
    cut = "as configured, no cut"
    if layers is not None:
        cut = f"depth cut {cfg.num_layers} -> {layers}, the one cut"
        cfg = dataclasses.replace(cfg, num_layers=layers)
    enc = (f"{cfg.num_encoder_layers} encoder + " if cfg.is_encoder_decoder
           else "")
    log(f"train {cfg.name}: {('reduced, ' if reduced else '') + cut};"
        f" {enc}{cfg.num_layers} layers ({attention_calls(cfg)} flash calls "
        f"a pass), d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads}, D {cfg.head_dim}, d_ff {cfg.d_ff}"
        + (f", {cfg.num_experts} experts top {cfg.num_experts_per_tok}"
           if cfg.num_experts else "")
        + f", vocab {cfg.padded_vocab} (padded"
        f"{', tied' if cfg.tie_embeddings else ''}), "
        f"{cfg.n_params() / 1e9:.3f} B parameters, "
        f"{cfg.param_dtype}; the registry's {full.num_layers} layers, d_model "
        f"{full.d_model}")
    out = dict(arch=cfg.name, card=card)
    out["kernels"] = family_kernel_checks(
        torch, ops, ref, FAMILY_KERNEL_CASES[arch] if cases is None else cases,
        device, devs)
    batch = FAMILY_BATCH
    out["dry"] = dry_step(cfg, batch, seq, card)
    if out["dry"]["predicted_peak_bytes"] > FAMILY_PEAK_LIMIT:
        log(f"train {cfg.name}: the cut is the batch, B = {batch} -> 1 (a "
            f"predicted peak of {out['dry']['predicted_peak_bytes'] / 1e9:.3f}"
            f" GB passes {FAMILY_PEAK_LIMIT / 1e9:g} GB)")
        batch = 1
        out["dry"] = dry_step(cfg, batch, seq, card)
    stream = family_batches(torch, cfg, FAMILY_STEP_BATCH, seq, seed=1,
                            device=device)
    one, other = next(stream), next(stream)
    out["step_check"] = train_step_vs_plain(
        torch, ops, ref, model, cfg, one, other, loss_tol=step_tol["loss"],
        grad_tol=step_tol["grad"], device=device)
    if cfg.num_experts:
        out["scatter"] = scatter_route_checks(torch, ops, model, cfg, one,
                                              other, tol=scatter_tol,
                                              device=device)
    del stream, one, other
    # the checks' models and gradients can outlive them in reference
    # cycles until the collector runs (phase 23's note)
    gc.collect()
    held = 0
    if on_card:
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
    run = family_train_run(torch, ops, train, model, cfg, batch, seq,
                           steps=steps, device=device)
    run["held_before_bytes"] = held
    losses = run.pop("losses")
    dry = out["dry"]
    log(f"train {cfg.name} B={batch} S={seq}"
        + (f" (media prefix {cfg.frontend_len} + text "
           f"{data._text_len(cfg, seq)})" if cfg.frontend == "vision" else "")
        + (f" (enc_media {data._enc_len(cfg, seq)} frames)"
           if cfg.is_encoder_decoder else "")
        + f" [{card}]: {steps} steps in {run['wall_s']:.2f} s, median step "
        f"{run['median_step_ms']:.2f} ms ({run['tokens_per_s']:.1f} tokens/s"
        f" of B x S positions; forward + backward {run['fwd_bwd_ms']:.2f} "
        f"ms, optimizer {run['opt_ms']:.2f} ms, CUDA events); peak "
        f"{run['peak_bytes'] / 1e9:.3f} GB (torch.cuda.max_memory_allocated, "
        f"{held / 1e9:.3f} GB held before) against the dry run's predicted "
        f"{dry['predicted_peak_bytes'] / 1e9:.3f} GB (argument bytes "
        f"{dry['argument_bytes']}); launches "
        f"{run['launches']['flash_attention']} flash forward "
        f"{json.dumps(run['flash_instances'])} by path "
        f"{json.dumps(run['launches_by_path'])}, "
        f"{run['launches']['flash_attention_backward']} backward "
        f"{json.dumps(run['backward_instances'])}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    out["run"] = run
    out["losses"] = losses
    if cfg.num_experts:
        tight = dataclasses.replace(cfg, moe_routing="scatter")
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        timed = family_train_run(torch, ops, train, model, tight, batch, seq,
                                 steps=SCATTER_TIMED_STEPS, device=device)
        timed.pop("losses")
        out["scatter_run"] = timed
        log(f"scatter {cfg.name} B={batch} S={seq} at capacity factor "
            f"{cfg.moe_capacity_factor:g} [{card}]: median step "
            f"{timed['median_step_ms']:.2f} ms of {SCATTER_TIMED_STEPS} "
            f"(forward + backward {timed['fwd_bwd_ms']:.2f}, optimizer "
            f"{timed['opt_ms']:.2f}; {timed['tokens_per_s']:.1f} tokens/s; "
            f"peak {timed['peak_bytes'] / 1e9:.3f} GB) against the dense "
            f"route's {run['median_step_ms']:.2f} ms (forward + backward "
            f"{run['fwd_bwd_ms']:.2f}; peak {run['peak_bytes'] / 1e9:.3f} "
            f"GB): scatter / dense {timed['median_step_ms'] / run['median_step_ms']:.4f}")
        if on_card:
            out["route_split"] = moe_route_split(torch, model, cfg, batch,
                                                 seq, card)
    if on_card:
        torch.cuda.empty_cache()
    out["resume"] = checkpoint_resume(
        torch, configs, model, train, data, ckpt, arch=arch, device=device,
        path=ckpt_dir, stream=lambda c: family_batches(
            torch, c, CKPT_BATCH, CKPT_SEQ, seed=2, device=device))
    out["batch"], out["seq"] = batch, seq
    out["seconds"] = time.perf_counter() - t0
    log(f"phase {number}: {out['seconds']:.1f} s")
    return out


def registry_serving(torch, ops, engine, arch: str, *, prompts, max_new,
                     model_tol, tokenwise_tol=None, dry_decode=False,
                     max_len=SERVE_LEN, model_prompt=MODEL_PROMPT,
                     device="cuda", reduced=False):
    """Phases 27-29's serving: ``arch`` as configured (the reduced config
    with ``reduced``, the CPU rehearsals) drawn from a collected allocator,
    the bytes held before it logged; ``prompts`` through ``ServeEngine``
    with block prefill, ``max_new`` tokens each, SERVE_BATCH slots of
    ``max_len`` (``backbone_serving``: on the card every flash launch on
    the tensor-core instance), the peak beside the dry run's decode step
    (``dry_step``) with ``dry_decode``; the prefill logits through
    the kernel against the plain attention within ``model_tol``, its
    control above it (``in_model_instances``); with ``tokenwise_tol``,
    block prefill against token-wise decode on the shortest prompt as
    phase 12 holds it: the first generated token's logits within
    ``tokenwise_tol`` (a control above it), then an fp32 copy of the model
    with the same greedy tokens within MODEL_TOL's fp32 limit.  Frees the
    model; returns the readings."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import blocks, model
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    gc.collect()
    held = 0
    if on_card:
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
    card = _card_line(device)
    cfg = (configs.get_reduced if reduced else configs.get)(arch)
    out = dict(arch=cfg.name, card=card, held_before_bytes=held)
    if dry_decode:
        out["dry_decode"] = dry_step(cfg, SERVE_BATCH, max_len, card,
                                     "decode")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device=device)
    synchronize(torch, device)
    weights = list(params.parameters())
    out.update(params=sum(p.numel() for p in weights),
               weight_bytes=_tensor_bytes(weights))
    del weights
    log(f"model {cfg.name}: {cfg.num_layers} layers "
        f"{json.dumps(dict(collections.Counter(blocks.block_kinds(cfg))))}, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads}, head_dim {cfg.head_dim}, vocab "
        f"{cfg.padded_vocab} (padded{', tied' if cfg.tie_embeddings else ''})"
        f", {out['params'] / 1e9:.3f} B parameters, "
        f"{out['weight_bytes'] / 1e9:.2f} GB {cfg.param_dtype}, drawn on "
        f"{'the card' if on_card else 'the CPU'} in "
        f"{time.perf_counter() - t1:.1f} s; {held / 1e9:.3f} GB allocated "
        "before it (after gc.collect)")
    served = backbone_serving(torch, ops, engine, cfg, params,
                              prompts=prompts, max_len=max_len,
                              instance="wgmma", max_new=max_new)
    steps = [ms for _, ms in served["decode_ms"]]
    out["serve"] = dict(launches=served["launches"]["flash_attention"],
                        instances=served["flash_instances"],
                        prefill_ms=served["prefill_ms"],
                        decode_ms_median=float(np.median(steps)),
                        wall_s=served["wall_s"])
    if on_card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        dry = out.get("dry_decode")
        log(f"serve {cfg.name} [{card}]: peak {out['peak_bytes'] / 1e9:.3f} "
            f"GB (torch.cuda.max_memory_allocated, from {held / 1e9:.3f} GB "
            f"held before the weights; weights {out['weight_bytes'] / 1e9:.3f}"
            " GB)" + (f" against the dry run's decode step "
                      f"{dry['predicted_peak_bytes'] / 1e9:.3f} GB (B="
                      f"{dry['batch']}, cache {dry['seq']}; ratio "
                      f"{dry['predicted_peak_bytes'] / out['peak_bytes']:.4f}"
                      "; the prefill's activations are on top of it)"
                      if dry else ""))
    controls = {}
    label = f"{cfg.name} {cfg.param_dtype} {cfg.num_layers} layers"
    dev, scale = in_model_instances(torch, ops, cfg, params, label=label,
                                    instance="wgmma", prompt=model_prompt,
                                    tol=model_tol, controls=controls)
    out["in_model"] = dict(max_abs_dev=dev, max_abs_logit=scale,
                           tol=model_tol, control_dev=controls[label])
    if tokenwise_tol is not None:
        short = served["prompts"][-1]
        out["tokenwise"] = [tokenwise_agreement(
            torch, engine, cfg, params, short, max_len=max_len,
            tol=tokenwise_tol, tokens=False)]
        del params
        if on_card:
            torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, param_dtype="float32")
        params = model.init_params(cfg32, seed=0, device=device)
        out["tokenwise"].append(tokenwise_agreement(
            torch, engine, cfg32, params, short, max_len=max_len,
            tol=MODEL_TOL["float32"]))
    del params, served
    if on_card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"serve {cfg.name}: {out['seconds']:.1f} s")
    return out


def registry_phase(torch, ops, ref, engine, devs: dict, arch: str,
                   number: int, step_tol: dict, serve: dict, *,
                   serve_over=None, **kw):
    """Phases 27-29: ``arch`` serves (``registry_serving`` with ``serve``,
    updated by ``serve_over``), then trains (``family_training_phase``
    with ``kw``); the phase's seconds and each part's logged."""
    t0 = time.perf_counter()
    args = dict(serve, **(serve_over or {}))
    served = registry_serving(torch, ops, engine, arch,
                              device=kw.get("device", "cuda"),
                              reduced=kw.get("reduced", False), **args)
    out = family_training_phase(torch, ops, ref, devs, arch,
                                f"{number} training", step_tol, **kw)
    out["served"] = served
    out["phase_seconds"] = time.perf_counter() - t0
    log(f"phase {number}: {out['phase_seconds']:.1f} s (serving "
        f"{served['seconds']:.1f}, training {out['seconds']:.1f})")
    return out


def glm4_phase(torch, ops, ref, engine, devs: dict, **kw):
    """Phase 27: glm4-9b serves as configured with phase 6's traffic (block
    prefill against token-wise decode, an fp32 copy too) and trains at
    full width cut to GLM4_TRAIN_LAYERS layers."""
    kw.setdefault("layers", GLM4_TRAIN_LAYERS)
    return registry_phase(
        torch, ops, ref, engine, devs, GLM4_ARCH, 27, GLM4_STEP_TOL,
        dict(prompts=SERVE_PROMPTS, max_new=SERVE_NEW,
             model_tol=GLM4_MODEL_TOL, tokenwise_tol=GLM4_TOKENWISE_TOL),
        **kw)


def command_r_phase(torch, ops, ref, engine, devs: dict, **kw):
    """Phase 28: command-r-35b serves as configured with phase 11's
    traffic, its peak beside the dry run's decode step, and trains at full
    width cut to COMMAND_R_TRAIN_LAYERS layers (the 256,000-way tied head
    under grad)."""
    kw.setdefault("layers", COMMAND_R_TRAIN_LAYERS)
    return registry_phase(
        torch, ops, ref, engine, devs, COMMAND_R_ARCH, 28, COMMAND_R_STEP_TOL,
        dict(prompts=GRANITE_PROMPTS, max_new=NEW_TOKENS,
             model_tol=COMMAND_R_MODEL_TOL, dry_decode=True), **kw)


def granite1b_phase(torch, ops, ref, engine, devs: dict, **kw):
    """Phase 29: granite-moe-1b-a400m serves with phase 11's traffic and
    trains as configured on both MoE routes (as phase 24)."""
    kw.setdefault("scatter_tol", GRANITE1B_SCATTER_TOL)
    return registry_phase(
        torch, ops, ref, engine, devs, GRANITE1B_ARCH, 29, GRANITE1B_STEP_TOL,
        dict(prompts=GRANITE_PROMPTS, max_new=NEW_TOKENS,
             model_tol=GRANITE1B_MODEL_TOL), **kw)


def granite_training_phase(torch, ops, ref, devs: dict, **kw):
    """Phase 24: granite-moe-3b-a800m trains on the card on the dense
    route (its config's) through ``train_loop``; its scatter route against
    the dense one, bit for bit, and timed (``family_training_phase``)."""
    return family_training_phase(torch, ops, ref, devs, GRANITE_TRAIN_ARCH,
                                 24, GRANITE_STEP_TOL, **kw)


def vlm_training_phase(torch, ops, ref, devs: dict, **kw):
    """Phase 25: internvl2-1b trains on the card behind its media prefix
    (``family_training_phase``), and ``ssd_scan`` is timed at mamba2-370m's
    training shape (``ssd_train_timing``) on the card."""
    out = family_training_phase(torch, ops, ref, devs, VLM_TRAIN_ARCH, 25,
                                VLM_STEP_TOL, **kw)
    if torch.device(kw.get("device", "cuda")).type == "cuda":
        out["ssd_train"] = ssd_train_timing(torch, ops, ref)
    return out


def encdec_training_phase(torch, ops, ref, devs: dict, **kw):
    """Phase 26: seamless-m4t-large-v2 trains on the card through its
    encoder and cross-attention (``family_training_phase``): per step 24
    encoder, 24 decoder and 24 cross calls of the flash kernel, each twice
    (pass and remat), and 72 backward launches."""
    return family_training_phase(torch, ops, ref, devs, ENCDEC_TRAIN_ARCH,
                                 26, ENCDEC_STEP_TOL, **kw)


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are not under {ROOT / 'src'}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import repro_torch.core as core
    from repro_torch import configs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import csvm_update as cu
    from repro_torch.models import model
    from repro_torch.serving import engine

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s (one nvcc per source, "
        f"in parallel), {sorted(p.name for p in libs.values())}")
    for name in libs:
        smem = ptxas_smem(build.build_log(name))
        for kernel, regs, spills in ptxas_report(build.build_log(name)):
            extra = ""
            if kernel.startswith(STREAM_KERNELS):
                isz = 4 if "float" in kernel else 2
                extra = (f", {smem[kernel]} bytes static shared memory + "
                         f"{ops.round_stream_smem_bytes(4096, isz)} dynamic "
                         "at p = 4096")
            log(f"ptxas {kernel}: {regs} registers, {spills}{extra}")
    sass = tensor_core_sass(build)
    ssd_sass = ssd_tensor_core_sass(build)
    forward_sass_unchanged(ssd_sass)
    backward_sass = backward_tensor_core_sass(build)
    ssd_backward_sass = ssd_backward_tensor_core_sass(build)
    # the gradient pass's shared memory is sized so that two blocks share
    # an SM at mamba2-370m's p 64, n 128
    ssd_backward_sass["blocks_per_sm"] = ops.ssd_backward_occupancy(0, 64,
                                                                    128)
    log(f"ssd_scan_backward gradient pass: "
        f"{ssd_backward_sass['blocks_per_sm']} resident blocks per SM at p "
        f"64, n 128 ({ops.ssd_backward_smem_bytes(64, 64, 128, 'wgmma')} "
        "bytes of shared memory a block)")
    check(ssd_backward_sass["blocks_per_sm"] >= 2, "the tensor-core "
          "gradient pass fits fewer than two blocks an SM at p 64, n 128")
    bulk = bulk_copy_sass(build)
    for bf16 in (False, True):
        per_sm, sms = ops.round_block_occupancy(0, bf16)
        st_sm, _ = ops.round_block_occupancy(0, bf16, "stream", 4096)
        grid = ops.round_block_grid(
            0, 16, 1024, 4096, torch.bfloat16 if bf16 else torch.float32)
        log(f"round kernel ({'bf16' if bf16 else 'fp32'} X): direct {per_sm} "
            f"co-resident blocks per SM x {sms} SMs; stream {st_sm} per SM at"
            f" p = 4096, grid {grid} at X (16, 1024, 4096)")
        tp_sm, _ = ops.two_pass_occupancy(0, bf16, 4096)
        tp_grid = ops.two_pass_grid(
            0, 16, 1024, 4096, torch.bfloat16 if bf16 else torch.float32)
        log(f"two-pass update ({'bf16' if bf16 else 'fp32'} X): stream "
            f"kernel {tp_sm} resident blocks per SM at p = 4096, grid "
            f"{tp_grid} at X (16, 1024, 4096)")

    # phases 3-4: the CSVM kernels and the fit path
    devs = {}
    t0 = time.perf_counter()
    design = Data(torch, core, core.SimConfig(p=100, s=10, m=10, n=200))
    full = Data(torch, core, core.SimConfig(p=4095, s=10, m=16, n=1024,
                                            rho=0.5))
    log(f"data: {time.perf_counter() - t0:.1f} s; full X "
        f"{tuple(full.X.shape)} lam {full.lam:.5f} h {full.h:.5f}")
    kernel_checks(torch, ops, cu, design, "design (10, 200, 101)", devs)
    kernel_checks(torch, ops, cu, full, "full (16, 1024, 4096)", devs)
    torch.cuda.synchronize()
    from repro_torch.launch.profile_ssd import graph_ms
    rows = kernel_timings(torch, ops, cu, full, 300, graph_ms=graph_ms)
    two_pass_instances = {}
    launches = main_path(torch, core, ops, full,
                         two_pass=two_pass_instances)
    round_instances = dict(ops.round_block_launches)

    # phase 4b: the lambda path at full size, on phase 4's data
    lpath = lambda_path_phase(torch, core, ops, full, design)
    for name in FIT_KERNELS:
        launches[name] += lpath["launches"][name]
    for name in round_instances:
        round_instances[name] += lpath["round_instances"][name]

    # phase 4c: fit serving, on phase 4's data and at the design size
    fitserve = fit_serving_phase(torch, core, ops, full, design)
    for name in FIT_KERNELS:
        launches[name] += fitserve["launches"][name]
    for name in round_instances:
        round_instances[name] += fitserve["round_instances"][name]
    for name in two_pass_instances["csvm_block_update"]:
        two_pass_instances["csvm_block_update"][name] += \
            fitserve["two_pass_instances"][name]
    # phase 4d: the decentralized engines across four ranks on card 0,
    # after the two-pass kernels at the node blocks the ranks give them
    for d_, nodes, what in ((full, 4, "node 4 / node_chunk 4"),
                            (full, 8, "node 2 x lam 2"),
                            (design, 3, "node_chunk 4 (m_pad 12)"),
                            (design, 5, "node 2 x lam 2")):
        m_, n_, p_ = d_.X.shape
        block_checks(torch, ops, cu, d_, nodes,
                     f"rank block ({nodes}, {n_}, {p_}) of ({m_}, {n_}, "
                     f"{p_}), {what}", devs)
    del design, full
    ranks = ranks_phase()
    for name in ranks["launches"]:
        launches[name] += ranks["launches"][name]
        for inst, n in ranks["instances"][name].items():
            two_pass_instances[name][inst] += n

    # phase 5: flash_attention against its plain version, and its times
    flash_checks(torch, ops, ref, "cuda", devs)
    torch.cuda.synchronize()
    rows["flash_attention"] = flash_timings(torch, ops, ref, "cuda")

    # phase 6: the serving path at full width
    cfg = configs.get("qwen3_14b")
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    log(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.padded_vocab} (padded), "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
        f"parameters, {weight_bytes / 1e9:.2f} GB {cfg.param_dtype}, drawn "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    served = serving_path(torch, ops, engine, cfg, params)
    launches["flash_attention"] = served["launches"]["flash_attention"]
    check(served["flash_instances"] == {
        "wgmma": launches["flash_attention"], "fma": 0},
        f"serving: flash launches by instance {served['flash_instances']}, "
        "expected every one on the tensor-core instance")
    cache_bytes = (2 * cfg.num_layers * SERVE_BATCH * SERVE_LEN
                   * cfg.num_kv_heads * cfg.head_dim * 2)
    steps = [ms for _, ms in served["decode_ms"]]
    decode_bound = 1e3 * weight_bytes / PEAK_BYTES
    log(f"serve decode: median {float(np.median(steps)):.2f} ms a step "
        f"against the weight-read bound {decode_bound:.2f} ms "
        f"({weight_bytes / 1e9:.2f} GB / 3.35 TB/s); the KV cache is "
        f"{cache_bytes / 1e9:.3f} GB")

    # phase 7: the kernel against the plain attention inside the model
    model_devs = {"bfloat16": kernel_vs_plain_in_model(
        torch, ops, cfg, params, label=f"{cfg.name} bf16 40 layers",
        tol=MODEL_TOL["bfloat16"])}

    # phase 7b: the decentralized CSVM head on phase 6's frozen weights
    t_new = time.perf_counter()
    heads = {cfg.name: head_phase(torch, core, ops, cfg, params)}
    del params
    torch.cuda.empty_cache()
    new_phase_s = time.perf_counter() - t_new
    cfg2 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32")
    params = model.init_params(cfg2, seed=0, device="cuda")
    model_devs["float32"] = kernel_vs_plain_in_model(
        torch, ops, cfg2, params, label=f"{cfg.name} fp32 2 layers",
        tol=MODEL_TOL["float32"])
    del params
    torch.cuda.empty_cache()
    # the reduced config (D = 64, group 2) in bf16: the tensor-core
    # instance at its other head dim, inside the model
    cfg3 = configs.get_reduced("qwen3_14b", param_dtype="bfloat16")
    params = model.init_params(cfg3, seed=0, device="cuda")
    before = ops.flash_launches["wgmma"]
    model_devs["bfloat16 reduced"] = kernel_vs_plain_in_model(
        torch, ops, cfg3, params, label=f"{cfg3.name} bf16 D = "
        f"{cfg3.head_dim}", tol=MODEL_TOL["bfloat16"])
    check(ops.flash_launches["wgmma"] - before == cfg3.num_layers,
          f"{cfg3.name}: the prefill did not take the tensor-core instance")
    del params
    torch.cuda.empty_cache()

    # phase 8: ssd_scan against its plain version, and its times
    ssd_checks(torch, ops, ref, "cuda", devs)
    torch.cuda.synchronize()
    rows["ssd_scan"] = ssd_timings(torch, ops, ref, "cuda")

    # phase 9: the mamba2 serving path at full width
    mcfg = configs.get("mamba2_370m")
    t0 = time.perf_counter()
    params = model.init_params(mcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    m_weight_bytes = sum(p.numel() * p.element_size()
                         for p in params.parameters())
    log(f"model {mcfg.name}: {mcfg.num_layers} layers, d_model "
        f"{mcfg.d_model}, d_inner {mcfg.ssm_dinner}, {mcfg.ssm_nheads} heads "
        f"x {mcfg.ssm_headdim}, state {mcfg.ssm_state}, chunk "
        f"{mcfg.ssm_chunk}, vocab {mcfg.padded_vocab} (padded, tied), "
        f"{sum(p.numel() for p in params.parameters()) / 1e6:.1f} M "
        f"parameters, {m_weight_bytes / 1e9:.3f} GB {mcfg.param_dtype}, "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    m_served = serving_path(torch, ops, engine, mcfg, params,
                            kernel="ssd_scan")
    launches["ssd_scan"] = m_served["launches"]["ssd_scan"]
    check(m_served["ssd_instances"] == {"wgmma": launches["ssd_scan"],
                                        "fma": 0},
          f"serving: ssd_scan launches by instance "
          f"{m_served['ssd_instances']}, expected every one on the "
          "tensor-core instance")
    m_steps = [ms for _, ms in m_served["decode_ms"]]
    conv_ch = mcfg.ssm_dinner + 2 * mcfg.ssm_groups * mcfg.ssm_state
    m_state_bytes = mcfg.num_layers * SERVE_BATCH * (
        mcfg.ssm_nheads * mcfg.ssm_headdim * mcfg.ssm_state * 4
        + (mcfg.conv_width - 1) * conv_ch * 2)
    m_decode_bound = 1e3 * (m_weight_bytes + 2 * m_state_bytes) / PEAK_BYTES
    log(f"serve decode {mcfg.name}: median {float(np.median(m_steps)):.2f} "
        f"ms a step against the bound {m_decode_bound:.3f} ms (the weights "
        f"read once, {m_weight_bytes / 1e9:.3f} GB, and the "
        f"{m_state_bytes / 1e9:.3f} GB conv and SSM state read and written "
        "once, at 3.35 TB/s)")

    # phase 10: the kernel against the plain scan inside the model
    before = dict(ops.ssd_launches)
    mamba_devs = {"bfloat16": ssd_vs_plain_in_model(
        torch, ops, mcfg, params, label=f"{mcfg.name} bf16 48 layers",
        tol=MAMBA_TOL["bfloat16"])}
    model_instances = {k: v - before[k] for k, v in ops.ssd_launches.items()}
    check(model_instances == {"wgmma": mcfg.num_layers, "fma": 0},
          f"{mcfg.name} bf16 prefill: ssd_scan launches by instance "
          f"{model_instances}, expected {mcfg.num_layers} on the "
          "tensor-core instance")
    del params
    torch.cuda.empty_cache()
    mcfg2 = dataclasses.replace(mcfg, num_layers=2, param_dtype="float32")
    params = model.init_params(mcfg2, seed=0, device="cuda")
    mamba_devs["float32"] = ssd_vs_plain_in_model(
        torch, ops, mcfg2, params, label=f"{mcfg.name} fp32 2 layers",
        tol=MAMBA_TOL["float32"])
    del params
    torch.cuda.empty_cache()

    # phase 11: granite-moe-3b-a800m at full width — serving, the kernel
    # against the plain attention inside the model (the tensor-core
    # instance at D = 64), the two MoE routes, and the head on its features
    t_new = time.perf_counter()
    gcfg, params, _ = new_model(torch, model, configs, "granite_moe_3b_a800m")
    g_served = backbone_serving(torch, ops, engine, gcfg, params,
                                prompts=GRANITE_PROMPTS, max_len=SERVE_LEN,
                                instance="wgmma")
    g_tokenwise = [tokenwise_agreement(torch, engine, gcfg, params, prompt,
                                       max_len=SERVE_LEN)
                   for prompt in g_served["prompts"][-GRANITE_TOKENWISE:]]
    model_devs["bfloat16 granite-moe-3b"] = in_model_instances(
        torch, ops, gcfg, params, label=f"{gcfg.name} bf16 32 layers",
        instance="wgmma")
    moe_routes = moe_route_checks(torch, gcfg, params)
    heads[gcfg.name] = head_phase(torch, core, ops, gcfg, params,
                                  shape=BACKBONE_HEAD_SHAPE, plain_seqs=0,
                                  fits=("megakernel",))
    del params
    torch.cuda.empty_cache()

    # phase 12: recurrentgemma-2b at full width — serving with a prompt
    # longer than the window, the kernel against the plain attention inside
    # the model (the tensor-core instance at D = 256), its flash and RG-LRU
    # times, and the head on its features
    rcfg, params, _ = new_model(torch, model, configs, "recurrentgemma_2b")
    check(RG_PROMPTS[0] > rcfg.sliding_window and RG_LEN > RG_PROMPTS[0],
          "recurrentgemma: the long prompt does not wrap the ring cache")
    r_served = backbone_serving(torch, ops, engine, rcfg, params,
                                prompts=RG_PROMPTS, max_len=RG_LEN,
                                instance="wgmma")
    short = r_served["prompts"][-1]
    rg_tokenwise = [tokenwise_agreement(torch, engine, rcfg, params, short,
                                        max_len=RG_LEN, tol=RG_TOKENWISE_TOL,
                                        tokens=False)]
    model_devs["bfloat16 recurrentgemma-2b"] = in_model_instances(
        torch, ops, rcfg, params, label=f"{rcfg.name} bf16 26 layers "
        f"({kernel_layers(rcfg)} attention)", instance="wgmma")
    d256 = flash_d256_timing(torch, ops, ref, "cuda")
    rows["flash_attention"]["variants"].append(d256)
    # the long prompt's prefill launch (S = 2099, the window active) held
    # against plain at the shape the main path gives it
    rows["flash_attention"]["variants"].append(flash_d256_timing(
        torch, ops, ref, "cuda", S=RG_PROMPTS[0] - 1,
        window=rcfg.sliding_window))
    lru = rglru_timing(torch, rcfg, params)
    heads[rcfg.name] = head_phase(torch, core, ops, rcfg, params,
                                  shape=BACKBONE_HEAD_SHAPE, plain_seqs=0,
                                  fits=("megakernel",))
    del params
    torch.cuda.empty_cache()
    # greedy tokens over a 256,000-token vocabulary are no function of the
    # path in bf16 (logits of ~4 are bf16 multiples of 2^-5, so the top two
    # tie exactly at some step); in fp32 the two paths give the same tokens
    rcfg32 = dataclasses.replace(rcfg, param_dtype="float32")
    params = model.init_params(rcfg32, seed=0, device="cuda")
    rg_tokenwise.append(tokenwise_agreement(torch, engine, rcfg32, params,
                                            short, max_len=RG_LEN,
                                            tol=MODEL_TOL["float32"]))
    del params
    torch.cuda.empty_cache()
    new_phase_s += time.perf_counter() - t_new

    # phase 13: internvl2-1b at full width — serving as a text LM, the
    # kernel against the plain attention inside the model, the forward
    # pass behind its media prefix, and the head on its features; first
    # the flash kernel with keys of their own length (phase 14's cross
    # and encoder shapes) against its plain version, and its times
    t_13 = time.perf_counter()
    cross_checks(torch, ops, ref, "cuda", devs)
    rows["flash_attention"]["variants"] += cross_timings(torch, ops, ref,
                                                         "cuda")
    vcfg, params, _ = new_model(torch, model, configs, "internvl2_1b")
    v_served = backbone_serving(torch, ops, engine, vcfg, params,
                                prompts=VLM_PROMPTS, max_len=SERVE_LEN,
                                instance="wgmma")
    controls, model_limits = {}, {}
    model_devs["bfloat16 internvl2-1b"] = in_model_instances(
        torch, ops, vcfg, params, label=f"{vcfg.name} bf16 "
        f"{vcfg.num_layers} layers", instance="wgmma", tol=VLM_MODEL_TOL,
        controls=controls)
    model_limits["bfloat16 internvl2-1b"] = dict(
        tol=VLM_MODEL_TOL, control_dev=controls.popitem()[1])
    v_media = media_forward(torch, ops, vcfg, params, tol=VLM_MEDIA_TOL,
                            control=True)
    check(v_media["instances"] == {**{k: 0 for k in ops.flash_launches},
                                   "wgmma": v_media["launches"]},
          f"{vcfg.name} media forward: flash launches by instance "
          f"{v_media['instances']}, expected all on wgmma")
    heads[vcfg.name] = head_phase(torch, core, ops, vcfg, params,
                                  shape=BACKBONE_HEAD_SHAPE, plain_seqs=0,
                                  fits=("megakernel",))
    del params
    torch.cuda.empty_cache()

    # phase 14: seamless-m4t-large-v2 at full width — the encoder, the
    # decoder and its cross-attention through prefill, then lockstep
    # decode; the kernel against the plain attention on all three paths;
    # block prefill against token-wise decode from build_cross_cache (bf16,
    # then an fp32 copy: the same tokens)
    scfg, params, _ = new_model(torch, model, configs,
                                "seamless_m4t_large_v2")
    encdec = encdec_phase(torch, ops, scfg, params)
    model_devs["bfloat16 seamless-m4t-large-v2"] = encdec["in_model"]
    model_limits["bfloat16 seamless-m4t-large-v2"] = dict(
        tol=ENCDEC_MODEL_TOL, control_dev=encdec.pop("in_model_control"))
    short, short_media = encdec.pop("short")
    del params
    torch.cuda.empty_cache()
    scfg32 = dataclasses.replace(scfg, param_dtype="float32")
    params = model.init_params(scfg32, seed=0, device="cuda")
    encdec["tokenwise"].append(encdec_tokenwise(
        torch, scfg32, params, short, short_media,
        tol=MODEL_TOL["float32"]))
    del params, short_media
    torch.cuda.empty_cache()
    phase_13_14_s = time.perf_counter() - t_13
    log(f"new phases (13, 14): {phase_13_14_s:.1f} s")

    # phase 15: training — flash_attention_backward against its plain
    # version at the families' shapes and its times; qwen3-14b at full
    # width, 4 layers: the kernel step against the plain-attention step,
    # then train_loop (the main path, counters read around it); the
    # checkpoint resume
    training = training_phase(torch, ops, ref, devs)
    rows["flash_attention_backward"] = training["timing"]
    # phase 16: the two instances of the forward and of the backward on
    # the same inputs at every case (D = 64, 128, 256), and their times
    t16 = time.perf_counter()
    forward_instances = forward_instance_checks(torch, ops, ref, "cuda",
                                                devs)
    backward_instances = backward_instance_checks(torch, ops, ref, "cuda",
                                                  devs)
    log(f"phase 16: {time.perf_counter() - t16:.1f} s")
    # phase 17: mamba2 training — ssd_scan_backward against its plain
    # version and its times; mamba2-370m as configured: the kernel step
    # against the plain-scan step, then train_loop (the main path, counters
    # read around it); the checkpoint resume at the reduced config
    mamba_training = mamba_training_phase(torch, ops, ref, devs)
    rows["ssd_scan_backward"] = mamba_training["timing"]
    # phase 18: mamba2's fp32 step at full depth; the backward's two
    # instances on the same inputs, and their times; mamba2's step split
    # by kernel with each
    ssd_backward = ssd_backward_phase(torch, ops, ref, devs)
    # phase 19: the remat policies "dots" and "names" against "full" on
    # phase 15's configuration, and the sharded train step on four ranks
    # against the one-rank step (qwen3-14b at full width, 2 layers)
    phase19 = sharded_phase(torch, ops)
    # phase 20: the sharded serve step on four ranks against the one-rank
    # step (qwen3-32b at full width, 4 layers); it launches no kernel
    phase20 = serve_sharded_phase(torch)
    # phase 21: fit serving across four ranks against the one-rank server
    phase21 = fit_serving_ranks_phase(torch)
    # phase 22: the dry runs against the card: phase 15's step and phase
    # 6's decode step dry-run and run, the four-card runs predicted, every
    # combination of JAX's dry runs
    phase22 = dryrun_phase(torch, ops)
    # phase 23: recurrentgemma-2b as configured trains on the card through
    # the D = 256 instances: the kernel step against the plain-attention
    # step, train_loop (counters read around it), a resume
    phase23 = rg_training_phase(torch, ops, ref)
    rg_launches = phase23["run"]["launches"]
    # phases 24-26: granite-moe-3b-a800m (both MoE routes), internvl2-1b
    # (behind its media prefix) and seamless-m4t-large-v2 (through its
    # encoder and cross-attention) train on the card as configured; the
    # flash kernels at their training shapes; ssd_scan at mamba2-370m's
    families = {}
    for phase in (granite_training_phase, vlm_training_phase,
                  encdec_training_phase):
        rec = phase(torch, ops, ref, devs)
        families[rec["arch"]] = rec
    # phases 27-29: the registry's last three configurations — glm4-9b
    # (serving with phase 6's traffic, block prefill against token-wise
    # decode, training cut to 8 layers), command-r-35b (serving its 60.6 GB
    # as configured, training cut to 2 layers), granite-moe-1b-a400m
    # (serving, training on both MoE routes)
    t27 = time.perf_counter()
    for phase in (glm4_phase, command_r_phase, granite1b_phase):
        rec = phase(torch, ops, ref, engine, devs)
        families[rec["arch"]] = rec
    log(f"new phases (27, 28, 29): {time.perf_counter() - t27:.1f} s")
    family_runs = {f"{name} {what}": rec[key]
                   for name, rec in families.items()
                   for key, what in (("run", "train"),
                                     ("scatter_run", "train, scatter route"))
                   if key in rec}
    for name in FIT_KERNELS:
        launches[name] += phase21["launches"][name]
    for inst, n in phase21["instances"]["round"].items():
        round_instances[inst] += n
    for inst, n in phase21["instances"]["two_pass"].items():
        two_pass_instances["csvm_block_update"][inst] += n
    mamba_launches = mamba_training["run"]["launches"]
    launches["ssd_scan"] += mamba_launches["ssd_scan"]
    launches["ssd_scan_backward"] = mamba_launches["ssd_scan_backward"]
    train_launches = training["run"]["launches"]
    launches["flash_attention_backward"] = \
        train_launches["flash_attention_backward"] \
        + phase19["launches"]["flash_attention_backward"]
    launches["flash_attention"] += train_launches["flash_attention"] \
        + phase19["launches"]["flash_attention"] \
        + phase22["train"]["launches"]["flash_attention"]
    launches["flash_attention_backward"] += \
        phase22["train"]["launches"]["flash_attention_backward"] \
        + rg_launches["flash_attention_backward"]
    launches["flash_attention"] += rg_launches["flash_attention"]
    for run in family_runs.values():
        for name in ("flash_attention", "flash_attention_backward"):
            launches[name] += run["launches"][name]
    for h in heads.values():
        launches["flash_attention"] += h["flash_launches"]
        for name in FIT_KERNELS:
            launches[name] += h["fit_launches"][name]
        for inst, n in h["round_instances"].items():
            round_instances[inst] += n
        for name, by in h["two_pass_instances"].items():
            for inst, n in by.items():
                two_pass_instances[name][inst] += n
    for srv in (g_served, r_served, v_served):
        launches["flash_attention"] += srv["launches"]["flash_attention"]
    for rec in families.values():
        if "served" in rec:
            launches["flash_attention"] += rec["served"]["serve"]["launches"]
    launches["flash_attention"] += v_media["launches"] + sum(
        run["launches"] for run in encdec["runs"])
    log(f"new phases (7b, 11, 12): {new_phase_s:.1f} s; head launches "
        f"{json.dumps({k: h['fit_launches'] for k, h in heads.items()})}")

    flash_tol = {"float32": FLASH_TOL_F32,
                 "bfloat16": "2^-7 |o_plain| + 1e-6 (one bf16 ulp)"}
    ssd_tol = {"float32": f"y {SSD_TOL_F32:g}",
               "bfloat16": "y 2^-7 |y_plain| + 1e-6 (one bf16 ulp)",
               "state": f"{SSD_TOL_F32:g} (1 + |s_plain|)"}
    kernels = []
    for name in ops.KERNELS:
        dev = max(devs[name].values())
        row = dict(rows[name])
        extra = {}
        if name == "flash_attention":
            tol = flash_tol
            extra = dict(serve=dict(
                prefill_ms=served["prefill_ms"],
                decode_ms_median=float(np.median(steps)),
                decode_bound_ms=decode_bound, wall_s=served["wall_s"]),
                model_kernel_vs_plain={
                    dt: dict(max_abs_dev=d, max_abs_logit=m,
                             **model_limits.get(
                                 dt, dict(tol=MODEL_TOL[dt.split()[0]])))
                    for dt, (d, m) in model_devs.items()},
                serve_instances=served["flash_instances"],
                instances=forward_instances,
                sass={f"flash_tc_kernel<{D}>": dict(HGMMA=h, UTMALDG=u)
                      for D, (h, u) in sass.items()},
                launches_by_path={
                    "serve qwen3-14b": served["launches"]["flash_attention"],
                    **{f"head features {k}": h["flash_launches"]
                       for k, h in heads.items()},
                    "serve granite-moe-3b-a800m":
                        g_served["launches"]["flash_attention"],
                    "serve recurrentgemma-2b":
                        r_served["launches"]["flash_attention"],
                    "serve internvl2-1b":
                        v_served["launches"]["flash_attention"],
                    "forward internvl2-1b media prefix":
                        v_media["launches"],
                    f"train_loop {TRAIN_ARCH} ({TRAIN_LAYERS} layers, "
                    f"{TRAIN_STEPS} steps: pass + remat)":
                        train_launches["flash_attention"],
                    **{f"train step {TRAIN_ARCH} remat {policy}":
                       sum(rec["flash"].values())
                       for policy, rec in
                       phase19["remat"]["policies"].items()},
                    f"sharded train step {SHARD_ARCH} ({SHARD_LAYERS} "
                    f"layers, mesh {SHARD_MESH}), all ranks": sum(
                        sum(r["flash"].values())
                        for r in phase19["sharded"]["ranks"]),
                    f"phase 22: {TRAIN_ARCH}'s step once against its dry "
                    "run": phase22["train"]["launches"]["flash_attention"],
                    f"train_loop {RG_TRAIN_ARCH} ({FAMILY_TRAIN_STEPS} "
                    "steps: pass + remat)": rg_launches["flash_attention"],
                    **{f"serve {name}": rec["served"]["serve"]["launches"]
                       for name, rec in families.items()
                       if "served" in rec},
                    **{f"seamless-m4t-large-v2 {path} (B={run['B']}, "
                       f"S={run['S']})": n
                       for run in encdec["runs"]
                       for path, n in run["launches_by_path"].items()},
                    **{f"{what} ({len(run['steps'])} steps: pass + remat) "
                       f"{path}": n
                       for what, run in family_runs.items()
                       for path, n in run["launches_by_path"].items()}},
                train_shapes={name: rec["kernels"]["forward"]
                              for name, rec in families.items()},
                serve_new_models={
                    srv_name: dict(prefill_ms=srv["prefill_ms"],
                                   decode_ms_median=float(np.median(
                                       [ms for _, ms in srv["decode_ms"]])),
                                   wall_s=srv["wall_s"],
                                   instances=srv["flash_instances"])
                    for srv_name, srv in (("granite-moe-3b-a800m", g_served),
                                          ("recurrentgemma-2b", r_served),
                                          ("internvl2-1b", v_served))},
                vlm_media_forward=v_media,
                encdec={key: encdec[key] for key in ("runs", "tokenwise")},
                head_features={k: {key: h[key] for key in (
                    "extract_s", "trunk_flops", "extract_tflops", "shape",
                    "features_kernel_vs_plain")
                    if key in h} for k, h in heads.items()},
                moe_routes=moe_routes, rglru=lru,
                tokenwise={"granite-moe-3b-a800m": g_tokenwise,
                           "recurrentgemma-2b": rg_tokenwise})
        elif name == "flash_attention_backward":
            tol = {"float32": f"{BACKWARD_TOL_F32:g} max|grad|",
                   "bfloat16": f"2^-7 |grad_plain| + {BACKWARD_TOL_F32:g} "
                               "max|grad_plain| (one bf16 ulp)"}
            run = training["run"]
            extra = dict(
                checks=training["readings"],
                instance_launches=run["backward_instances"],
                instances=backward_instances, sass=backward_sass,
                train_step_vs_plain=training["step_check"],
                train_loop={k: run[k] for k in (
                    "median_step_ms", "fwd_bwd_ms", "opt_ms", "tokens_per_s",
                    "peak_bytes", "wall_s", "flash_instances",
                    "backward_instances", "steps")},
                checkpoint_resume=training["resume"],
                phase_s=training["seconds"],
                remat_policies=phase19["remat"],
                sharded_train_step=phase19["sharded"],
                phase_19_s=phase19["seconds"],
                train_recurrentgemma={
                    "train_step_vs_plain": phase23["step_check"],
                    "train_loop": {k: phase23["run"][k] for k in (
                        "median_step_ms", "fwd_bwd_ms", "opt_ms",
                        "tokens_per_s", "peak_bytes", "held_before_bytes",
                        "wall_s", "flash_instances", "backward_instances",
                        "steps")},
                    "launches": rg_launches,
                    "checkpoint_resume": phase23["resume"],
                    "phase_s": phase23["seconds"]},
                train_families={
                    name: {**{k: rec[k] for k in (
                        "card", "batch", "seq", "dry", "step_check",
                        "losses", "resume", "route_split", "seconds",
                        "served", "phase_seconds")
                        if k in rec},
                        "scatter": rec.get("scatter"),
                        "checks": rec["kernels"]["backward"],
                        "timing": rec["kernels"].get("backward_timing"),
                        **{key: {k: rec[key][k] for k in (
                            "median_step_ms", "fwd_bwd_ms", "opt_ms",
                            "tokens_per_s", "peak_bytes",
                            "held_before_bytes", "wall_s", "launches",
                            "launches_by_path", "flash_instances",
                            "backward_instances", "steps") if k in rec[key]}
                           for key in ("run", "scatter_run") if key in rec}}
                    for name, rec in families.items()})
        elif name == "ssd_scan_backward":
            tol = {"float32": {k: f"{v:g} max|grad|"
                               for k, v in SSD_BACKWARD_TOL.items()},
                   "bfloat16": "dx, dB, dC: 2^-7 |grad_plain| + the fp32 "
                               "limit max|grad_plain| (one bf16 ulp); ddt, "
                               "dA, dD: the fp32 limits"}
            run = mamba_training["run"]
            extra = dict(
                checks=mamba_training["readings"],
                instance_launches=run["ssd_backward_instances"],
                instances=ssd_backward["instances"], sass=ssd_backward_sass,
                train_step_vs_plain=mamba_training["step_check"],
                train_step_fp32_full_depth=ssd_backward["depth"],
                train_step_split={
                    inst: {k: v for k, v in sp.items() if k != "split"}
                    for inst, sp in ssd_backward["splits"].items()},
                train_loop={k: run[k] for k in (
                    "median_step_ms", "fwd_bwd_ms", "opt_ms", "tokens_per_s",
                    "peak_bytes", "wall_s", "ssd_instances",
                    "ssd_backward_instances", "steps")},
                checkpoint_resume=mamba_training["resume"],
                phase_s=mamba_training["seconds"],
                phase_18_s=ssd_backward["seconds"])
        elif name == "ssd_scan":
            tol = ssd_tol
            extra = dict(serve=dict(
                prefill_ms=m_served["prefill_ms"],
                decode_ms_median=float(np.median(m_steps)),
                decode_bound_ms=m_decode_bound, wall_s=m_served["wall_s"]),
                model_kernel_vs_plain={
                    dt: dict(max_abs_dev=d, max_abs_logit=m,
                             max_abs_state_dev=sd, tol=MAMBA_TOL[dt])
                    for dt, (d, m, sd) in mamba_devs.items()},
                serve_instances=m_served["ssd_instances"],
                model_instances_bf16=model_instances, sass=ssd_sass,
                launches_by_path={
                    "serve mamba2-370m": m_served["launches"]["ssd_scan"],
                    f"train_loop {MAMBA_TRAIN_ARCH} ({TRAIN_STEPS} steps: "
                    "pass + remat)": mamba_launches["ssd_scan"]},
                train_shape=families[configs.get(VLM_TRAIN_ARCH).name][
                    "ssd_train"])
        else:
            tol = {dt: TOL[dt] for dt in devs[name]}
            row["library_ms"] = None
            stream_kernel = ("round_stream_kernel"
                             if name == "csvm_round_block"
                             else "update_stream_kernel")
            extra = dict(
                instance_launches=(round_instances
                                   if name == "csvm_round_block"
                                   else two_pass_instances[name]),
                sass={k: dict(UBLKCP=b, UTMALDG=u)
                      for k, (b, u) in bulk.items()
                      if k.startswith(stream_kernel)})
            if name == "csvm_round_block":
                extra["lambda_path"] = {
                    k: lpath[k] for k in ("times", "warm_iters",
                                          "warm_bf16_iters", "lla_launches")}
            if name != "csvm_local_update":
                extra["fit_serving"] = fitserve["times"]
                extra["fit_serving_ranks"] = {k: phase21[k] for k in (
                    "buckets", "ranks", "backend", "cards", "grid",
                    "spawn_s", "reference_s", "seconds")}
            if name != "csvm_round_block":
                extra["ranks"] = {k: v for k, v in ranks["cases"].items()
                                  if v["kernel"] == name}
            extra["head"] = {f"{model_name} {what}": fit
                             for model_name, h in heads.items()
                             for what, fit in h["fits"].items()
                             if fit["kernel"] == name}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=dev, max_abs_dev=dev,
            max_abs_dev_by_dtype=devs[name], tol=tol, **row, **extra))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the start "
        "of main to the kernels line (the build included)")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
