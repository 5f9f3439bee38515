#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises (and so
exits nonzero, with no result line) when a check fails:

  1. device  — the card's name, count and power limit; TF32 off
  2. build   — nvcc builds the six CUDA sources from the checkout,
               all at once; ptxas register/spill lines, seconds
  3. kernels — each kernel against its plain PyTorch version on the card,
               f32 and bf16, at the main-path shapes and ragged ones, at
               STREAM_PARITY_TOL["kernel_vs_ref"] (2e-4 rtol and atol);
               the A-optimality kernels on genuine operands (a state's
               shared solve W = M⁻¹X and expand_factors' Woodbury factors);
               the logistic kernels on genuine logits (refit states and
               expand_logits' perturbed states), each error measured
               against the plain version in float64 beside the f32 plain
               version's, under rtol 2e-4 and atol 2e-4 + ε_f32·√d·ℓ_abs;
               both logistic kernels (6 and 7, one template) also bitwise
               equal in two calls, their cluster plans logged, and past
               their on-chip capacity (d = 100,000); the regression
               kernels 1 and 3 bitwise equal in two calls, kernel 3's
               stacked basis width, split of d and copy width logged;
               kernel 5 also at b = 128 (two chunks of 64 columns) and
               bitwise equal in two calls, its plan logged; kernels 3, 5
               and 7 also at FAST's prefix shapes (a sequence's 129
               insertion prefixes of b = 128 columns, the prefix masks
               arange(b) < arange(b + 1)[:, None], ragged slot_ok on the
               small cases), kernel 3's stacked width, split and
               workspace bytes and kernel 5's plan and scratch bytes
               logged
  4. main    — the port's quickstart (greedy, DASH over 6 OPT guesses
               × 8 samples, TOP-K, RANDOM) on the paper's D1 protocol at
               d = n = 8192, k = 128, with the kernels' launch counters
               set to 0 just before and read just after
     registry main — ``repro_torch.bench_selection``'s main suite: lazy
               and stochastic greedy, FAST (binary search, 3 probes),
               adaptive sequencing and TOP-K through ``select()``, and
               LASSO, on the same D1; counters set to 0 just before each
               selector and read just after; values in [0, 1], each
               new selector above RANDOM, FAST within its round cap,
               FAST and adaptive sequencing launching kernel 3, lazy and
               stochastic greedy kernel 1
  5. parity  — greedy and DASH on the small D1 (600 × 200, k = 40), card
               against the CPU plain path, DASH noise drawn on the CPU
  6. design main — the port's A-optimal design entry point (greedy, DASH
               over 6 OPT guesses × 2 α × 8 samples, TOP-K, RANDOM) on
               the paper's D1 design protocol at d = 1024, n = 65536,
               k = 128, launch counters set to 0 before and read after
  7. design parity — greedy and DASH on the small design (128 × 512,
               k = 32), card against the CPU plain path
  8. classification main — the port's classification entry point
               (greedy, DASH over 6 OPT guesses × 8 samples, TOP-K,
               RANDOM) on the paper's D3 protocol at d = n = 8192,
               support 256, k = 128, launch counters set to 0 before and
               read after
  9. classification parity — greedy and DASH on the small D3 (600 × 200,
               support 50, k = 20), card against the CPU plain path
     registry design, class — FAST and adaptive sequencing through
               ``select()`` on the design and classification mains'
               objectives (kernel 5 at b = 128 over 129 prefixes, kernel
               7 over 129 states), counters zeroed per run
     registry parity — lazy and stochastic greedy, FAST and adaptive
               sequencing on the small D1, design and D3, card against
               the CPU plain path, noise drawn on the CPU
 10. lm kernels — flash attention (kernel 8) against its plain version,
               f32 and bf16, at rtol = atol = 2e-5 (f32) and 2e-2 (bf16),
               the JAX test's, and in bf16 also per row against the
               output's scale in float64 (FLASH_BF16_REL, beside the
               plain version's reading and two planted faults', which
               must exceed it): danube's heads at S 8192 with window 4096,
               the JAX test's sweep, ragged S, softcap 30 without the
               causal mask, q_offset, D 16/32/64/80/128, and D 256 at
               recurrentgemma's heads (S 8192, window 2048; ragged Sq and
               Skv with a q_offset; softcap), whisper's encoder and
               cross-attention (non-causal; Sq 1500, 384 and 1 against
               1500 frames) and internvl2's prefill (GQA 16/8, D 128,
               S 7936); an f32 case that
               misses against the f32 plain version is gated against the
               plain version in float64, both errors printed (run with
               the kernel phases, before the main phase)
 11. lm main — the port's serve_lm entry point: h2o-danube-1.8b at full
               width, bf16, random weights (seed 0), batch 4, prompt
               8192, 32 new tokens, greedy then top-k 40 at T 0.8;
               prefill s, decode s per token, tokens/s, peak memory; the
               flash launch counter set to 0 before and read after
               (exactly 24 per prefill); first tokens checked against a
               fresh prefill and decode step
 12. lm consistency — full width: prefill 5999 tokens (ring caches),
               decode one, against prefilling all 6000 (LM_CONSIST_TOL);
               two planted faults must exceed the limit
 13. lm parity — the reduced danube (f32) on the card against the CPU:
               identical greedy tokens, logits within LM_PARITY_TOL
 slice 6 — after lm parity, against the objectives of the main phases:
     r2 main — R2Objective on the main D1: greedy and DASH (6 guesses ×
               8 samples); values in [0, 1], brute_r2 of DASH's set within
               1e-3 of its value, and DASH's set, value bits and rounds
               those of RegressionObjective(*standardize(X, y))
     per-sample — the filter statistic through use_filter_engine False
               (one gains(add_set(...)) per sample) against the engine at
               the regression, design and classification lattices: the
               reading beside a planted fault's (one sample's
               leave-one-out weight dropped), gated between them
               (PER_SAMPLE_GATE); both paths' host seconds and launches
     design diversified — DASH on f_A-opt + cluster diversity (4 PC sign
               clusters, weight 0.2) at the design main: at least RANDOM,
               value = base + d(S), kernel 5 never launched; then
               DiversityObjective alone (n = 65536, 64 clusters): lazy
               greedy = greedy pick for pick
     coreset — h2o-danube-1.8b at full width (the lm main's weights):
               grad features of 4096 × 128 tokens in batches of 64
               (kernel 8 in every layer), projected to 64 dims, DASH for
               k = 256 (OPT = 1.25 × TOP-K, 4 samples): k distinct rows,
               none in the padding, at least RANDOM
     resilience — dash_checkpointed on the main D1: stepped = fused,
               killed at round ⌊r/2⌋ inside run_with_restart and resumed
               = uninterrupted, async = blocking saves (bit for bit), an
               expired Deadline raises with its carry; snapshot bytes and
               save seconds
     sharded — slice 7, the sharded runtime through select(..., mesh=)
               on spawned ranks of a (pod 1, data 1, model W) mesh:
               world 1 through NCCL and world 2 through gloo (both ranks
               on the card, n_local = n / 2): DASH on the regression,
               design and classification mains at full width (6 OPT
               guesses × m = 8; the design's 12 lanes), greedy on the
               main D1 at world 1; per run and rank host s, rounds,
               value, launches (each objective's two kernels > 0 on every
               rank, counters zeroed per run), values in range and above
               RANDOM; world 1 against world 2 under the bits rule (the
               same set, or the first parted filter decision's margin to
               its threshold within the two runs' statistic difference,
               printed); on the small D1, design and D3, world 1 on the
               card against world 1 on the CPU (gloo, plain versions)
               under the same rule, noise drawn on the host; TOP-K,
               RANDOM, stochastic greedy and FAST (OPT pinned) twins at
               world 2 on the small inputs = the single-device port on
               the card; a world-2 snapshot (the small D1, killed at
               round 2) resumed at world 1 = the uninterrupted world-2
               run.  The card's ranks run the small inputs first (they
               warm the process up); the CPU rank runs beside them
     serve   — slice 8, the selection service: one SelectionServer on
               the card, tenants the main D1 and the design main, queue
               caps 8/16/32, the default ServePolicy; load: 4 deadline
               requests (k = 64, 5 s, the example's seeded latency model:
               served at topk, degraded), 20 DASH on D1 (4 shed, two
               8-lane buckets), 8 DASH on the design (pinned at the
               design main's winning guess), 4 stochastic greedy; one
               terminal reply each, no FAILED, retry hints, values in
               range, DASH at least RANDOM, kernels 1, 3 on D1 and 4, 5
               on the design (counters zeroed per launch); every DASH
               bucket = select_batched bit for bit; the load under
               FailureInjector(fail_at=(1,)): hedged sets = the calm
               run's; lane 0 alone vs its 8-lane bucket under the bits
               rule; a warm update of 64 columns = a fresh server, no
               runner built, the OPT probe recomputed; the small D1 and
               design, card against CPU (host noise); per launch tier,
               lanes, rounds, attempts, host s; requests/s, reply
               latency p50/p99, each tier's EWMA, the phase's seconds
     moe     — slice 9: grok-1-314b (4 of 64 layers) and
               llama4-maverick-400b-a17b (1 of 48) at published width,
               bf16, through serve_lm (batch 4, prompt 2048, 32 tokens,
               greedy then top-k), one model at a time: flash launches =
               layers × prefills, the greedy and top-k checks, layer 0's
               routed, kept and dropped assignments per expert against
               the capacity, a finite aux loss, layer 0's bf16 moe_apply
               against the MoE formula in f32 on tokens that overflow an
               expert (MOE_GATE, beside two planted faults); prefill s,
               decode s per token, peak memory
     hybrid  — recurrentgemma-2b whole at published width, bf16, through
               serve_lm (batch 4, prompt 8192, 32 tokens): 8 flash
               launches per prefill (kernel 8 at head_dim 256), the
               greedy and top-k checks, prefill S − 1 then decode against
               prefill S (HYBRID_CONSIST_TOL, three planted faults), the
               log-depth scan against a float64 recurrence (SCAN_GATE,
               one planted fault)
 slice 10 — after hybrid, one model at a time, at published width, bf16,
     random weights (seed 0), through serve_lm (greedy then top-k 40,
     batch 4, 32 new tokens; the greedy and top-k checks on the whole
     batch; prefill S − 1 then one decode step against prefill S in f32
     on the served weights cast, gated between the sound reading and
     planted faults (SLICE10_CONSIST, SLICE10_FAULTS), the bf16 reading
     logged; the reduced arch in f32 on the card against the CPU; one
     prefill and 4 decode steps profiled):
     xlstm   — xlstm-125m whole (9 mlstm, 3 slstm layers), prompt 2048
               (the sLSTM's host loop over time makes 8192 too slow):
               no kernel 8 launch; the host seconds of one layer's mLSTM
               chunk loop and sLSTM time loop; the profile on the first
               256 tokens
     whisper — whisper-base whole (6 encoder, 6 decoder layers), 1500
               frames, decoder prompt 384: kernel 8 exactly 18 times a
               prefill (6 encoder, 6 causal self, 6 cross; read by a spy
               on the wrapper's callers) and 6 times a decode step
     vlm     — internvl2-2b whole (24 layers), 256 image tokens + prompt
               7680: kernel 8 exactly 24 times a prefill, at S 7936
 slice 11 — after vlm:
     train   — smollm-135m at published width and all 30 layers, bf16
               parameters with an f32 master, remat on, trained through
               train_loop with the reference CLI's selection defaults
               (DASH on grad features, embed_dim_cap 32, 4 samples,
               selection every 2 steps from pools 4 x the period's
               examples; batch 8 x 2048 tokens of make_lm_tokens; 8
               steps, warmup 2), then again killed at step 5 (inside a
               period) and resumed from checkpoints under build/: losses
               finite and falling, kernel 8 once per layer per feature
               chunk, kernel 4 launched, the resumed run's losses and
               selections equal the uninterrupted run's bit for bit;
               step seconds, tokens/s, peak memory, selection seconds,
               kernel 5's launches, one profiled step's busy share
     train parity — one f32 step of smollm-135m at full width, 2 layers,
               batch 2 x 512, card against the CPU port from the same
               state: loss, grad norm, the largest parameter change and
               m, each gated between its sound reading and a planted
               fault's (TRAIN_PARITY_TOL)
 slice 12 — after train parity:
     train sharded — train's recipe for 4 steps through
               train_loop(mesh=) on spawned ranks: world 2 (gloo, both
               ranks on the card, mesh (data 2, model 1)) uninterrupted
               and killed at step 3 with checkpoints under build/, then
               world 1 (NCCL) uninterrupted and resuming world 2's
               checkpoint for the last step; world 2's losses against
               world 1's (SHARDED_LOSS_TOL, beside a planted fault's
               reading), period 0's selected ids equal, the killed run
               equal to the uninterrupted one bit for bit, kernel 8 once
               per layer per feature chunk on each rank, kernel 4 on each
               rank; per rank step seconds, tokens/s, all-reduce seconds,
               selection seconds, peak memory
     engine  — h2o-danube-1.8b whole (the lm main's weights) behind
               ServeEngine(max_batch 4, max_seq 8192): 8 requests of
               seed-0 prompt lengths in [512, 6000] (past the 4096
               window: ring caches), 32 new tokens each; each request's
               tokens against its solo greedy decode (a difference only
               at a top-two margin below ENGINE_MARGIN_GATE), kernel 8
               24 times per admitted request; requests/s, tokens/s,
               decode seconds per engine step
 slice 13 — after engine:
     train zero1 — train's model and batch (no selection) for 3 steps
               through make_train_step(mesh=, grad_specs=zero1_specs(...))
               on spawned ranks, world 2 (gloo, both ranks on the card:
               smollm's stacks over data, 15 layers' optimizer state a
               rank) and world 1 (NCCL), beside the replicated step on
               the same rows: losses and grad norms under [train
               sharded]'s gates, the gathered state's norms
               (ZERO1_STATE_TOL), each rank's optimizer bytes = its
               placements' share, a planted unsummed gradient above the
               gates; step, reduce-scatter and all-gather seconds, each
               step's peak; in its world-2 spawn slice 14's [train tp]
               and [serve tp] on a (data 1, model 2) mesh (TRAIN_TP,
               SERVE_TP)
     dryrun  — repro_torch.launch.dryrun on meta tensors (no card): every
               runnable cell at 16×16 and 2×16×16, in a pool of nice-19
               processes that runs beside [registry parity], which times
               nothing, and is waited for before [lm], the next timed
               phase; each record's line in print_record's format (the
               records whole in build/dryrun_records.json), no error
               record; train's recipe (8 × 2048) at mesh 1×1 and data 2
               against [train zero1]'s real steps: held bytes and
               collective bytes by kind equal, the peak reckoning within
               DRYRUN_PEAK_GATE of a real step's peak, the no-remat
               reckoning outside it
 14. timing  — CUDA-event times per call of each kernel, its plain
               version and a library call, beside the kernel's bound
               from its shapes and the H100 SXM peaks (kernel 8 at the lm
               main prefill shape, SDPA with the same mask as its
               yardstick); kernel 3's workspace bytes, registers, spills
               and shared memory per CTA; kernel 5 at b = 128; kernels
               3, 5 and 7 at FAST's prefix shapes (bounds counting the
               prefixes' nonzero columns), beside the MGS deltas of the
               129 prefixes; kernels 4 and 5 at the coreset's shape; the
               six selection kernels at a world-2 shard's shapes
               ([sharded]: n_local = n / 2 of each main lattice; kernels
               1, 3 and 5 beside their cuBLAS products); kernels 1, 3, 4
               and 5 at [serve]'s 8-lane bucket shapes; kernel 8 at
               head_dim 256 at [hybrid]'s prefill shape, and at whisper's
               encoder, cross-attention (prefill and decode) and
               internvl2's prefill shapes; kernel 8 at the train
               features' chunk (B 8, S 2048, smollm's heads) and kernel 4
               at the train selection's shape (d 32, n 64); kernel 8 at
               [engine]'s B 1 prefills (one per prompt length, SDPA
               beside each)
 15. profile — greedy and DASH of the main phase, DASH of the design
               main phase, greedy and DASH of the classification main
               phase, 8 rounds of the registry main's FAST, one lm prefill and four
               lm decode steps, once more under torch.profiler tracing
               the device alone: device busy time by kernel and the
               device's busy share of the host wall time ([moe] and
               [hybrid] profile one prefill
               and four decode steps of their own runs the same way,
               before they free their weights)

The last three lines of output: the kernels JSON, the card's name and
power limit as nvidia-smi prints them, and the result JSON.  Imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import atexit
import copy
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks: non-tensor f32 FMA rate and HBM3 bandwidth.
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# Transcendentals (exp, log, reciprocal) on the special-function units:
# 16 per SM per clock (Hopper white paper) × 132 SMs × 1.98 GHz, the clock
# of the 67 TFLOP/s f32 peak.
SFU_OPS_PER_S = 16 * 132 * 1.98e9

MAIN = dict(d=8192, n=8192, k=128, support=256, n_guesses=6, n_samples=8)
# DashConfig.resolve at n = 8192, k = 128: r = 13 rounds, block b = 10.
MAIN_BLOCK = 10

# The A-optimal design path: D1 design protocol, 6 OPT guesses × the
# α lattice {0.3, 1} of repro_torch.experimental_design (12 lanes).
DESIGN = dict(d=1024, n=65536, k=128, n_guesses=6, n_samples=8)
DESIGN_LANES = 12
# DashConfig.resolve at n = 65536, k = 128: r = 16 rounds, block b = 8.
DESIGN_BLOCK = 8

# The classification path: D3 protocol at the regression main's width
# and support, DASH of benchmarks/bench_selection.py (6 OPT guesses,
# eps 0.25, α 0.6, 8 samples); r = 13 rounds, block b = 10.
CLASS = dict(d=8192, n=8192, k=128, support=256, n_guesses=6, n_samples=8)
CLASS_BLOCK = 10

# FAST's binary search over its default 8 OPT guesses: ⌈log2 8⌉ probes.
FAST_PROBES = 3
# FAST's prefix sweep at k = 128: L = 128 columns, L + 1 = 129 prefixes.
FAST_L = 128
# Rounds of FAST the profile phase traces: the MGS deltas of the 129
# prefixes alone take 128 column steps of several operations a round,
# and the profiler's trace of one whole probe did not finish within the
# script's time limit.
FAST_PROFILE_ROUNDS = 8

# The LM serving path: h2o-danube-1.8b at full width (24 layers, d_model
# 2560, 32 query and 8 KV heads of 80, window 4096, bf16) through
# repro_torch.serve_lm: batch 4, prompt 8192 (longer than the window:
# ring caches, window mask live), 32 new tokens (within prefill's 64 of
# headroom), greedy and top-k 40 at T 0.8.
LM = dict(arch="h2o-danube-1.8b", batch=4, prompt_len=8192, new_tokens=32)
LM_LAYERS = 24
LM_HEADS = dict(h=32, hkv=8, d=80, window=4096)
# Prefill S − 1, decode one, against prefill S: S > 4096, so ring caches.
LM_CONSIST_S = 6000
# bf16 logits of order 1 (rms 1, largest about 4.5: bf16 ulp 2^-5 there):
# the two paths round each of 24 layers' activations at other points
# (GEMMs at M = 1 against M = S, one-pass softmax against the online
# recurrence), and a stack of random layers amplifies those differences
# (0.0859 measured at S = 6000 on the H100, PERF.md).  Two planted faults
# on copies of the same cache are read beside it and must land above the
# limit: decoding at position S − 2 instead of S − 1 (1.33 measured), and
# one 64-slot block of every layer's cache zeroed (0.734).  The limit is
# the geometric mean of the sound reading and the weaker fault's, a
# factor 2.9 from each.
LM_CONSIST_TOL = 0.25
# The cache slots a planted fault zeroes in every layer.
LM_FAULT_SLOTS = (2048, 2112)
# f32 reduced danube, card against CPU: another summation order in
# every GEMM and reduction (d_model 64, two layers, logits of order 1).
LM_PARITY_TOL = 1e-4
# Flash kernel against its plain version: the JAX test's tolerance.
FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}
# ... and, in bf16, against the output's own scale.  The JAX test's 2e-2
# was set at short S, where outputs are O(0.1-1); at danube's S 8192 with
# window 4096 a late row's softmax spreads over about 1500 keys and its
# |out| is a few hundredths, so 2e-2 would pass a kernel 10 % off there,
# while the first rows see a few keys and |out| reaches 3.  So each bf16
# case is measured against the plain version in float64 row by row: the
# largest max_d |err| / rms_d(out) over the (b, q, h) rows, gated at
# FLASH_BF16_REL.  Two planted faults (the kernel's output scaled by 0.9;
# one 64-key block inside every row's band dropped) are measured the
# same way and must land above the gate, or the phase fails as blind.
# Readings on the H100 (PERF.md): kernel at most 0.0174, the bf16 plain
# version at most 0.0456, the weaker fault at least 0.253; the gate is
# about their geometric mean, twice the plain version's worst.
FLASH_BF16_REL = 0.1
# The keys a planted fault drops: 64, half of the bf16 kernel's 128-key
# block at head_dim 80, so the fault is smaller than one block.
FLASH_FAULT_BLOCK = 64
# H100 SXM dense bf16 tensor-core peak.
BF16_TC_FLOPS = 989e12

# Kernel 8's checks: (B, Sq, Skv, H, Hkv, D, causal, window, softcap,
# q_offset) — danube's prefill heads at S 8192, the JAX test's sweep
# (tests/test_kernels.py), ragged S, softcap 30 without the causal mask,
# decode-shaped q_offset, D 64/80/128, the reduced configs' D 16,
# recurrentgemma's D 256, and slice 10's whisper and internvl2 shapes.
LM_FLASH_CASES = (
    [(1, 8192, 8192, 32, 8, 80, True, 4096, 0.0, 0)]
    + [(2, sq, skv, h, hkv, d, c, w, cap, 0)
       for (sq, skv, h, hkv, d) in ((128, 128, 4, 4, 32),
                                    (130, 200, 4, 2, 32),
                                    (64, 256, 8, 1, 64))
       for (c, w, cap) in ((True, 0, 0.0), (True, 48, 0.0),
                           (False, 0, 0.0), (True, 0, 20.0))]
    + [(2, 1000, 1537, 8, 2, 80, True, 0, 0.0, 0),
       (2, 1000, 1537, 8, 2, 80, False, 0, 30.0, 0),
       (1, 1, 100, 4, 2, 80, True, 0, 0.0, 99),
       (1, 1, 100, 4, 2, 32, True, 0, 0.0, 99)]
    + [(2, 513, 513, 8, 2, d, True, 256, 0.0, 0) for d in (64, 80, 128)]
    + [(2, 48, 48, 4, 2, 16, True, 32, 0.0, 0)]
    # head_dim 256: recurrentgemma's heads at S 8192 with window 2048,
    # ragged Sq and Skv with a q_offset (with and without a window), and
    # softcap without the causal mask
    + [(1, 8192, 8192, 10, 1, 256, True, 2048, 0.0, 0),
       (2, 1000, 1537, 10, 1, 256, True, 300, 0.0, 537),
       (2, 1000, 1537, 10, 1, 256, True, 0, 0.0, 537),
       (2, 513, 700, 4, 2, 256, False, 0, 30.0, 0)]
    # slice 10: whisper's encoder (non-causal, S 1500), its cross-attention
    # in the prefill (Sq 384) and at a decode step (Sq 1) against the 1500
    # encoder frames; internvl2's prefill (GQA 16/8, D 128, 256 image + 7680
    # text tokens)
    + [(4, 1500, 1500, 8, 8, 64, False, 0, 0.0, 0),
       (4, 384, 1500, 8, 8, 64, False, 0, 0.0, 0),
       (4, 1, 1500, 8, 8, 64, False, 0, 0.0, 0),
       (1, 7936, 7936, 16, 8, 128, True, 0, 0.0, 0)]
    # slice 11: the train features' chunk (smollm's heads, 8 rows of
    # 2048 tokens, causal)
    + [(8, 2048, 2048, 9, 3, 64, True, 0, 0.0, 0)]
)

# [r2 main]: DASH's R² value against Def. 14 of its set solved in
# float64.  Readings on the H100 80GB HBM3 at 700 W: sound 1.225e-08, a
# planted fault (the set less one member) 1.374e-03; the gate sits a
# factor of 816 above the first and 137 below the second.
R2_GATE = 1e-5
# Slice 6's paths.  The per-sample filter path is read against the engine
# at the three lattices; the sound reading and a planted fault's (one
# sample's leave-one-out weight dropped) are logged, and the gate lies
# between them (PERF.md §6).  Readings on the H100 80GB HBM3 at 700 W:
# sound at most 1.788e-06 (regression; design 1.148e-06, classification
# 2.681e-07), the fault at least 7.045e-03 (classification; regression
# 9.728e-03, design 1.241e-01); the gate is about their geometric mean,
# a factor of 56 above the first and 70 below the second.
PER_SAMPLE_GATE = 1e-4
# DiversityObjective alone at the design main's n with 64 clusters.
DIV_CLUSTERS = 64
# Coreset selection on the LM main's model: 4096 sequences of 128 tokens
# in batches of 64, grad features projected to 64 dims, k = 256 by DASH
# with the reference BatchSelector's recipe (OPT = 1.25 × TOP-K's value,
# 4 samples).  DashConfig.resolve at n = 4096, k = 256: r = 12 rounds,
# block b = 22.  The random weights give near-isotropic unit features, so
# at that OPT no round filters; a second DASH, with OPT pinned at the
# value's supremum d·β² (no k-set reaches it) and α = 1, filters in its
# last round, through kernel 5 at the coreset's lattice.
CORESET = dict(pool=4096, seq=128, batch=64, dim_cap=64, k=256,
               n_samples=4, opt_margin=1.25, pinned_alpha=1.0)
CORESET_BLOCK = 22

REPLACES = {
    "regression_gains": "src/repro/kernels/marginal_gains/kernel.py:62",
    "filter_gains": "src/repro/kernels/filter_gains/kernel.py:86",
    "aopt_gains": "src/repro/kernels/aopt_gains/kernel.py:34",
    "aopt_filter_gains": "src/repro/kernels/filter_gains/kernel_aopt.py:74",
    "logistic_gains": "src/repro/kernels/logistic_gains/kernel.py:58",
    "logistic_filter_gains":
        "src/repro/kernels/filter_gains/kernel_logistic.py:55",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:88",
}
# Hand-written device kernels per counted wrapper call: the regression
# singleton sweep is a split-d partial pass plus its fixed-order epilogue;
# the regression filter engine is the same partial pass over one stacked
# basis of the G guess bases and the G*m states plus its own epilogue
# (after PyTorch copies that pack the basis); the A-optimality engine is
# one launch over the G*m states (after copies that pack its factors); the
# logistic singleton sweep and the logistic engine (one kernel template,
# at 1 and at several states per pass) make their old log-likelihood
# terms inside their one launch.  Past 65,535 column panels (n above
# 8,388,480; 2,097,120 for aopt_gains) the partial pass and aopt_gains
# take one launch per 65,535 panels; the main paths stay far below.
LAUNCHES_PER_CALL = {"regression_gains": 2, "filter_gains": 2,
                     "aopt_gains": 1, "aopt_filter_gains": 1,
                     "logistic_gains": 1, "logistic_filter_gains": 1,
                     "flash_attention": 1}
SOURCES = {
    "regression_gains": "src/repro_torch/kernels/csrc/marginal_gains.cu",
    "filter_gains": "src/repro_torch/kernels/csrc/filter_gains.cu",
    "aopt_gains": "src/repro_torch/kernels/csrc/aopt_gains.cu",
    "aopt_filter_gains": "src/repro_torch/kernels/csrc/aopt_filter_gains.cu",
    "logistic_gains": "src/repro_torch/kernels/csrc/logistic_gains.cu",
    "logistic_filter_gains": "src/repro_torch/kernels/csrc/logistic_gains.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}


class SmokeFailure(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------

def phase_device(torch):
    need(torch.cuda.is_available(), "no CUDA device")
    from repro_torch.kernels.common import set_full_f32_matmul

    set_full_f32_matmul()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {name}  count={torch.cuda.device_count()}  "
        f"nvidia-smi: {smi}  torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return name, smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    info = _build.build("marginal_gains", "filter_gains", "aopt_gains",
                        "aopt_filter_gains", "logistic_gains",
                        "flash_attention")
    for name, bi in info.items():
        log(f"[build] {name}: {bi.seconds:.1f} s -> {bi.library.name}")
        for line in bi.ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] total {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def prefix_slots(torch, b, ragged, device):
    """FAST's (b + 1, b) prefix masks (``core.fast.prefix_masks``) with
    the last ``ragged`` slots invalid (slot_ok False), as at the end of a
    FAST run when fewer than b elements are alive or allowed."""
    from repro_torch.core.fast import prefix_masks

    ok = torch.arange(b, device=device) < b - ragged
    return prefix_masks(b, device) & ok[None, :]


def make_operands(torch, d, n, k, b, m, g, seed, fast=None):
    """X (d, n), per-guess orthonormal Q (g, d, k), deltas D (g, m, d, b)
    ⊥ Q_g, residuals R (g, m, d) and col_sq, made on the card.  ``fast``
    = (|S|, ragged) gives FAST's prefix sweep instead: Q with |S| nonzero
    columns of its k, and sample i's deltas zero past its prefix (m = b +
    1 prefixes, ``prefix_slots``)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    X = randn(d, n)
    Q = torch.zeros((g, d, k), device=dev)
    if k:
        Q = torch.linalg.qr(randn(g, d, k)).Q
    if fast is not None:
        Q[:, :, fast[0]:] = 0
    Dr = randn(g, m, d, b)
    Dr = Dr - Q[:, None] @ (Q[:, None].transpose(-1, -2) @ Dr)
    D = torch.linalg.qr(Dr).Q
    if fast is not None:
        D = D * prefix_slots(torch, b, fast[1], dev)[None, :, None, :]
    R = randn(g, m, d)
    return (X, Q.contiguous(), D.contiguous(), R,
            torch.sum(X * X, dim=0))


def _errs(got, want):
    """Max absolute and max relative (|want| floored at 1e-6) error."""
    diff = (got - want).abs()
    return (float(diff.max()),
            float((diff / want.abs().clamp(min=1e-6)).max()))


def phase_kernels(torch, cases):
    from repro_torch.kernels.common import (
        STREAM_PARITY_TOL,
        quantize,
        stream_dtype,
    )
    from repro_torch.kernels.filter_gains import (
        filter_gains,
        filter_gains_lattice_ref,
    )
    from repro_torch.kernels.marginal_gains import (
        regression_gains,
        regression_gains_ref,
    )

    from repro_torch.kernels.filter_gains.ops import (
        engine_plan,
        workspace_elems,
    )
    from repro_torch.kernels.marginal_gains.ops import split_plan, wide_copies

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {"regression_gains": 0.0, "filter_gains": 0.0}
    for case in cases:
        (d, n, k, b, m, g), fast = case[:6], (case[6:] or [None])[0]
        X, Q, D, R, csq = make_operands(torch, d, n, k, b, m, g, seed=d + n,
                                        fast=fast)
        shape = (f" FAST prefixes (|S|={fast[0]}, {fast[1]} ragged slots)"
                 if fast else "")
        r = R[:, 0].contiguous()
        for prec in ("f32", "bf16"):
            tol = STREAM_PARITY_TOL[prec]["kernel_vs_ref"]
            Xq = quantize(X, prec)
            gains = regression_gains(X, Q, r, csq, precision=prec)
            # The split-d sum has a fixed order: a second call must give
            # the same bits.
            same = torch.equal(gains, regression_gains(X, Q, r, csq,
                                                       precision=prec))
            wide = wide_copies(X.to(stream_dtype(prec)), Q)
            log(f"[kernels] regression_gains {prec:4s} d={d} n={n} k={k} "
                f"G={g}: S={split_plan(g, d, n, k, sms)[0]} "
                f"copies={'16-byte' if wide else 'element'} "
                f"deterministic={'yes' if same else 'NO'}")
            need(same, f"regression_gains {prec} differs between two calls "
                       f"at d={d} n={n} k={k} G={g}")
            fgains = filter_gains(X, Q, D, R, csq, precision=prec)
            fsame = torch.equal(fgains, filter_gains(X, Q, D, R, csq,
                                                     precision=prec))
            plan, fs, _ = engine_plan(g, m, d, n, k, b, sms)
            fwide = wide_copies(X.to(stream_dtype(prec)),
                                torch.empty((1, plan.kp), device="cuda"))
            log(f"[kernels] filter_gains {prec:4s} d={d} n={n} k={k} b={b} "
                f"m={m} G={g}{shape}: stacked kp={plan.kp} ({plan.width} "
                f"vectors) S={fs} workspace "
                f"{4 * workspace_elems(plan, n, fs)} bytes "
                f"copies={'16-byte' if fwide else 'element'} "
                f"deterministic={'yes' if fsame else 'NO'}")
            need(fsame, f"filter_gains {prec} differs between two calls "
                        f"at d={d} n={n} k={k} b={b} m={m} G={g}")
            for name, got, want in (
                ("regression_gains", gains,
                 regression_gains_ref(Xq, Q, r, csq)),
                ("filter_gains", fgains,
                 filter_gains_lattice_ref(Xq, Q, D, R, csq)),
            ):
                torch.cuda.synchronize()
                need(bool(torch.isfinite(got).all()), f"{name}: non-finite")
                abs_err, rel_err = _errs(got, want)
                ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
                log(f"[kernels] {name:16s} {prec:4s} d={d} n={n} k={k} "
                    f"b={b} m={m} G={g}{shape}: max_abs_err={abs_err:.3e} "
                    f"max_rel_err={rel_err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                need(ok, f"{name} {prec} disagrees with its plain version "
                         f"at d={d} n={n} k={k} b={b} m={m} G={g}")
                if prec == "f32":
                    worst[name] = max(worst[name], abs_err)
            del Xq
    return worst


def make_aopt_operands(torch, d, n, g, m, b, n_sel, seed, sigma2=1.0,
                       ragged=None):
    """Genuine A-optimality operands on the card: X of the D1 design,
    the shared solves W (g, d, n) of g states with n_sel random
    selections each, and the Woodbury factors E (g, m, d, b), F of m
    random b-sets per state from ``expand_factors``.  With ``ragged``
    (an int), FAST's prefix sweep instead: one random sequence of b per
    state and its m = b + 1 insertion prefixes, the last ``ragged``
    slots invalid (``prefix_slots``)."""
    from repro_torch.core import AOptimalityObjective
    from repro_torch.data.synthetic import make_d1_design

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)

    def draw(count):
        return torch.randperm(n, generator=gen)[:count]

    obj = AOptimalityObjective(
        make_d1_design(seed=seed, n_samples=n, n_features=d),
        kmax=n_sel + b, sigma2=sigma2, device=dev)
    idx = torch.stack([draw(n_sel) for _ in range(g)]).to(dev)
    st = obj.add_set(obj.init(g), idx, torch.ones_like(idx, dtype=torch.bool))
    if b == 0:
        E = torch.zeros((g, m, d, 0), device=dev)
        F = torch.zeros((g, m, 0, 0), device=dev)
    elif ragged is not None:
        seq = torch.stack([draw(b) for _ in range(g)]).to(dev)
        sidx = seq[:, None, :].expand(g, m, b).contiguous()
        mask = prefix_slots(torch, b, ragged, dev)[None].expand(g, m, b)
        E, F = obj.expand_factors(st, sidx, mask.contiguous())
    else:
        sidx = torch.stack([torch.stack([draw(b) for _ in range(m)])
                            for _ in range(g)]).to(dev)
        E, F = obj.expand_factors(st, sidx,
                                  torch.ones_like(sidx, dtype=torch.bool))
    return obj.X, st.W, E.contiguous(), F.contiguous(), obj.isig2


def phase_aopt_kernels(torch, cases):
    from repro_torch.kernels.aopt_gains import aopt_gains, aopt_gains_ref
    from repro_torch.kernels.common import STREAM_PARITY_TOL, quantize
    from repro_torch.kernels.filter_gains import (
        aopt_filter_gains,
        aopt_filter_gains_lattice_ref,
    )

    from repro_torch.kernels.filter_gains.ops import aopt_plan

    from repro_torch.kernels.filter_gains.ops import aopt_scratch_elems

    worst = {"aopt_gains": 0.0, "aopt_filter_gains": 0.0}
    for case in cases:
        (d, n, g, m, b, n_sel, sigma2), ragged = case[:7], \
            (case[7:] or [None])[0]
        X, W, E, F, isig2 = make_aopt_operands(torch, d, n, g, m, b, n_sel,
                                               seed=d + n + b, sigma2=sigma2,
                                               ragged=ragged)
        shape = ("" if ragged is None else
                 f" FAST prefixes ({ragged} ragged slots)")
        for prec in ("f32", "bf16"):
            tol = STREAM_PARITY_TOL[prec]["kernel_vs_ref"]
            Xq, Wq = quantize(X, prec), quantize(W, prec)
            fgains = aopt_filter_gains(X, W, E, F, isig2, precision=prec)
            # No atomics: a second call must give the same bits.
            same = torch.equal(fgains, aopt_filter_gains(
                X, W, E, F, isig2, precision=prec))
            plan = aopt_plan(m, b)
            log(f"[kernels] aopt_filter_gains {prec:4s} d={d} n={n} G={g} "
                f"m={m} b={b}{shape}: slot {plan.bs} columns, {plan.ms} per "
                f"unit, {plan.nc} chunk(s), {plan.units} unit(s) per guess, "
                f"scratch {4 * aopt_scratch_elems(g, m, n, b)} bytes "
                f"deterministic={'yes' if same else 'NO'}")
            need(same, f"aopt_filter_gains {prec} differs between two calls "
                       f"at d={d} n={n} G={g} m={m} b={b}")
            for name, got, want in (
                ("aopt_gains", aopt_gains(X, W, isig2, precision=prec),
                 aopt_gains_ref(Xq, Wq, isig2)),
                ("aopt_filter_gains", fgains,
                 aopt_filter_gains_lattice_ref(Xq, Wq, E, F, isig2)),
            ):
                torch.cuda.synchronize()
                need(bool(torch.isfinite(got).all()), f"{name}: non-finite")
                abs_err, rel_err = _errs(got, want)
                ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
                log(f"[kernels] {name:17s} {prec:4s} d={d} n={n} G={g} "
                    f"m={m} b={b} |S|={n_sel} isig2={isig2:g}{shape}: "
                    f"max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                need(ok, f"{name} {prec} disagrees with its plain version "
                         f"at d={d} n={n} G={g} m={m} b={b}")
                if prec == "f32":
                    worst[name] = max(worst[name], abs_err)
            del Xq, Wq
        del X, W, E, F
    return worst


@functools.lru_cache(maxsize=None)
def d3_problem(d, n, support):
    """The paper's D3 data (seed 2, as the entry point): X, y, support."""
    from repro_torch.data.synthetic import make_d3_classification

    return make_d3_classification(n_samples=d, n_features=n, support=support)


def make_logistic_operands(torch, d, n, g, m, b, n_sel, seed, ragged=None):
    """Genuine logistic operands on the card: X and y of the D3 protocol,
    the logits (g, d) of g states refit on n_sel random features each
    (the empty set, η = 0, for n_sel = 0), and the refit logits (g, m, d)
    of m random b-sets per state from ``expand_logits``.  With ``ragged``
    (an int), FAST's prefix sweep instead: one random sequence of b per
    state and its m = b + 1 insertion prefixes (``prefix_slots``)."""
    from repro_torch.core import ClassificationObjective

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    X, y, _ = d3_problem(d, n, min(256, n // 4))
    obj = ClassificationObjective(X, y, kmax=n_sel + b, device=dev)
    st = obj.init(g)
    if n_sel:
        idx = torch.stack([torch.randperm(n, generator=gen)[:n_sel]
                           for _ in range(g)]).to(dev)
        st = obj.add_set(st, idx, torch.ones_like(idx, dtype=torch.bool))
    if ragged is not None:
        seq = torch.stack([torch.randperm(n, generator=gen)[:b]
                           for _ in range(g)]).to(dev)
        sidx = seq[:, None, :].expand(g, m, b).contiguous()
        mask = prefix_slots(torch, b, ragged, dev)[None].expand(g, m, b)
        etas = obj.expand_logits(st, sidx, mask.contiguous())
    else:
        sidx = torch.stack([torch.stack([torch.randperm(n, generator=gen)[:b]
                                         for _ in range(m)])
                            for _ in range(g)]).to(dev)
        etas = obj.expand_logits(st, sidx,
                                 torch.ones_like(sidx, dtype=torch.bool))
    return obj.X, obj.y, st.eta.contiguous(), etas.contiguous()


def logistic_atol(torch, y, etas):
    """The gate's absolute tolerance per state, 2e-4 + ε_f32·√d·ℓ_abs
    with ℓ_abs = Σ_i |y_i η_i − softplus(η_i)|: the f32 cancellation of
    ℓ_new − ℓ_old, each of order d·ln 2.  etas (..., d) → (..., 1)."""
    from repro_torch.kernels.logistic_gains.ref import softplus

    e = etas.double()
    labs = torch.sum(torch.abs(y.double() * e - softplus(e)), dim=-1,
                     keepdim=True)
    eps = torch.finfo(torch.float32).eps
    return 2e-4 + eps * e.shape[-1] ** 0.5 * labs


def phase_logistic_kernels(torch, cases):
    """Kernels 6-7 against their plain versions run in float64 on the
    card, beside the f32 plain version: the kernel must lie within rtol
    2e-4 and atol 2e-4 + ε_f32·√d·ℓ_abs of the float64 result.  The
    f32 plain version's error is printed, not gated: it keeps the
    reference's formula, whose ℓ_new − ℓ_old cancels in f32.  Both must
    also give the same bits in two calls (their cluster sums close in a
    fixed order); each line names its cluster plan and states per
    pass.  Both kernels take log1pf's fast path without its
    branch: it must give log1pf's bits at every float in [0, 1]."""
    from repro_torch.kernels.common import quantize, sm_count, stream_dtype
    from repro_torch.kernels.filter_gains import (
        logistic_filter_gains,
        logistic_filter_gains_lattice_ref,
    )
    from repro_torch.kernels.logistic_gains import (
        logistic_gains,
        logistic_gains_ref,
    )
    from repro_torch.kernels.logistic_gains.ops import (
        ENGINE_STATES_PER_PASS,
        cluster_plan,
        log1p_check,
    )

    bad = log1p_check()
    log(f"[kernels] the kernels' branch-free log1pf against the library's "
        f"over every float in [0, 1]: {bad} differ in a bit")
    need(bad == 0, f"log1pf_01 differs from log1pf at {bad} floats")

    def lanes_ref(Xq, y, E, steps):
        return torch.stack([logistic_gains_ref(Xq, y, e, steps=steps)
                            for e in E])

    worst = {"logistic_gains": 0.0, "logistic_filter_gains": 0.0}
    for case in cases:
        (d, n, g, m, b, n_sel, steps), ragged = case[:7], \
            (case[7:] or [None])[0]
        X, y, E, etas = make_logistic_operands(torch, d, n, g, m, b, n_sel,
                                               seed=d + n + n_sel,
                                               ragged=ragged)
        y64 = y.double()
        for prec in ("f32", "bf16"):
            Xq = quantize(X, prec)
            X64 = Xq.double()
            checks = []
            for name, states, L, run, want, plain in (
                ("logistic_gains", E, 1,
                 lambda: logistic_gains(X, y, E, steps=steps,
                                        precision=prec),
                 lambda: lanes_ref(X64, y64, E.double(), steps),
                 lambda: lanes_ref(Xq, y, E, steps)),
                ("logistic_filter_gains", etas, ENGINE_STATES_PER_PASS,
                 lambda: logistic_filter_gains(X, y, etas, steps=steps,
                                               precision=prec),
                 lambda: logistic_filter_gains_lattice_ref(
                     X64, y64, etas.double(), steps=steps),
                 lambda: logistic_filter_gains_lattice_ref(
                     Xq, y, etas, steps=steps)),
            ):
                got = run()
                same = torch.equal(got, run())
                p = cluster_plan(states[..., 0].numel(), d, n,
                                 stream_dtype(prec), sm_count(X.device), L)
                log(f"[kernels] {name:21s} {prec:4s} d={d} n={n} "
                    f"states={states[..., 0].numel()}: C={p.cluster} "
                    f"R={p.rows} BN={p.bn} L={p.states_per_pass} "
                    f"tail_rows={p.tail_rows} deterministic="
                    f"{'yes' if same else 'NO'}")
                need(same, f"{name} {prec} differs between two calls at "
                           f"d={d} n={n} G={g} m={m}")
                checks.append((name, states, got, want(), plain()))
            for name, states, got, want, plain in checks:
                torch.cuda.synchronize()
                need(bool(torch.isfinite(got).all()), f"{name}: non-finite")
                atol = logistic_atol(torch, y, states)
                err = (got.double() - want).abs()
                limit = atol + 2e-4 * want.abs()
                plain_err = float((plain.double() - want).abs().max())
                ok = bool((err <= limit).all())
                log(f"[kernels] {name:21s} {prec:4s} d={d} n={n} G={g} "
                    f"m={m} b={b} |S|={n_sel} steps={steps}"
                    f"{'' if ragged is None else ' FAST prefixes'}: "
                    f"kernel_err={float(err.max()):.3e} "
                    f"f32_plain_err={plain_err:.3e} "
                    f"atol_min={float(atol.min()):.3e} "
                    f"max_gain={float(want.max()):.3f} "
                    f"worst err/limit={float((err / limit).max()):.2e} "
                    f"{'ok' if ok else 'FAIL'}")
                need(ok, f"{name} {prec} outside the f64-anchored bound at "
                         f"d={d} n={n} G={g} m={m} steps={steps}")
                if prec == "f32":
                    worst[name] = max(worst[name], float(err.max()))
                del got, want, plain, err, limit
            del Xq, X64, checks
        del X, y, E, etas
    return worst


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------

def phase_main(torch):
    from repro_torch import quickstart
    from repro_torch.kernels.filter_gains import filter_gains
    from repro_torch.kernels.marginal_gains import regression_gains

    k = MAIN["k"]
    torch.cuda.reset_peak_memory_stats()
    regression_gains.launches = 0
    filter_gains.launches = 0
    out = quickstart.main(device="cuda", verbose=False, seed=0, **MAIN)
    launches = {"regression_gains": regression_gains.launches,
                "filter_gains": filter_gains.launches}
    peak = torch.cuda.max_memory_allocated()
    dash = out["dash"]
    log(f"[main] D1 d={MAIN['d']} n={MAIN['n']} support={MAIN['support']} "
        f"k={k} G={MAIN['n_guesses']} m={MAIN['n_samples']} (no cut)")
    for algo in ("greedy", "dash", "topk", "random"):
        extra = ""
        if algo == "dash":
            extra = (f"rounds={out['dash_rounds']} "
                     f"selected={out['dash_selected']} ")
        elif algo == "greedy":
            extra = f"rounds={k} "
        log(f"[main] {algo:7s} value={out[algo + '_value']:.6f} {extra}"
            f"host_s={out[algo + '_s']:.3f} "
            f"launches={out['launches'][algo]}")
    log(f"[main] planted-support recovery {out['recovered']}/{k}")
    log(f"[main] dash filter iterations per round (best guess): "
        f"{dash.trace.filter_iters.tolist()}")
    log(f"[main] max_memory_allocated={peak} bytes  launches={launches}")

    need(launches["regression_gains"] > 0 and launches["filter_gains"] > 0,
         f"a kernel of the main path never launched: {launches}")
    need(out["launches"]["greedy"]["regression_gains"] >= k,
         "greedy launched regression_gains fewer than k times")
    need(out["launches"]["dash"]["filter_gains"] > 0,
         "DASH never launched filter_gains")
    for algo in ("greedy", "dash", "topk", "random"):
        v = out[algo + "_value"]
        need(v == v and 0.0 <= v <= 1.0, f"{algo} value {v} not in [0, 1]")
    need(out["dash_value"] > out["random_value"],
         "DASH does not beat RANDOM")
    need(out["dash_selected"] <= k, "DASH selected more than k")
    return out, launches, peak


# ---------------------------------------------------------------------------
# 5. card against the CPU plain path on the small D1
# ---------------------------------------------------------------------------

def phase_parity(torch):
    from repro_torch.core import RegressionObjective, dash_auto, greedy
    from repro_torch.core.random import SeedKey
    from repro_torch.data.synthetic import make_d1_regression

    X, y, _ = make_d1_regression(seed=0, n_samples=600, n_features=200,
                                 support=40)
    objs, runs = {}, {}
    for dev in ("cpu", "cuda"):
        obj = objs[dev] = RegressionObjective(X, y, 40, device=dev)
        runs[dev] = (greedy(obj, 40, device=dev),
                     dash_auto(obj, 40, SeedKey(0, host=True), eps=0.25,
                               alpha=0.6, n_samples=8, n_guesses=6,
                               device=dev))
    (gc, dc), (gg, dg) = runs["cpu"], runs["cuda"]
    pc, pg = gc.sel_idx.tolist(), gg.sel_idx.cpu().tolist()
    if pc == pg:
        log(f"[parity] greedy: identical picks (k=40), values "
            f"cpu={float(gc.value):.6f} cuda={float(gg.value):.6f}")
    else:
        i = next(j for j, (a, b) in enumerate(zip(pc, pg)) if a != b)
        obj = objs["cpu"]
        st = obj.add_set(obj.init(), torch.tensor([pc[:i]]),
                         torch.ones((1, i), dtype=torch.bool))
        top = torch.topk(obj.gains(st)[0], 2).values.tolist()
        gap = (top[0] - top[1]) / top[0]
        log(f"[parity] greedy: first difference at step {i}, top-two "
            f"relative gap {gap:.3e}")
        need(gap < 2e-4, "greedy picks differ beyond a near-tie")
    same = bool(torch.equal(dc.sel_mask, dg.sel_mask.cpu()))
    dv = abs(float(dc.value) - float(dg.value))
    log(f"[parity] dash: same set={same} value cpu={float(dc.value):.6f} "
        f"cuda={float(dg.value):.6f} |diff|={dv:.3e}")
    need(same or dv < 1e-3, "DASH on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# 6-7. the A-optimal design path and its card-vs-CPU parity
# ---------------------------------------------------------------------------

def phase_design_main(torch):
    from repro_torch import experimental_design
    from repro_torch.kernels.aopt_gains import aopt_gains
    from repro_torch.kernels.filter_gains import aopt_filter_gains

    k, d = DESIGN["k"], DESIGN["d"]
    torch.cuda.reset_peak_memory_stats()
    aopt_gains.launches = 0
    aopt_filter_gains.launches = 0
    out = experimental_design.main(device="cuda", verbose=False, seed=0,
                                   **DESIGN)
    launches = {"aopt_gains": aopt_gains.launches,
                "aopt_filter_gains": aopt_filter_gains.launches}
    peak = torch.cuda.max_memory_allocated()
    dash = out["dash"]
    log(f"[design] D1 design d={d} n={DESIGN['n']} k={k} "
        f"G={DESIGN['n_guesses']} OPT x alphas {out['alphas']} = "
        f"{len(out['lanes'])} lanes, m={DESIGN['n_samples']} (no cut); "
        f"gamma={out['gamma']:.4e} alpha={out['alpha']:.3f}")
    for algo in ("greedy", "dash", "topk", "random"):
        extra = ""
        if algo == "dash":
            extra = (f"rounds={out['dash_rounds']} "
                     f"selected={out['dash_selected']} ")
        elif algo == "greedy":
            extra = f"rounds={k} "
        log(f"[design] {algo:7s} value={out[algo + '_value']:.6f} {extra}"
            f"host_s={out[algo + '_s']:.3f} "
            f"launches={out['launches'][algo]}")
    log(f"[design] dash filter iterations per round (best lane): "
        f"{dash.trace.filter_iters.tolist()}")
    for i, lane in enumerate(out["lanes"]):
        log(f"[design] dash lane {i:2d} (OPT guess {i // len(out['alphas'])}"
            f"): alpha={lane['alpha']:.3f} value={lane['value']:.6f} "
            f"filter_iterations={lane['filter_iters']}")
    log(f"[design] max_memory_allocated={peak} bytes  launches={launches}"
        f" (the diversified DASH's among them: "
        f"{out['launches']['diversified']}, [design diversified])")

    need(launches["aopt_gains"] > 0 and launches["aopt_filter_gains"] > 0,
         f"a kernel of the design path never launched: {launches}")
    need(out["launches"]["greedy"]["aopt_gains"] >= k,
         "greedy launched aopt_gains fewer than k times")
    need(out["launches"]["dash"]["aopt_filter_gains"] > 0,
         "DASH never launched aopt_filter_gains")
    for algo in ("greedy", "dash", "topk", "random"):
        v = out[algo + "_value"]
        need(v == v and 0.0 <= v <= d, f"{algo} value {v} not in [0, {d}]")
    need(out["dash_value"] > out["random_value"],
         "DASH does not beat RANDOM on the design")
    need(out["dash_selected"] <= k, "DASH selected more than k")
    return out, launches, peak


def phase_design_parity(torch):
    """Greedy and DASH on the small design, card against the CPU.  Every
    candidate column has unit norm, so greedy's first gains are all 0.5
    in exact arithmetic and its picks may part at an f32 tie: they must
    be equal, or first differ where the CPU's top two gains are within
    2e-4 relative.  DASH (noise drawn on the CPU) selects the same set,
    or its values agree within 1e-3."""
    from repro_torch.core import AOptimalityObjective, dash_auto, greedy
    from repro_torch.core.random import SeedKey
    from repro_torch.data.synthetic import make_d1_design

    X = make_d1_design(seed=0, n_samples=512, n_features=128)
    objs, runs = {}, {}
    for dev in ("cpu", "cuda"):
        obj = objs[dev] = AOptimalityObjective(X, 32, device=dev)
        runs[dev] = (greedy(obj, 32, device=dev),
                     dash_auto(obj, 32, SeedKey(0, host=True), eps=0.25,
                               alpha=0.3, alphas=[0.3, 1.0], n_samples=8,
                               n_guesses=6, device=dev))
    (gc, dc), (gg, dg) = runs["cpu"], runs["cuda"]
    pc, pg = gc.sel_idx.tolist(), gg.sel_idx.cpu().tolist()
    if pc == pg:
        log(f"[design parity] greedy: identical picks (k=32), values "
            f"cpu={float(gc.value):.6f} cuda={float(gg.value):.6f}")
    else:
        i = next(j for j, (a, b) in enumerate(zip(pc, pg)) if a != b)
        obj = objs["cpu"]
        st = obj.init()
        if i:
            st = obj.add_set(st, torch.tensor([pc[:i]]),
                             torch.ones((1, i), dtype=torch.bool))
        top = torch.topk(obj.gains(st)[0], 2).values.tolist()
        gap = (top[0] - top[1]) / top[0]
        log(f"[design parity] greedy: first difference at step {i}, "
            f"top-two relative gap {gap:.3e}; values "
            f"cpu={float(gc.value):.6f} cuda={float(gg.value):.6f}")
        need(gap < 2e-4, "design greedy picks differ beyond a near-tie")
    same = bool(torch.equal(dc.sel_mask, dg.sel_mask.cpu()))
    dv = abs(float(dc.value) - float(dg.value))
    log(f"[design parity] dash: same set={same} value "
        f"cpu={float(dc.value):.6f} cuda={float(dg.value):.6f} "
        f"|diff|={dv:.3e}")
    need(same or dv < 1e-3, "design DASH on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# 8-9. the classification path and its card-vs-CPU parity
# ---------------------------------------------------------------------------

def phase_class_main(torch):
    import math

    from repro_torch import classification
    from repro_torch.kernels.filter_gains import logistic_filter_gains
    from repro_torch.kernels.logistic_gains import logistic_gains

    k, d = CLASS["k"], CLASS["d"]
    top = d * math.log(2.0)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    logistic_gains.launches = 0
    logistic_filter_gains.launches = 0
    out = classification.main(device="cuda", verbose=False, **CLASS)
    launches = {"logistic_gains": logistic_gains.launches,
                "logistic_filter_gains": logistic_filter_gains.launches}
    peak = torch.cuda.max_memory_allocated()
    dash = out["dash"]
    log(f"[class] D3 d={d} n={CLASS['n']} support={CLASS['support']} k={k} "
        f"G={CLASS['n_guesses']} OPT guesses, alpha={out['alpha']}, "
        f"m={CLASS['n_samples']} (no cut)")
    for algo in ("greedy", "dash", "topk", "random"):
        extra = ""
        if algo == "dash":
            extra = (f"rounds={out['dash_rounds']} "
                     f"selected={out['dash_selected']} ")
        elif algo == "greedy":
            extra = f"rounds={k} "
        log(f"[class] {algo:7s} value={out[algo + '_value']:.6f} {extra}"
            f"host_s={out[algo + '_s']:.3f} "
            f"launches={out['launches'][algo]}")
    log(f"[class] planted-support recovery (DASH) {out['recovered']}/{k}")
    log(f"[class] dash filter iterations per round (best lane): "
        f"{dash.trace.filter_iters.tolist()}")
    for i, lane in enumerate(out["lanes"]):
        log(f"[class] dash lane {i:2d} (OPT guess {i}): "
            f"alpha={lane['alpha']:.3f} value={lane['value']:.6f} "
            f"filter_iterations={lane['filter_iters']}")
    log(f"[class] max_memory_allocated={peak} bytes, of which "
        f"{peak - base} above the {base} bytes held before the run  "
        f"launches={launches}")

    need(launches["logistic_gains"] > 0
         and launches["logistic_filter_gains"] > 0,
         f"a kernel of the classification path never launched: {launches}")
    need(out["launches"]["greedy"]["logistic_gains"] >= k,
         "greedy launched logistic_gains fewer than k times")
    need(out["launches"]["dash"]["logistic_filter_gains"] > 0,
         "DASH never launched logistic_filter_gains")
    values = [out[a + "_value"] for a in ("greedy", "dash", "topk",
                                          "random")]
    values += [lane["value"] for lane in out["lanes"]]
    need(all(v == v and 0.0 <= v <= top for v in values),
         f"a classification value lies outside [0, d ln 2 = {top:.3f}]")
    need(out["dash_value"] > out["random_value"],
         "classification DASH does not beat RANDOM")
    need(out["dash_selected"] <= k, "DASH selected more than k")
    return out, launches, peak


def phase_class_parity(torch):
    """Greedy and DASH on the small D3 (600 × 200, support 50, k = 20),
    card against the CPU, DASH noise drawn on the CPU.  Greedy's picks
    are equal, or first differ where the CPU's top two gains are within
    1e-4 relative.  Per DASH guess (lane) the card selects the CPU's set,
    or its value agrees within 1e-3."""
    from repro_torch.core import ClassificationObjective, dash_auto, greedy
    from repro_torch.core.random import SeedKey
    from repro_torch.data.synthetic import make_d3_classification

    X, y, _ = make_d3_classification(n_samples=600, n_features=200,
                                     support=50)
    objs, runs = {}, {}
    for dev in ("cpu", "cuda"):
        obj = objs[dev] = ClassificationObjective(X, y, 20, device=dev)
        runs[dev] = (greedy(obj, 20, device=dev),
                     dash_auto(obj, 20, SeedKey(0, host=True), eps=0.25,
                               alpha=0.6, n_samples=8, n_guesses=6,
                               return_lattice=True, device=dev)[1])
    (gc, dc), (gg, dg) = runs["cpu"], runs["cuda"]
    pc, pg = gc.sel_idx.tolist(), gg.sel_idx.cpu().tolist()
    if pc == pg:
        log(f"[class parity] greedy: identical picks (k=20), values "
            f"cpu={float(gc.value):.6f} cuda={float(gg.value):.6f}")
    else:
        i = next(j for j, (a, b) in enumerate(zip(pc, pg)) if a != b)
        obj = objs["cpu"]
        st = obj.init()
        if i:
            st = obj.add_set(st, torch.tensor([pc[:i]]),
                             torch.ones((1, i), dtype=torch.bool))
        top = torch.topk(obj.gains(st)[0], 2).values.tolist()
        gap = (top[0] - top[1]) / top[0]
        log(f"[class parity] greedy: first difference at step {i}, "
            f"top-two relative gap {gap:.3e}; values "
            f"cpu={float(gc.value):.6f} cuda={float(gg.value):.6f}")
        need(gap < 1e-4, "classification greedy picks differ beyond a "
                         "near-tie")
    lanes = dc.value.shape[0]
    for g in range(lanes):
        same = bool(torch.equal(dc.sel_mask[g], dg.sel_mask[g].cpu()))
        vc, vg = float(dc.value[g]), float(dg.value[g])
        log(f"[class parity] dash lane {g:2d}: same set={same} value "
            f"cpu={vc:.6f} cuda={vg:.6f} |diff|={abs(vc - vg):.3e} "
            f"filter_iterations cpu={int(dc.trace.filter_iters[g].sum())} "
            f"cuda={int(dg.trace.filter_iters[g].sum())}")
        need(same or abs(vc - vg) < 1e-3,
             f"classification DASH lane {g} on the card disagrees with the "
             "CPU")


# ---------------------------------------------------------------------------
# registry: the §5 roster through select() on the card
# ---------------------------------------------------------------------------

def counted_kernels():
    """Every kernel wrapper with a launch counter, by name."""
    from repro_torch.bench_selection import KERNELS
    from repro_torch.kernels.flash_attention import flash_attention

    return {**KERNELS, "flash_attention": flash_attention}


def synced(torch, fn):
    """(host seconds, result, nonzero launch counts) of ``fn``, every
    kernel's counter set to 0 just before and read just after, around
    synchronizes."""
    kernels = counted_kernels()
    torch.cuda.synchronize()
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return secs, res, {name: f.launches for name, f in kernels.items()
                       if f.launches}


def zeroed_timer(torch):
    """``bench_selection``'s timer over :func:`synced`."""
    return lambda fn, dev: synced(torch, fn)


def log_registry_row(tag, row):
    cost = row.get("cost") or {}
    log(f"[{tag}] {row['algo']:19s} value={row['value']:.6f} "
        f"host_s={row['seconds']:.3f} rounds_measured={row.get('rounds')} "
        f"sel_count={row.get('sel_count', row.get('nnz'))} "
        f"launches={row['launches']} cost_rounds="
        f"{cost.get('adaptive_rounds')} cost_queries="
        f"{cost.get('oracle_calls')}")


def phase_registry_main(torch, random_value):
    """``repro_torch.bench_selection --suite main`` on the card: lazy and
    stochastic greedy, FAST (its binary search over 8 OPT guesses: 3
    probes), adaptive sequencing and TOP-K through ``select`` on the
    regression main's D1 (d = n = 8192, support 256, k = 128), then
    LASSO; the launch counters set to 0 just before each algorithm and
    read just after."""
    from repro_torch import bench_selection
    from repro_torch.core.fast import fast_round_cap

    k = MAIN["k"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = bench_selection.run_main(
        "cuda", d=MAIN["d"], n=MAIN["n"], k=k, support=MAIN["support"],
        timer=zeroed_timer(torch), verbose=False)
    peak = torch.cuda.max_memory_allocated()
    rows = res["rows"]
    log(f"[registry main] D1 d={MAIN['d']} n={MAIN['n']} "
        f"support={MAIN['support']} k={k} through select() (no cut); "
        f"RANDOM of [main] {random_value:.6f}")
    for row in rows.values():
        log_registry_row("registry main", row)
    cap = fast_round_cap(k, 0.06) * FAST_PROBES
    fl = rows["fast"]["launches"].get("filter_gains", 0)
    log(f"[registry main] fast: {fl} filter_gains calls over "
        f"{FAST_PROBES} probes (round cap {cap}); best probe's OPT "
        f"{float(rows['fast']['result'].raw.opt):.6f}; "
        f"max_memory_allocated={peak} bytes")
    for algo, row in rows.items():
        v = row["value"]
        need(v == v and 0.0 <= v <= 1.0, f"{algo} value {v} not in [0, 1]")
        need(algo == "lasso" or row["sel_count"] <= k,
             f"{algo} selected more than k")
    for algo in ("fast", "adaptive_sequencing", "lazy_greedy",
                 "stochastic_greedy"):
        need(rows[algo]["value"] > random_value,
             f"{algo} does not beat [main]'s RANDOM")
    need(0 < fl <= cap, f"fast launched filter_gains {fl} times")
    need(rows["fast"]["rounds"] <= cap, "fast's rounds pass the cap")
    need(rows["adaptive_sequencing"]["launches"].get("filter_gains", 0) > 0,
         "adaptive sequencing never launched filter_gains")
    for algo in ("lazy_greedy", "stochastic_greedy"):
        need(rows[algo]["launches"].get("regression_gains", 0) > 0,
             f"{algo} never launched regression_gains")
    return res


def phase_registry_paths(torch, design, cls):
    """FAST and adaptive sequencing through ``select`` on the design and
    classification mains' objectives (kernel 5 at b = 128 over 129
    prefixes, kernel 7 over 129 states), counters zeroed per run."""
    from repro_torch.core import SeedKey, select

    timer = zeroed_timer(torch)
    out = {}
    for tag, main_out, kernel, top, k in (
        ("design", design, "aopt_filter_gains", float(DESIGN["d"]),
         DESIGN["k"]),
        ("class", cls, "logistic_filter_gains", CLASS["d"] * math.log(2.0),
         CLASS["k"]),
    ):
        obj = main_out["objective"]
        for algo in ("fast", "adaptive_sequencing"):
            secs, res, launches = timer(
                lambda: select(algo, obj, k, key=SeedKey(0), device="cuda"),
                None)
            v = float(res.value)
            log(f"[registry {tag}] {algo:19s} value={v:.6f} host_s="
                f"{secs:.3f} rounds_measured={int(res.raw.rounds)} "
                f"sel_count={int(res.sel_count)} launches={launches}; "
                f"greedy, RANDOM of [{tag}] {main_out['greedy_value']:.6f}, "
                f"{main_out['random_value']:.6f}")
            need(v == v and 0.0 <= v <= top,
                 f"{tag} {algo} value {v} outside [0, {top:.3f}]")
            need(int(res.sel_count) <= k, f"{tag} {algo} selected > k")
            need(launches.get(kernel, 0) > 0,
                 f"{tag} {algo} never launched {kernel}")
            out[(tag, algo)] = (secs, res, launches)
    return out


def phase_registry_parity(torch):
    """Lazy and stochastic greedy, FAST and adaptive sequencing through
    ``select`` on the small D1 (600 × 200, k = 40), the small design
    (128 × 512, k = 32) and the small D3 (600 × 200, support 50, k = 20),
    card against the CPU plain path, noise drawn on the CPU, by
    ``phase_parity``'s rule: the pickers (lazy and stochastic greedy)
    give the CPU's picks, or first part from them at a near-tie (the
    CPU's gains of the two differing picks within 2e-4 relative; the
    design's unit-norm candidates all open at gain 1/2, so its first
    pick is an f32 tie, after which the values may part); FAST and
    adaptive sequencing give the CPU's set, or values within 1e-3."""
    from repro_torch.core import (
        AOptimalityObjective,
        ClassificationObjective,
        RegressionObjective,
        SeedKey,
        select,
    )
    from repro_torch.data.synthetic import (
        make_d1_design,
        make_d1_regression,
        make_d3_classification,
    )

    X1, y1, _ = make_d1_regression(seed=0, n_samples=600, n_features=200,
                                   support=40)
    Xd = make_d1_design(seed=0, n_samples=512, n_features=128)
    X3, y3, _ = make_d3_classification(n_samples=600, n_features=200,
                                       support=50)
    problems = (
        ("D1", lambda dev: RegressionObjective(X1, y1, 40, device=dev), 40),
        ("design", lambda dev: AOptimalityObjective(Xd, 32, device=dev), 32),
        ("D3", lambda dev: ClassificationObjective(X3, y3, 20, device=dev),
         20),
    )
    for name, make, k in problems:
        objs = {dev: make(dev) for dev in ("cpu", "cuda")}
        for algo in ("lazy_greedy", "stochastic_greedy", "fast",
                     "adaptive_sequencing"):
            rc, rg = (select(algo, objs[dev], k, key=SeedKey(0, host=True),
                             device=dev) for dev in ("cpu", "cuda"))
            same = bool(torch.equal(rc.sel_mask, rg.sel_mask.cpu()))
            vc, vg = float(rc.value), float(rg.value)
            dv = abs(vc - vg)
            picker = hasattr(rc.raw, "sel_idx")
            extra, tie = "", False
            if not same and picker:
                pc, pg = rc.raw.sel_idx.tolist(), rg.raw.sel_idx.cpu().tolist()
                i = next(j for j, (a, b) in enumerate(zip(pc, pg)) if a != b)
                obj = objs["cpu"]
                st = obj.init()
                if i:
                    st = obj.add_set(st, torch.tensor([pc[:i]]),
                                     torch.ones((1, i), dtype=torch.bool))
                g = obj.gains(st)[0]
                gap = float((g[pc[i]] - g[pg[i]]) / g[pc[i]].abs())
                tie = abs(gap) < 2e-4
                extra = (f" first difference at pick {i}: relative gap of "
                         f"the CPU's gains {gap:.3e}")
            log(f"[registry parity] {name:6s} {algo:19s} same set={same} "
                f"value cpu={vc:.6f} cuda={vg:.6f} |diff|={dv:.3e}{extra}")
            need(same or (tie if picker else dv < 1e-3),
                 f"{algo} on the {name} card run disagrees with the CPU")


# ---------------------------------------------------------------------------
# 10-13. the LM serving path: kernel 8, main, consistency, parity
# ---------------------------------------------------------------------------

def flash_plain(torch, q, k, v, dtype=None, **kw):
    """The plain version one KV group at a time (GQA keeps query heads
    h·r … h·r + r − 1 on KV head h), so its (B, r, Sq, Skv) scores fit at
    S = 8192; in ``dtype`` when given (float64: the anchor)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    if dtype is not None:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    r = q.shape[2] // k.shape[2]
    return torch.cat([
        flash_attention_ref(q[:, :, g * r:(g + 1) * r], k[:, :, g:g + 1],
                            v[:, :, g:g + 1], **kw)
        for g in range(k.shape[2])], dim=2)


def flash_dropped64(torch, q, k, v, drop, *, causal, window, softcap,
                    q_offset):
    """A planted fault: the plain formula in float64 with the keys
    ``drop[0]:drop[1]`` masked out of every row, one KV group at a
    time."""
    from repro_torch.kernels.flash_attention.ref import (
        NEG_INF,
        attention_mask,
    )

    d, hkv = q.shape[3], k.shape[2]
    r = q.shape[2] // hkv
    valid = attention_mask(q.shape[1], k.shape[1], causal=causal,
                           window=window, q_offset=q_offset,
                           device=q.device)
    valid[:, drop[0]:drop[1]] = False
    outs = []
    for g in range(hkv):
        sc = torch.einsum("bqhd,bkd->bhqk", q[:, :, g * r:(g + 1) * r]
                          .double(), k[:, :, g].double()) / math.sqrt(d)
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        sc = torch.where(valid, sc, NEG_INF)
        outs.append(torch.einsum("bhqk,bkd->bqhd", torch.softmax(sc, -1),
                                 v[:, :, g].double()))
        del sc
    return torch.cat(outs, dim=2)


def flash_inputs(torch, b, sq, skv, h, hkv, d, dtype, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                 for s in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d)))


def phase_lm_kernels(torch, cases):
    """Kernel 8 against its plain version on the card, f32 and bf16, at
    FLASH_TOL (rtol = atol).  An f32 case that misses it against the f32
    plain version is measured against the plain version in float64, and
    gated there, both errors printed.  Every bf16 case is also gated
    against the output's scale (FLASH_BF16_REL), beside the bf16 plain
    version's reading and two planted faults'."""
    from repro_torch.kernels.flash_attention import flash_attention

    worst = {"f32": 0.0, "bf16": 0.0, "bf16_rel": 0.0}
    for (b, sq, skv, h, hkv, d, causal, window, cap, q_offset) in cases:
        kw = dict(causal=causal, window=window, softcap=cap,
                  q_offset=q_offset)
        for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tol = FLASH_TOL[prec]
            q, k, v = flash_inputs(torch, b, sq, skv, h, hkv, d, dt,
                                   seed=sq + skv + d)
            got = flash_attention(q, k, v, **kw).float()
            torch.cuda.synchronize()
            need(bool(torch.isfinite(got).all()), "flash_attention: "
                 "non-finite output")
            want = flash_plain(torch, q, k, v, **kw).float()
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
            extra = ""
            if not ok and prec == "f32":
                w64 = flash_plain(torch, q, k, v, torch.float64, **kw)
                err64 = float((got.double() - w64).abs().max())
                plain64 = float((want.double() - w64).abs().max())
                ok = bool(torch.allclose(got.double(), w64, rtol=tol,
                                         atol=tol))
                extra = (f" float64-anchored: kernel_err={err64:.3e} "
                         f"f32_plain_err={plain64:.3e}")
                err = err64
                del w64
            if prec == "bf16":
                w64 = flash_plain(torch, q, k, v, torch.float64, **kw)
                rms = w64.pow(2).mean(-1).sqrt()        # (B, Sq, H)

                def rel(o):
                    e = (o.double() - w64).abs().amax(-1) / rms
                    return float(e.max())

                # a block inside the band of the causal rows' keys
                seen = min(skv, q_offset + sq) if causal else skv
                j0 = FLASH_FAULT_BLOCK * (seen // 2 // FLASH_FAULT_BLOCK)
                j1 = min(j0 + FLASH_FAULT_BLOCK, skv)
                r_kernel, r_plain = rel(got), rel(want)
                r_scaled = rel(0.9 * got)
                r_dropped = rel(flash_dropped64(torch, q, k, v, (j0, j1),
                                                **kw))
                ok = ok and r_kernel <= FLASH_BF16_REL
                extra = (f" rms(out) per row {float(rms.min()):.3e}.."
                         f"{float(rms.max()):.3e}; max_err/rms(row): kernel="
                         f"{r_kernel:.3e} bf16_plain={r_plain:.3e}; planted "
                         f"faults: x0.9={r_scaled:.3e} keys {j0}:{j1} "
                         f"dropped={r_dropped:.3e} (gate {FLASH_BF16_REL})")
                worst["bf16_rel"] = max(worst["bf16_rel"], r_kernel)
                del w64
            log(f"[lm kernels] flash_attention {prec:4s} B={b} Sq={sq} "
                f"Skv={skv} H={h} Hkv={hkv} D={d} causal={causal} "
                f"window={window} softcap={cap} q_offset={q_offset}: "
                f"max_abs_err={err:.3e}{extra} {'ok' if ok else 'FAIL'}")
            need(ok, f"flash_attention {prec} disagrees with its plain "
                     f"version at B={b} Sq={sq} Skv={skv} H={h} Hkv={hkv} "
                     f"D={d} {kw}")
            if prec == "bf16":
                need(min(r_scaled, r_dropped) > FLASH_BF16_REL,
                     "the bf16 gate does not see a planted fault at "
                     f"B={b} Sq={sq} Skv={skv} D={d} {kw}")
            worst[prec] = max(worst[prec], err)
            del q, k, v, got, want
    return worst


def serve_runs(torch, tag, arch, run, n_layers=None):
    """The port's serve_lm entry point at full width (``n_layers`` deep
    when given), greedy then top-k, with the flash launch counter set to
    0 just before and read just after.  Returns the runs, the launches,
    the peak memory and what earlier phases hold."""
    from repro_torch import serve_lm
    from repro_torch.kernels.flash_attention import flash_attention

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # what earlier phases keep
    flash_attention.launches = 0
    runs = {}
    for name, temp in (("greedy", 0.0), ("top-k", 0.8)):
        runs[name] = serve_lm.main(arch, **run, temperature=temp, full=True,
                                   n_layers=n_layers, device="cuda",
                                   verbose=False)
        if name == "greedy":   # the top-k run draws the same weights
            runs[name].pop("params")
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    for name, r in runs.items():
        log(f"{tag} {name:6s} prefill_s={r['prefill_s']:.4f} "
            f"decode_s_per_token={r['decode_s_per_token']:.5f} "
            f"tokens_per_s={r['tok_s']:.2f} total_s={r['seconds']:.4f} "
            f"ids[0][:12]={r['tokens'][0, :12].tolist()}")
    return runs, launches, peak, held


def check_first_tokens(torch, tag, runs, n_new):
    """Tokens of the runs in range; then a fresh prefill and one decode
    step of the same weights and batch (the prompt with its image
    embeddings or encoder frames): greedy's first two tokens are their
    argmax, top-k's first token lies within the 40 largest logits."""
    res = runs["top-k"]
    cfg, model, params = res["cfg"], res["model"], res["params"]
    b = res["prompt"].shape[0]
    for name, r in runs.items():
        tok = r["tokens"]
        need(tuple(tok.shape) == (b, n_new) and tok.dtype == torch.int32,
             f"{name}: tokens of shape {tuple(tok.shape)}")
        need(int(tok.min()) >= 0 and int(tok.max()) < cfg.padded_vocab,
             f"{name}: a token outside the padded vocab")
    logits, cache = model.prefill(params, res["batch"])
    need(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    need(tuple(logits.shape) == (b, cfg.padded_vocab), "prefill logits "
         f"of shape {tuple(logits.shape)}")
    g = runs["greedy"]["tokens"]
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    kth = torch.topk(logits.float(), 40, dim=-1).values[:, -1]
    pick = logits.float().gather(1, res["tokens"][:, :1].long())[:, 0]
    logits2, _ = model.decode_step(params, cache, g[:, :1],
                                   cache["step_offset"])
    second = torch.argmax(logits2, dim=-1).to(torch.int32)
    log(f"{tag} check: greedy token 0 = prefill argmax: "
        f"{bool(torch.equal(first, g[:, 0]))}, token 1 = decode argmax: "
        f"{bool(torch.equal(second, g[:, 1]))}, top-k token 0 within the "
        f"top 40: {bool((pick >= kth).all())}; logits rms "
        f"{float(logits.float().pow(2).mean().sqrt()):.4f}")
    need(torch.equal(first, g[:, 0]), "greedy token 0 is not the argmax")
    need(torch.equal(second, g[:, 1]), "greedy token 1 is not the argmax")
    need(bool((pick >= kth).all()), "top-k drew outside the top 40")
    del logits, logits2, cache


def phase_lm_main(torch):
    """The port's serve_lm entry point at full width, greedy then top-k,
    with the flash launch counter set to 0 just before and read just
    after; then the first tokens are checked against a fresh prefill and
    decode of the same weights and prompt."""
    run = {k: v for k, v in LM.items() if k != "arch"}
    runs, launches, peak, held = serve_runs(torch, "[lm]", LM["arch"], run)
    res = runs["top-k"]
    cfg = res["cfg"]
    b, n = LM["batch"], LM["new_tokens"]
    log(f"[lm] {cfg.name} full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.attn.n_heads} query / {cfg.attn.n_kv_heads} "
        f"KV heads of {cfg.attn.head_dim}, window {cfg.attn.window}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
        f"{cfg.dtype}; random weights (seed 0); batch {b}, prompt "
        f"{LM['prompt_len']}, {n} new tokens")
    log(f"[lm] max_memory_allocated={peak} bytes, {peak - held} above "
        f"the {held} that earlier phases hold; flash_attention "
        f"launches={launches} ({launches / 2:g} per prefill)")
    need(launches == 2 * LM_LAYERS,
         f"flash_attention launched {launches} times in two prefills of "
         f"{LM_LAYERS} layers")
    check_first_tokens(torch, "[lm]", runs, n)
    return res, launches, peak


def phase_lm_consistency(torch, model, params):
    """At full width: prefill S − 1 tokens (ring caches), decode token
    S − 1, against the last logits of prefilling all S, within
    LM_CONSIST_TOL; argmax equal wherever the top-two margin exceeds it.
    Two planted faults, each decoded from a copy of the same cache, must
    land above LM_CONSIST_TOL."""
    cfg = model.cfg
    s = LM_CONSIST_S
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, s), generator=gen,
                        device="cuda", dtype=torch.int32)
    want, _ = model.prefill(params, {"tokens": tok})
    _, cache = model.prefill(params, {"tokens": tok[:, :-1]})
    ring = cache["layers"][0].k.shape[1]

    def decode(pos, zero=None):
        c = {"layers": [type(lc)(*(t.clone() for t in lc))
                        for lc in cache["layers"]]}
        if zero is not None:
            for lc in c["layers"]:
                lc.k[:, zero[0]:zero[1]] = 0
                lc.v[:, zero[0]:zero[1]] = 0
        out, _ = model.decode_step(params, c, tok[:, -1:],
                                   torch.full((2,), pos, dtype=torch.int32,
                                              device="cuda"))
        return out.float()

    want = want.float()
    faults = {"position S-2": decode(s - 2),
              f"slots {LM_FAULT_SLOTS[0]}:{LM_FAULT_SLOTS[1]} zeroed":
              decode(s - 1, LM_FAULT_SLOTS)}
    faults = {k: float((f - want).abs().max()) for k, f in faults.items()}
    got = decode(s - 1)
    err = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    log(f"[lm consistency] S={s}, cache slots {ring} (ring), batch 2: "
        f"max|decode - prefill| = {err:.4e} (tolerance {LM_CONSIST_TOL}), "
        f"logits max {float(want.abs().max()):.3f}; argmax equal "
        f"{same.tolist()}, top-two margins {margin.tolist()}; planted "
        f"faults: " + ", ".join(f"{k} {v:.4e}" for k, v in faults.items()))
    need(ring < s - 1, "the consistency check did not reach a ring cache")
    need(err <= LM_CONSIST_TOL, "decode disagrees with prefill")
    need(min(faults.values()) > LM_CONSIST_TOL,
         "the consistency gate does not see a planted fault")
    need(bool((same | (margin <= LM_CONSIST_TOL)).all()),
         "decode and prefill pick another token beyond a near-tie")


def reduced_batch(torch, cfg, b, s, gen):
    """A prompt of b × s tokens on the CPU, with the image embeddings or
    encoder frames the reduced arch takes."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     dtype=torch.int32)}
    if cfg.vision is not None:
        batch["img_embeds"] = torch.randn(
            (b, cfg.vision.n_img_tokens, cfg.vision.embed_dim), generator=gen)
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn(
            (b, cfg.encoder.src_len, cfg.d_model), generator=gen)
    return batch


def phase_lm_parity(torch, arch=None, tag="[lm parity]", tol=LM_PARITY_TOL):
    """The reduced arch (f32; default danube) on the card against the CPU
    plain path, on the same weights and batch: identical greedy tokens,
    prefill and decode logits within ``tol``.  Prompt 48 > danube's
    window 32: ring caches."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.random import SeedKey
    from repro_torch.lm_serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.transformer import params_to

    cfg = get_reduced_config(arch or LM["arch"])
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = {"cpu": model.init(gen)}
    params["cuda"] = params_to(params["cpu"], "cuda")
    batch = reduced_batch(torch, cfg, 2, 48, gen)
    out, logits = {}, {}
    for dev in ("cpu", "cuda"):
        p = params[dev]
        t = {k: v.to(dev) for k, v in batch.items()}
        out[dev] = [generate(model, p, t, 24, SeedKey(0, True),
                             temperature=temp, top_k=top_k,
                             device=dev).cpu()
                    for temp, top_k in ((0.0, 0), (0.8, 40))]
        lg, cache = model.prefill(p, t)
        lg2, _ = model.decode_step(p, cache, t["tokens"][:, :1],
                                   cache["step_offset"])
        logits[dev] = (lg.cpu(), lg2.cpu())
    errs = [float((a - b).abs().max())
            for a, b in zip(logits["cpu"], logits["cuda"])]
    same = [bool(torch.equal(a, b)) for a, b in zip(out["cpu"], out["cuda"])]
    log(f"{tag} reduced {cfg.name} f32 (d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, window {cfg.attn.window}), prompt 48, 24 "
        f"tokens: greedy identical={same[0]}, top-k (noise on the CPU) "
        f"identical={same[1]}; max|logit diff| prefill {errs[0]:.3e}, "
        f"decode {errs[1]:.3e} (tolerance {tol})")
    need(same[0], "greedy tokens differ between the card and the CPU")
    need(max(errs) <= tol, "logits differ between the card and the CPU")
    return errs


def flash_staging_bytes(info, b, sq, skv, h, hkv, d, causal, window):
    """Bytes one call of the bf16 kernel stages from L2 into shared
    memory, reckoned from its tile sizes (``kernel_info``): each CTA's
    query tile once and each K/V block of its band once (q_offset 0).  A
    CTA's rows are (position, head) pairs of one GQA group, so it spans
    rows / n_rep positions.  Returns (total, K and V only)."""
    rows, bk, n_rep = info["rows"], info["block_kv"], h // hkv
    g = min(n_rep, rows)
    span = rows // g
    tiles = blocks = 0
    for q0 in range(0, sq, span):
        qhi = min(q0 + span, sq) - 1
        end = min(skv, qhi + 1) if causal else skv
        begin = max(0, q0 - window + 1) if window else 0
        kb0 = begin // bk
        blocks += ((end + bk - 1) // bk if end > begin else kb0) - kb0
        tiles += 1
    ctas = b * hkv * -(-n_rep // g)        # per position tile
    kv = ctas * blocks * 2 * bk * d * 2
    return kv + ctas * tiles * rows * d * 2, kv


def lm_flash_case(torch, dt, seed=3, heads=None, run=None):
    """Kernel 8's inputs at a prefill shape (default the lm main's: B 4,
    S 8192, H 32, Hkv 8, D 80, window 4096, causal) and its keyword
    arguments."""
    heads, run = heads or LM_HEADS, run or LM
    b, s = run["batch"], run["prompt_len"]
    h, hkv, d, w = (heads[x] for x in ("h", "hkv", "d", "window"))
    return (flash_inputs(torch, b, s, s, h, hkv, d, dt, seed=seed),
            dict(causal=True, window=w, softcap=0.0))


def time_flash(torch, q, k, v, kw, iters=10):
    """CUDA-event ms per call of kernel 8: ``iters`` calls after one."""
    from repro_torch.kernels.flash_attention import flash_attention

    return time_ms(torch, lambda: flash_attention(q, k, v, **kw),
                   iters=iters, warmup=1)


def time_flash_shape(torch, b, sq, skv, h, hkv, d, causal=True, window=0):
    """Kernel 8 at one shape (q_offset 0; self-attention when Sq = Skv):
    CUDA-event ms, f32 and bf16, beside its bound, its plain version (B
    1: the (B, H, Sq, Skv) scores of B 4 do not fit at S 8192) and SDPA
    with the same mask as a yardstick.  The bf16
    bound is the largest of three: the tensor cores' flops, the SFUs' one
    exp2 per valid pair, the bytes of Q, K, V and O once; beside it the
    L2 → shared-memory bytes the kernel stages per call and its registers
    and shared memory per CTA.  Returns per precision ms, plain_ms,
    bound_ms, bound_by, library_ms and the kernel's info."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        count_valid_pairs,
        flash_attention,
        flash_attention_ref,
        flash_cost,
        kernel_info,
    )
    from repro_torch.kernels.flash_attention.ref import attention_mask

    w = window
    # One copy of row 8's formulas: the package's, which the dry run's
    # meta route of the wrapper reports too.
    pairs = count_valid_pairs(sq, skv, causal, w)
    flops, _, exps = flash_cost(b, sq, skv, h, hkv, d, causal=causal,
                                window=w)
    torch.cuda.empty_cache()
    out = {}
    for prec, dt, peak in (("bf16", torch.bfloat16, BF16_TC_FLOPS),
                           ("f32", torch.float32, F32_PEAK_FLOPS)):
        q, k, v = flash_inputs(torch, b, sq, skv, h, hkv, d, dt, seed=3)
        kw = dict(causal=causal, window=w, softcap=0.0)
        _, nbytes, _ = flash_cost(b, sq, skv, h, hkv, d, causal=causal,
                                  window=w, itemsize=q.element_size())
        parts = {"operations": flops / peak * 1e3,
                 "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
        if prec == "bf16":
            parts["sfu"] = exps / SFU_OPS_PER_S * 1e3
        by = max(parts, key=parts.get)
        bd = parts[by]
        by = "operations" if by == "sfu" else by   # the SFUs' exp2s
        t = time_flash(torch, q, k, v, kw, iters=10 if prec == "bf16" else 3)
        q1, k1, v1 = q[:1], k[:1], v[:1]
        p = time_ms(torch, lambda: flash_attention_ref(q1, k1, v1, **kw),
                    iters=2, warmup=1)
        torch.cuda.empty_cache()
        lib = info = staged = staged_kv = None
        if prec == "bf16":
            info = kernel_info(dt, d)
            staged, staged_kv = flash_staging_bytes(info, b, sq, skv, h, hkv,
                                                    d, causal, w)
            # SDPA on (B, H, S, D) with the KV heads repeated and the same
            # boolean mask: a yardstick only, never called by the port.
            qt = q.transpose(1, 2)
            kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
            vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
            mask = attention_mask(sq, skv, causal=causal, window=w,
                                  q_offset=0, device=q.device)
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            diff = float((F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask).transpose(1, 2).float()
                - flash_attention(q, k, v, **kw).float()).abs().max())
            del qt, kt, vt, mask
        out[prec] = dict(ms=t, plain_ms=p, bound_ms=bd, bound_by=by,
                         library_ms=lib, info=info)
        sfu = (f", {exps:.4g} exp2 at {SFU_OPS_PER_S / 1e12:.3f} T/s "
               f"{parts['sfu']:.4f} ms" if "sfu" in parts else "")
        log(f"[timing] flash_attention {prec:4s} B={b} Sq={sq} Skv={skv} "
            f"H={h} Hkv={hkv} D={d} window={w} causal={causal}: "
            f"kernel_ms={t:.4f} "
            f"plain_ms={p:.4f} (at B=1) bound_ms={bd:.4f} (largest of: "
            f"{flops / 1e12:.3f} TFLOP at {peak / 1e12:g} TFLOP/s "
            f"{parts['operations']:.4f} ms{sfu}, {nbytes / 1e6:.1f} MB at "
            f"3.35 TB/s {parts['bytes']:.4f} ms) library_ms="
            f"{'n/a' if lib is None else f'{lib:.4f} (SDPA, same mask)'} "
            f"bound/kernel={bd / t:.3f} achieved "
            f"{flops / t / 1e9:.1f} TFLOP/s"
            + (f"; SDPA vs kernel max diff {diff:.3e}" if lib else ""))
        if prec == "f32":
            info32 = kernel_info(dt, d)
            log(f"[timing] flash_attention f32  kernel: "
                f"{info32['registers']} registers/thread, "
                f"{info32['spill_bytes']} spill bytes, "
                f"{info32['smem_bytes']} B shared/CTA, "
                f"{info32['ctas_per_sm']} CTAs/SM")
        if info is not None:
            kv_x = staged_kv / (2 * k.numel() * k.element_size())
            log(f"[timing] flash_attention {prec:4s} kernel: "
                f"{info['registers']} registers/thread, "
                f"{info['spill_bytes']} spill bytes, {info['smem_bytes']} B "
                f"shared/CTA, {info['threads']} threads/CTA, "
                f"{info['ctas_per_sm']} CTAs/SM, {info['rows']} (position, "
                f"head) rows x {info['block_kv']} keys per block; L2->shared "
                f"staging {staged / 1e9:.3f} GB/call (reckoned; K/V "
                f"{staged_kv / 1e9:.3f} GB, "
                f"{kv_x:.1f}x the K and V in device memory)")
        del q, k, v, q1, k1, v1
        torch.cuda.empty_cache()
    log(f"[timing] flash_attention valid (q, k) pairs per (b, h) at D={d}: "
        f"{pairs} of {sq * skv}")
    return out


def phase_lm_timing(torch, worst, launches):
    """Kernel 8 at the lm-main prefill shape (``time_flash_shape``): the
    kernels line's row."""
    b, s = LM["batch"], LM["prompt_len"]
    h, hkv, d, w = (LM_HEADS[x] for x in ("h", "hkv", "d", "window"))
    out = time_flash_shape(torch, b, s, s, h, hkv, d, True, w)
    log(f"[timing] flash_attention launches per lm main run "
        f"{launches['flash_attention']} ({LM_LAYERS} per prefill)")
    r, info = out["bf16"], out["bf16"]["info"]
    return [{
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"],
        "launches": launches["flash_attention"],
        "launches_per_call": LAUNCHES_PER_CALL["flash_attention"],
        "max_abs_err": worst["bf16"], "max_abs_err_f32": worst["f32"],
        "max_err_over_row_rms": worst["bf16_rel"],
        "dtype": "bf16", "ms": r["ms"], "plain_ms": r["plain_ms"],
        "plain_shape": f"B=1 S={s} H={h} Hkv={hkv} D={d}",
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "registers": info["registers"],
        "smem_bytes_per_cta": info["smem_bytes"],
        "library_ms": r["library_ms"], "ms_f32": out["f32"]["ms"],
        "plain_ms_f32": out["f32"]["plain_ms"],
        "bound_ms_f32": out["f32"]["bound_ms"],
    }]


def phase_hybrid_flash_timing(torch, launches):
    """Kernel 8 at head_dim 256, at ``[hybrid]``'s prefill shape (B 4, S
    8192, H 10, Hkv 1, window 2048, causal): a shape record for the
    kernels line's flash_attention row."""
    b, s = HYBRID["batch"], HYBRID["prompt_len"]
    h, hkv, d, w = (HYBRID_HEADS[x] for x in ("h", "hkv", "d", "window"))
    out = time_flash_shape(torch, b, s, s, h, hkv, d, True, w)
    log(f"[timing] flash_attention D=256 launches per hybrid run "
        f"{launches} ({HYBRID_FLASH_PER_PREFILL} per prefill)")
    r, info = out["bf16"], out["bf16"]["info"]
    return {"shape": f"B={b} S={s} H={h} Hkv={hkv} D={d} window={w} causal",
            "launches": launches, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "plain_shape": f"B=1 S={s} H={h} Hkv={hkv} D={d}",
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "registers": info["registers"],
            "spill_bytes": info["spill_bytes"],
            "smem_bytes_per_cta": info["smem_bytes"],
            "ms_f32": out["f32"]["ms"],
            "plain_ms_f32": out["f32"]["plain_ms"],
            "bound_ms_f32": out["f32"]["bound_ms"]}


# ---------------------------------------------------------------------------
# slice 9: the MoE archs and the RG-LRU hybrid
# ---------------------------------------------------------------------------

# [moe]: grok-1-314b and llama4-maverick-400b-a17b at published width
# (d_model, heads, d_ff, experts, top-k, vocab, bf16), depth cut to what
# one card holds beside what earlier phases keep.  Reckoned from the
# configs: an MoE layer's experts take 9.66 GB (grok-1) and 32.2 GB
# (llama4); embedding and untied head 3.2 and 4.1 GB; so grok-1 4 layers
# (≈ 42.6 GB) and llama4 1 layer (≈ 36.5 GB), one model at a time.  Batch
# 4, prompt 2048 (the expert hiddens of 8192 tokens stay near 1 GB), 32
# new tokens.
MOE_RUN = dict(batch=4, prompt_len=2048, new_tokens=32)
MOE_DEPTHS = {"grok-1-314b": 4, "llama4-maverick-400b-a17b": 1}
# The card's bf16 moe_apply at layer 0 against the MoE formula in f32 on
# the same weights and routing (one expert at a time, the expert's
# assignments in (token, rank) order up to the capacity), on the first
# MOE_CHECK_TOKENS tokens of layer 0's prefill input pushed MOE_SKEW along
# the router's expert-0 column, so expert 0 overflows and the capacity
# cut decides which tokens it serves.  Reading: max |out − f32| over the
# rows, over the rms of the f32 output's nonzero rows.  Two planted faults
# (the cut keeping each expert's last assignments instead of its first;
# one slot more a expert) are read the same way and must land above the
# gate.
MOE_CHECK_TOKENS = 2048
MOE_SKEW = 4.0
# Readings on the H100 80GB HBM3 at 700 W: sound 7.389e-02 (grok-1),
# 2.040e-02 (llama4); the faults at least 8.238 and 3.917; the gate is
# about the geometric mean of the larger sound and the weaker fault's.
MOE_GATE = 0.5
# [hybrid]: recurrentgemma-2b whole (26 layers: 18 rglru, 8 local_attn of
# head_dim 256, 10 query heads and 1 KV head, window 2048) at published
# width, bf16; batch 4, prompt 8192 (past the window: ring caches), 32
# new tokens.
HYBRID = dict(arch="recurrentgemma-2b", batch=4, prompt_len=8192,
              new_tokens=32)
HYBRID_HEADS = dict(h=10, hkv=1, d=256, window=2048)
HYBRID_FLASH_PER_PREFILL = 8
# Prefill S − 1, decode one, against prefill S, as [lm consistency], but
# in f32 (the served weights cast): in bf16 the two paths' rounding,
# through 26 random layers, reads 0.172 on the H100, beside planted
# faults of 0.195 (ring slots zeroed) and 0.227 (position S − 2), too
# close to gate; the bf16 reading is logged.  Planted faults: decoding at
# S − 2, every rglru layer's h zeroed, one 64-slot block of every
# attention layer's ring zeroed.  Readings in f32 on the H100 80GB HBM3 at
# 700 W: sound 4.470e-05; faults 1.336e-01, 2.644 and 9.909e-02; the
# limit is about the geometric mean of the sound and the weakest fault's,
# a factor 45–50 from each.
HYBRID_CONSIST_S = 6000
HYBRID_CONSIST_TOL = 2e-3
HYBRID_FAULT_SLOTS = (0, 64)
# The card's log-depth scan against a sequential float64 recurrence on
# layer 0's (a, b) at the [hybrid] prompt, batch row 0, the first
# SCAN_CHANNELS channels: max |h − h64| / max |h64|.  Planted faults:
# the combine with the left element's a where the right one's belongs,
# and the scan of a and b rounded to bf16.  Readings on the H100 80GB
# HBM3 at 700 W: sound 9.566e-08, faults 5.059e-01 and 2.505e-03; the
# gate is about the geometric mean of the sound and the weaker fault's.
SCAN_CHANNELS = 256
SCAN_GATE = 1.5e-5


def moe_plain_f32(torch, p, x, cfg):
    """The MoE layer's formula in f32, written independently of the
    port's dispatch: routing from ``moe.route`` (the bf16 router product),
    then per expert its assignments in (token, rank) order up to the
    capacity, its three products in f32 on the expert's weights cast one
    expert at a time, combined with the routing weights."""
    from repro_torch.models.layers import moe
    from repro_torch.models.layers.mlp import _act

    m = cfg.moe
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    _, top_w, top_e = moe.route(p, xt, cfg)
    t, k = top_e.shape
    cap = max(int(-(-(t * k) // m.n_experts) * m.capacity_factor), 1)
    flat_e, flat_w = top_e.reshape(-1), top_w.reshape(-1)
    xf = xt.float()
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for e in range(m.n_experts):
        idx = torch.nonzero(flat_e == e)[:, 0][:cap]
        if idx.numel() == 0:
            continue
        tok = idx // k
        xe = xf[tok]
        h = _act(cfg.activation, xe @ p["w1"][e].float())
        if m.gated:
            h = h * (xe @ p["w3"][e].float())
        y = h @ p["w2"][e].float()
        out.index_add_(0, tok, y * flat_w[idx][:, None])
    return out.reshape(x.shape)


def moe_reversed_dispatch(torch):
    """A planted fault: ``_dispatch_group`` whose capacity cut keeps each
    expert's last assignments (sorted by expert, then token descending;
    one device, so ``before`` is None)."""
    def dispatch(xt, flat_e, e, cap, topk, before=None):
        d, tk = xt.shape[1], flat_e.shape[0]
        ar = torch.arange(tk, device=xt.device)
        sort_idx = torch.argsort(flat_e * tk + (tk - 1 - ar), stable=True)
        sorted_e = flat_e[sort_idx]
        counts = torch.bincount(flat_e, minlength=e)
        starts = torch.cumsum(counts, 0) - counts
        pos = ar - starts[sorted_e]
        keep = pos < cap
        dest = torch.where(keep, sorted_e * cap + pos, e * cap)
        buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=xt.device)
        buf.index_add_(0, dest, xt[sort_idx // topk]
                       * keep[:, None].to(xt.dtype))
        return buf[:e * cap].reshape(e, cap, d), dest, keep, sort_idx, counts
    return dispatch


def moe_layer_check(torch, tag, p, h, cfg):
    """Layer 0's bf16 moe_apply on the card against ``moe_plain_f32`` on
    the skewed tokens, beside two planted faults; returns the readings."""
    from repro_torch.models.layers import moe

    x = h.reshape(-1, h.shape[-1])[:MOE_CHECK_TOKENS][None]
    r0 = p["router"][:, 0].float()
    x = (x.float() + MOE_SKEW * r0 / r0.norm()).to(h.dtype).contiguous()
    want = moe_plain_f32(torch, p, x, cfg)
    nonzero = want.reshape(-1, want.shape[-1]).abs().amax(-1) > 0
    scale = float(want.reshape(-1, want.shape[-1])[nonzero].pow(2).mean()
                  .sqrt())

    def reading():
        got, _ = moe.moe_apply(p, x, cfg)
        return float((got.float() - want).abs().max()) / scale

    counts, kept, cap = moe.dispatch_counts(p, x, cfg)
    sound = reading()
    real_dispatch, real_cap = moe._dispatch_group, moe.expert_capacity
    try:
        moe._dispatch_group = moe_reversed_dispatch(torch)
        f_order = reading()
        moe._dispatch_group = real_dispatch
        moe.expert_capacity = lambda tk, e, f: real_cap(tk, e, f) + 1
        f_cap = reading()
    finally:
        moe._dispatch_group, moe.expert_capacity = real_dispatch, real_cap
    routed = counts[:4].tolist()
    log(f"{tag} layer 0 bf16 moe_apply vs f32 formula on {x.shape[1]} "
        f"tokens skewed {MOE_SKEW} toward expert 0 (routed {routed}..., "
        f"cap {cap}, dropped {int((counts - kept).sum())}; "
        f"{int(nonzero.sum())} nonzero rows, rms {scale:.4e}): max_err/rms "
        f"= {sound:.4e} (gate {MOE_GATE}); planted faults: last "
        f"assignments kept {f_order:.4e}, one slot more {f_cap:.4e}")
    need(int(counts[0]) > cap, "the skewed tokens did not overflow "
         "expert 0")
    need(sound <= MOE_GATE, f"{tag} bf16 moe_apply disagrees with the f32 "
         "formula")
    need(min(f_order, f_cap) > MOE_GATE, f"{tag} the MoE gate does not "
         "see a planted fault")
    return {"sound": sound, "reversed_order": f_order, "cap_plus_1": f_cap}


def phase_moe(torch):
    """grok-1 and llama4-maverick at published width through serve_lm,
    depth cut (MOE_DEPTHS), one model at a time: flash launches = layers ×
    prefills, greedy and top-k checks, layer 0's routed, kept and dropped
    assignments per expert against the capacity, a finite aux loss, and
    layer 0 in bf16 against the f32 formula (MOE_GATE)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.layers import moe

    out = {}
    for arch, depth in MOE_DEPTHS.items():
        t_arch = time.perf_counter()
        full = get_config(arch)
        seen = []
        real = transformer.moe_apply

        def spy(p, x, cfg):
            if not seen:          # layer 0's input in the first prefill
                seen.append(x)
            return real(p, x, cfg)

        transformer.moe_apply = spy
        try:
            runs, launches, peak, held = serve_runs(
                torch, "[moe]", arch, MOE_RUN, n_layers=depth)
        finally:
            transformer.moe_apply = real
        res = runs["top-k"]
        cfg, model, params = res["cfg"], res["model"], res["params"]
        a, m = cfg.attn, cfg.moe
        log(f"[moe] {cfg.name} published width: d_model {cfg.d_model}, "
            f"{a.n_heads} query / {a.n_kv_heads} KV heads of {a.head_dim}, "
            f"softcap {a.softcap}, d_ff {cfg.d_ff}, {m.n_experts} experts "
            f"top-{m.top_k}, capacity factor {m.capacity_factor}, vocab "
            f"{cfg.vocab_size}, {cfg.dtype}; depth cut: {depth} of "
            f"{full.n_layers} layers; random weights (seed 0); batch "
            f"{MOE_RUN['batch']}, prompt {MOE_RUN['prompt_len']}, "
            f"{MOE_RUN['new_tokens']} new tokens")
        log(f"[moe] {cfg.name} max_memory_allocated={peak} bytes, "
            f"{peak - held} above the {held} that earlier phases hold; "
            f"flash_attention launches={launches}")
        need(launches == 2 * depth, f"{arch}: flash_attention launched "
             f"{launches} times in two prefills of {depth} layers")
        check_first_tokens(torch, "[moe]", runs, MOE_RUN["new_tokens"])
        p0 = params["layers"][0]["moe"]
        counts, kept, cap = moe.dispatch_counts(p0, seen[0], cfg)
        t = seen[0].shape[0] * seen[0].shape[1]
        dropped = counts - kept
        log(f"[moe] {cfg.name} layer 0 of the prefill: {t} tokens x top-"
            f"{m.top_k} over {m.n_experts} experts, cap {cap}; routed "
            f"{counts.tolist()}; dropped {dropped.tolist()} "
            f"({int(dropped.sum())} of {t * m.top_k})")
        need(int(counts.sum()) == t * m.top_k, "routed assignments do not "
             "add up to T·k")
        need(torch.equal(kept, torch.clamp(counts, max=cap)),
             "an expert kept other than min(routed, cap)")
        x = model._embed_tokens(params, res["prompt"])
        _, _, aux = model._backbone(params, x, impl="kernel")
        log(f"[moe] {cfg.name} aux loss over {depth} layers: {float(aux):.6f}")
        need(bool(torch.isfinite(aux)), "the MoE aux loss is not finite")
        readings = moe_layer_check(torch, f"[moe] {cfg.name}", p0, seen[0],
                                   cfg)
        phase_profile(torch, served_profile_runs(f"moe {arch}", res))
        out[arch] = {"layers": depth, "published_layers": full.n_layers,
                     "prefill_s": res["prefill_s"],
                     "decode_s_per_token": res["decode_s_per_token"],
                     "peak": peak, "launches": launches, **readings}
        del runs, res, model, params, p0, seen, x
        torch.cuda.empty_cache()
        log(f"[moe] {cfg.name} took {time.perf_counter() - t_arch:.1f} s")
    return out


def scan_left_a(torch, a, b):
    """A planted fault: the Hillis–Steele scan whose combine multiplies
    the earlier element's b by its own a instead of the later one's."""
    s, step = a.shape[1], 1
    while step < s:
        a_new, b_new = a.clone(), b.clone()
        a_new[:, step:] = a[:, step:] * a[:, :-step]
        b_new[:, step:] = a[:, :-step] * b[:, :-step] + b[:, step:]
        a, b = a_new, b_new
        step *= 2
    return b


def phase_hybrid_scan(torch, p, x, cfg):
    """Layer 0's (a, b) from its prefill input x: the card's linear_scan
    against a sequential float64 recurrence on the CPU (batch row 0, the
    first SCAN_CHANNELS channels), beside two planted faults."""
    import numpy as np

    from repro_torch.models.layers import rglru

    branch = x @ p["w_in"]
    xc = rglru._causal_conv(branch, p["conv"])
    a, b = rglru._gates(p, xc, cfg.recurrent.c_exponent)
    a, b = a[:1, :, :SCAN_CHANNELS], b[:1, :, :SCAN_CHANNELS]
    s = a.shape[1]
    h = rglru.linear_scan(a, b)
    bf16 = rglru.linear_scan(a.bfloat16().float(), b.bfloat16().float())
    left = scan_left_a(torch, a, b)
    a64, b64 = a[0].double().cpu().numpy(), b[0].double().cpu().numpy()
    h64 = np.empty_like(b64)
    hh = np.zeros(b64.shape[1])
    for i in range(s):
        hh = a64[i] * hh + b64[i]
        h64[i] = hh
    top = float(np.abs(h64).max())

    def rel(hc):
        return float(np.abs(hc[0].double().cpu().numpy() - h64).max()) / top

    sound, f_left, f_bf16 = rel(h), rel(left), rel(bf16)
    log(f"[hybrid] scan: layer 0's (a, b) at S {s}, {SCAN_CHANNELS} "
        f"channels (a in [{float(a.min()):.4f}, {float(a.max()):.4f}]): "
        f"max|h - h64|/max|h64| = {sound:.4e} (gate {SCAN_GATE}); planted "
        f"faults: the left a in the combine {f_left:.4e}, a and b in bf16 "
        f"{f_bf16:.4e}")
    need(sound <= SCAN_GATE, "the scan disagrees with the float64 "
         "recurrence")
    need(min(f_left, f_bf16) > SCAN_GATE, "the scan gate does not see a "
         "planted fault")
    return {"sound": sound, "left_a": f_left, "bf16": f_bf16}


def phase_hybrid_consistency(torch, model, params):
    """Prefill S − 1 tokens (ring caches and RG-LRU states), decode token
    S − 1, against the last logits of prefilling all S: in f32 on the
    served weights cast to f32, within HYBRID_CONSIST_TOL, three planted
    faults above it; the same in bf16, logged."""
    import dataclasses

    from repro_torch.models import build_model

    cfg = model.cfg
    s = HYBRID_CONSIST_S
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, s), generator=gen,
                        device="cuda", dtype=torch.int32)

    def readings(m, p, faults):
        want, _ = m.prefill(p, {"tokens": tok})
        _, cache = m.prefill(p, {"tokens": tok[:, :-1]})

        def decode(pos, fault=None):
            layers = [type(lc)(*(t.clone() for t in lc))
                      for lc in cache["layers"]]
            for i, lc in enumerate(layers):
                if fault == "h" and m.kind(i) == "rglru":
                    lc.h.zero_()
                if fault == "slots" and m.kind(i) != "rglru":
                    lc.k[:, HYBRID_FAULT_SLOTS[0]:HYBRID_FAULT_SLOTS[1]] = 0
                    lc.v[:, HYBRID_FAULT_SLOTS[0]:HYBRID_FAULT_SLOTS[1]] = 0
            out, _ = m.decode_step(p, {"layers": layers}, tok[:, -1:],
                                   torch.full((2,), pos, dtype=torch.int32,
                                              device="cuda"))
            return float((out.float() - want.float()).abs().max())

        found = {}
        if faults:
            found = {"position S-2": decode(s - 2),
                     "rglru h zeroed": decode(s - 1, "h"),
                     f"ring slots {HYBRID_FAULT_SLOTS[0]}:"
                     f"{HYBRID_FAULT_SLOTS[1]} zeroed": decode(s - 1,
                                                               "slots")}
        ring = [lc for i, lc in enumerate(cache["layers"])
                if m.kind(i) != "rglru"][0].k.shape[1]
        return decode(s - 1), found, ring, float(want.float().abs().max())

    err16, _, _, _ = readings(model, params, False)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    err, faults, ring, top = readings(build_model(cfg32), cast_f32(params),
                                    True)
    torch.cuda.empty_cache()
    log(f"[hybrid consistency] S={s}, ring caches of {ring} slots, batch "
        f"2, f32 (the served weights cast): max|decode - prefill| = "
        f"{err:.4e} (tolerance {HYBRID_CONSIST_TOL}), logits max "
        f"{top:.3f}; planted faults: "
        + ", ".join(f"{k} {v:.4e}" for k, v in faults.items())
        + f"; bf16, as served: {err16:.4e}")
    need(ring < s - 1, "the consistency check did not reach a ring cache")
    need(err <= HYBRID_CONSIST_TOL, "hybrid decode disagrees with prefill")
    need(min(faults.values()) > HYBRID_CONSIST_TOL,
         "the hybrid consistency gate does not see a planted fault")
    return err, faults, err16


def served_profile_runs(tag, res):
    """One prefill of a served run's batch and 4 greedy decode steps
    from its cache (made before the profiled window), for
    ``phase_profile``."""
    model, params, batch = res["model"], res["params"], res["batch"]
    _, cache = model.prefill(params, batch)
    tok = res["tokens"][:, :1].contiguous()

    def decode4():
        for i in range(4):
            model.decode_step(params, cache, tok, cache["step_offset"] + i)

    return {f"{tag} prefill": lambda: model.prefill(params, batch),
            f"{tag} decode x4": decode4}


def phase_hybrid(torch):
    """recurrentgemma-2b whole at published width through serve_lm: 8
    flash launches per prefill (kernel 8 at head_dim 256), greedy and
    top-k checks, prefill → decode consistency, the scan against float64."""
    from repro_torch.models import transformer

    seen = []
    real = transformer.rglru_apply

    def spy(p, x, cfg, state=None):
        if not seen:              # layer 0's input in the first prefill
            seen.append(x)
        return real(p, x, cfg, state)

    transformer.rglru_apply = spy
    run = {k: v for k, v in HYBRID.items() if k != "arch"}
    try:
        runs, launches, peak, held = serve_runs(torch, "[hybrid]",
                                                HYBRID["arch"], run)
    finally:
        transformer.rglru_apply = real
    res = runs["top-k"]
    cfg, model, params = res["cfg"], res["model"], res["params"]
    kinds = [model.kind(i) for i in range(cfg.n_layers)]
    log(f"[hybrid] {cfg.name} published width, whole: {cfg.n_layers} "
        f"layers ({kinds.count('rglru')} rglru of width "
        f"{cfg.recurrent.width}, {kinds.count('local_attn')} local_attn: "
        f"{cfg.attn.n_heads} query / {cfg.attn.n_kv_heads} KV heads of "
        f"{cfg.attn.head_dim}, window {cfg.attn.window}), d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (tied), "
        f"{cfg.dtype}; random weights (seed 0); batch {HYBRID['batch']}, "
        f"prompt {HYBRID['prompt_len']}, {HYBRID['new_tokens']} new tokens")
    log(f"[hybrid] max_memory_allocated={peak} bytes, {peak - held} above "
        f"the {held} that earlier phases hold; flash_attention "
        f"launches={launches} ({launches / 2:g} per prefill)")
    need(launches == 2 * HYBRID_FLASH_PER_PREFILL,
         f"flash_attention launched {launches} times in two prefills, not "
         f"{HYBRID_FLASH_PER_PREFILL} each")
    check_first_tokens(torch, "[hybrid]", runs, HYBRID["new_tokens"])
    err, faults, err16 = phase_hybrid_consistency(torch, model, params)
    scan = phase_hybrid_scan(torch, params["layers"][0]["rglru"], seen[0],
                             cfg)
    phase_profile(torch, served_profile_runs("hybrid", res))
    out = {"prefill_s": res["prefill_s"],
           "decode_s_per_token": res["decode_s_per_token"], "peak": peak,
           "launches": launches, "consistency": err,
           "consistency_bf16": err16, "faults": faults,
           "scan": scan}
    del runs, res, model, params, seen
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice 10: xLSTM, the encoder-decoder and the image-token prefix
# ---------------------------------------------------------------------------

# [xlstm]: xlstm-125m whole (12 layers: 9 mlstm, 3 slstm; d_model 768, 4
# heads of 192, chunk 256, vocab 50304 tied) at published width, bf16;
# batch 4, prompt 2048, 32 new tokens.  No attention: kernel 8 never
# launches.  The prompt is cut from the other phases' 8192: the sLSTM's
# host loop over time (ROADMAP fault 3.8) took 1.9–3.0 s a layer at
# 8192, 5.7–11.7 s a prefill, and the phase 390 s at 8192 on the H100
# (PERF.md).  Its profile replays a prefill of the first
# XLSTM_PROFILE_TOKENS tokens: the profiler's bookkeeping of the loop's
# small launches (about 600,000 at 8192) took most of those 390 s.
XLSTM = dict(arch="xlstm-125m", batch=4, prompt_len=2048, new_tokens=32)
XLSTM_PROFILE_TOKENS = 256
# [whisper]: whisper-base whole (6 encoder and 6 decoder layers, d_model
# 512, 8 heads of 64, d_ff 2048, vocab 51865) at published width, bf16;
# batch 4, 1500 encoder frames, decoder prompt 384, 32 new tokens.
# Kernel 8 per prefill: 6 encoder calls (non-causal, 1500 × 1500), 6
# causal self-attention calls (384 × 384) and 6 cross-attention calls
# (non-causal, 384 × 1500); per decode step 6 cross-attention calls (1 ×
# 1500), the self-attention decoding from its KV cache.
WHISPER = dict(arch="whisper-base", batch=4, prompt_len=384, new_tokens=32)
WHISPER_HEADS = dict(h=8, hkv=8, d=64)
WHISPER_FLASH = {"encoder": 6, "self": 6, "cross": 6}   # per prefill
WHISPER_FLASH_PER_DECODE = 6
# [vlm]: internvl2-2b whole (24 layers, d_model 2048, 16 query / 8 KV
# heads of 128, d_ff 8192, vocab 92553) at published width, bf16; batch 4,
# 256 image tokens + prompt 7680 (7936 + 64 of headroom ≤ max_seq 8192),
# 32 new tokens; kernel 8 once per layer and prefill, at S 7936.
VLM = dict(arch="internvl2-2b", batch=4, prompt_len=7680, new_tokens=32)
VLM_HEADS = dict(h=16, hkv=8, d=128)
VLM_FLASH_PER_PREFILL = 24
# Prefill S − 1 text tokens, decode one, against prefilling all S, as
# [hybrid consistency]: gated in f32 on the served weights cast (served,
# the xLSTM state passes through bf16 between prefill and decode: the
# bf16 reading is logged).  S per arch (xlstm's 5999 pads its last chunk
# of 256 with 145 state-neutral steps: the carried state must come out
# exact) and the planted faults, each decoded from a copy of the same
# cache (SLICE10_FAULTS).  Readings in f32 on the H100 80GB HBM3 at 700
# W: xlstm sound 8.731e-04, faults 6.752 (token S − 2 decoded), 5.468
# (every mLSTM C zeroed), 2.446 (every sLSTM c zeroed); whisper sound
# 3.576e-06, faults 6.223e-02 (position S − 2), 3.183 (enc_out zeroed),
# 5.250e-01 (every layer's KV slots 0:64 zeroed); internvl2 sound
# 2.396e-05, faults 2.179 (position S − 2), 2.511 (the image prefix's
# K/V zeroed in every layer).  Each gate is about the geometric mean of
# the sound reading and the weakest fault's (xlstm's a factor 57 and 49
# from them; whisper's 140 and 124; internvl2's 290 and 310).  The
# xLSTM's sound reading is the largest: 12 layers of mLSTM divide by
# max(|nᵀq|, e^{−m}) after 6000 steps summed in two orders (chunks of
# 256 against the one-step recurrence).
SLICE10_CONSIST = {
    "xlstm-125m": dict(s=6000, tol=0.05),
    "whisper-base": dict(s=WHISPER["prompt_len"], tol=5e-4),
    "internvl2-2b": dict(s=2048, tol=7e-3),
}
# The reduced archs on the card against the CPU ([... parity]): the lm
# main's tolerance, but 5e-4 for xlstm-125m.  Its 8 reduced layers pass
# rounding on 2–3× amplified (the mLSTM's division), so on the CPU the
# reference's own logits move by up to 4.5e-4 when its weights get half
# an ulp of seeded noise (tests/test_torch_encdec_vlm.py); card against
# CPU read 1.695e-04 (prefill) and 2.821e-04 (decode) on the H100 80GB
# HBM3 at 700 W, with identical greedy and top-k tokens.
SLICE10_PARITY_TOL = {"xlstm-125m": 5e-4}
# Kernel 8's launches of a whisper serve run, by what called it.
WHISPER_CALLS = ("encoder", "self", "cross prefill", "cross decode")


def flash_spy():
    """Wrap kernel 8's wrapper where the model calls it (attention.py's
    prefill self-attention, transformer.py's encoder and
    cross-attention), recording each call's (Sq, Skv, causal); the launch
    counter stays the wrapper's own.  Returns the record list and a
    function that undoes the wrap."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer
    from repro_torch.models.layers import attention

    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], bool(kw.get("causal", True))))
        return flash_attention(q, k, v, **kw)

    attention.flash_attention = transformer.flash_attention = spy

    def undo():
        attention.flash_attention = flash_attention
        transformer.flash_attention = flash_attention

    return calls, undo


def clone_cache(cache):
    """A copy of a decode cache: every layer's tensors, the step offset
    and the encoder's output."""
    out = {"layers": [type(lc)(*(t.clone() for t in lc))
                      for lc in cache["layers"]],
           "step_offset": cache["step_offset"].clone()}
    if "enc_out" in cache:
        out["enc_out"] = cache["enc_out"].clone()
    return out


def _fault_zero_state(kind, field):
    def edit(model, c, tok, pos, batch):
        for i, lc in enumerate(c["layers"]):
            if model.kind(i) == kind:
                getattr(lc, field).zero_()
        return tok, pos
    return edit


def _fault_zero_kv(lo, hi):
    def edit(model, c, tok, pos, batch):
        for lc in c["layers"]:
            lc.k[:, lo:hi] = 0
            lc.v[:, lo:hi] = 0
        return tok, pos
    return edit


def _fault_position(model, c, tok, pos, batch):
    return tok, pos - 1


def _fault_token(model, c, tok, pos, batch):
    return batch["tokens"][:, -2:-1], pos


def _fault_enc_out(model, c, tok, pos, batch):
    c["enc_out"].zero_()
    return tok, pos


SLICE10_FAULTS = {
    "xlstm-125m": {"token S-2 decoded": _fault_token,
                   "mLSTM C zeroed": _fault_zero_state("mlstm", "C"),
                   "sLSTM c zeroed": _fault_zero_state("slstm", "c")},
    "whisper-base": {"position S-2": _fault_position,
                     "enc_out zeroed": _fault_enc_out,
                     "KV slots 0:64 zeroed": _fault_zero_kv(0, 64)},
    "internvl2-2b": {"position S-2": _fault_position,
                     "image prefix K/V zeroed": _fault_zero_kv(0, 256)},
}


def cast_f32(tree):
    """A parameter tree with every tensor cast to f32."""
    if isinstance(tree, dict):
        return {k: cast_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_f32(v) for v in tree]
    return tree.float()


def slice10_consistency(torch, tag, model, params):
    """Prefill S − 1 text tokens (behind the image prefix, beside the
    encoder frames), decode token S − 1, against the last logits of
    prefilling all S: in f32 on the served weights cast, within the
    arch's gate, each planted fault above it; the same in bf16,
    logged."""
    import dataclasses

    from repro_torch.models import build_model

    cfg = model.cfg
    spec, faults = SLICE10_CONSIST[cfg.name], SLICE10_FAULTS[cfg.name]
    s = spec["s"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, s), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    if cfg.vision is not None:
        batch["img_embeds"] = torch.randn(
            (2, cfg.vision.n_img_tokens, cfg.vision.embed_dim),
            generator=gen, device="cuda")
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn(
            (2, cfg.encoder.src_len, cfg.d_model), generator=gen,
            device="cuda")

    def readings(m, p, with_faults):
        want, _ = m.prefill(p, batch)
        _, cache = m.prefill(p, dict(batch, tokens=batch["tokens"][:, :-1]))

        def decode(edit=None):
            c = clone_cache(cache)
            tok, pos = batch["tokens"][:, -1:], cache["step_offset"]
            if edit is not None:
                tok, pos = edit(m, c, tok, pos, batch)
            out, _ = m.decode_step(p, c, tok, pos)
            return float((out.float() - want.float()).abs().max())

        found = ({k: decode(f) for k, f in faults.items()} if with_faults
                 else {})
        return decode(), found, float(want.float().abs().max())

    err16, _, _ = readings(model, params, False)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = cast_f32(params)
    err, found, top = readings(build_model(cfg32), p32, True)
    del p32
    torch.cuda.empty_cache()
    tol = spec["tol"]
    log(f"{tag} consistency: S={s} text tokens"
        + (f" behind {cfg.vision.n_img_tokens} image tokens"
           if cfg.vision is not None else "")
        + f", batch 2, f32 (the served weights cast): max|decode - "
        f"prefill| = {err:.4e} (gate {tol}), logits max {top:.3f}; planted "
        "faults: " + ", ".join(f"{k} {v:.4e}" for k, v in found.items())
        + f"; bf16, as served: {err16:.4e}")
    if tol is not None:
        need(err <= tol, f"{cfg.name}: decode disagrees with prefill")
        need(min(found.values()) > tol,
             f"{cfg.name}: the consistency gate does not see a planted "
             "fault")
    return {"sound": err, "faults": found, "bf16": err16, "gate": tol}


def slice10_serve(torch, tag, run):
    """serve_lm at full width through ``serve_runs`` with kernel 8's calls
    recorded; logs the model and the launches."""
    calls, undo = flash_spy()
    try:
        runs, launches, peak, held = serve_runs(
            torch, tag, run["arch"],
            {k: v for k, v in run.items() if k != "arch"})
    finally:
        undo()
    res = runs["top-k"]
    cfg, model = res["cfg"], res["model"]
    kinds = [model.kind(i) for i in range(cfg.n_layers)]
    shape = ", ".join(f"{kinds.count(k)} {k}" for k in sorted(set(kinds)))
    extra = ""
    if cfg.is_encdec:
        extra = (f", encoder {cfg.encoder.n_layers} layers over "
                 f"{cfg.encoder.src_len} frames")
    if cfg.vision is not None:
        extra = (f", {cfg.vision.n_img_tokens} image tokens of "
                 f"{cfg.vision.embed_dim} projected in front")
    heads = (f"{cfg.attn.n_heads} query / {cfg.attn.n_kv_heads} KV heads of "
             f"{cfg.attn.head_dim}")
    if cfg.xlstm is not None:
        heads = (f"{cfg.xlstm.n_heads} heads of {cfg.xlstm.head_dim}, chunk "
                 f"{cfg.xlstm.chunk_size}")
    log(f"{tag} {cfg.name} published width, whole: {cfg.n_layers} layers "
        f"({shape}){extra}, d_model {cfg.d_model}, {heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; random "
        f"weights (seed 0); batch {run['batch']}, prompt "
        f"{run['prompt_len']}, {run['new_tokens']} new tokens")
    log(f"{tag} max_memory_allocated={peak} bytes, {peak - held} above the "
        f"{held} that earlier phases hold; flash_attention "
        f"launches={launches}")
    need(len(calls) == launches, f"{tag}: {len(calls)} calls of kernel 8's "
         f"wrapper, {launches} launches")
    return runs, res, launches, calls, peak


def slice10_finish(torch, tag, runs, res, launches, peak, extra=None,
                   profile_tokens=None):
    """The checks every slice-10 phase shares: first tokens, the
    consistency gate, the reduced arch on the card against the CPU, the
    profile (of a prefill of the first ``profile_tokens`` prompt tokens
    when given).  Returns the phase's record."""
    cfg = res["cfg"]
    check_first_tokens(torch, tag, runs, res["tokens"].shape[1])
    consist = slice10_consistency(torch, tag, res["model"], res["params"])
    parity = phase_lm_parity(torch, cfg.name, f"{tag} parity",
                             SLICE10_PARITY_TOL.get(cfg.name, LM_PARITY_TOL))
    name, prof = cfg.name, res
    if profile_tokens is not None:
        name = f"{cfg.name} (first {profile_tokens} tokens)"
        prof = dict(res, batch={k: v[:, :profile_tokens]
                                for k, v in res["batch"].items()})
    phase_profile(torch, served_profile_runs(name, prof))
    out = {"prefill_s": res["prefill_s"],
           "decode_s_per_token": res["decode_s_per_token"],
           "tok_s": res["tok_s"], "peak": peak, "launches": launches,
           "consistency": consist, "parity": parity, **(extra or {})}
    return out


def xlstm_host_loops(torch, res):
    """Host seconds of one mLSTM layer's chunk loop and one sLSTM layer's
    time loop at the served batch and prompt (the served dtype, the first
    layer of each kind's weights, unit inputs), each once after a warm-up
    at 256 steps."""
    from repro_torch.models.layers import xlstm

    cfg, params = res["cfg"], res["params"]
    b, s = res["prompt"].shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    dt = params["embed"].dtype
    a = torch.randn((b, s, cfg.d_model), generator=gen,
                    device="cuda").to(dt)
    kinds = [res["model"].kind(j) for j in range(cfg.n_layers)]
    out = {}
    for kind, fn in (("mlstm", xlstm.mlstm_chunkwise),
                     ("slstm", xlstm.slstm_scan)):
        p = params["layers"][kinds.index(kind)]["xlstm"]
        st = xlstm.init_xlstm_state(kind, b, cfg, dt, "cuda")
        fn(p, a[:, :256], cfg.xlstm, st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(p, a, cfg.xlstm, st)
        torch.cuda.synchronize()
        out[kind] = time.perf_counter() - t0
    total = sum(out[k] * kinds.count(k) for k in out)
    log(f"[xlstm] host loops at B={b} S={s}: mlstm_chunkwise "
        f"{out['mlstm']:.4f} s a layer ({s // cfg.xlstm.chunk_size} chunks), "
        f"slstm_scan {out['slstm']:.4f} s a layer ({s} steps); "
        f"{kinds.count('mlstm')} + {kinds.count('slstm')} layers = "
        f"{total:.4f} s of the {res['prefill_s']:.4f} s prefill")
    return out


def phase_xlstm(torch):
    """xlstm-125m whole at published width through serve_lm: no kernel 8
    launch, the greedy and top-k checks, the consistency gate, the
    reduced arch card against CPU, the host loops' seconds, the
    profile."""
    runs, res, launches, calls, peak = slice10_serve(torch, "[xlstm]", XLSTM)
    need(launches == 0, f"[xlstm]: kernel 8 launched {launches} times")
    loops = xlstm_host_loops(torch, res)
    out = slice10_finish(torch, "[xlstm]", runs, res, launches, peak,
                         {"host_loops_s": loops}, XLSTM_PROFILE_TOKENS)
    del runs, res
    torch.cuda.empty_cache()
    return out


def phase_whisper(torch):
    """whisper-base whole at published width through serve_lm: kernel 8
    exactly 18 times a prefill (6 encoder, 6 causal self, 6 cross) and 6
    times a decode step, then the shared checks."""
    runs, res, launches, calls, peak = slice10_serve(torch, "[whisper]",
                                                     WHISPER)
    src, s = res["cfg"].encoder.src_len, WHISPER["prompt_len"]
    kind_of = {(src, src, False): "encoder", (s, s, True): "self",
               (s, src, False): "cross prefill", (1, src, False):
               "cross decode"}
    by = {k: 0 for k in WHISPER_CALLS}
    for c in calls:
        by[kind_of.get(c, "other")] = by.get(kind_of.get(c, "other"), 0) + 1
    prefills, steps = 2, 2 * (WHISPER["new_tokens"] - 1)
    want = {"encoder": prefills * WHISPER_FLASH["encoder"],
            "self": prefills * WHISPER_FLASH["self"],
            "cross prefill": prefills * WHISPER_FLASH["cross"],
            "cross decode": steps * WHISPER_FLASH_PER_DECODE}
    log(f"[whisper] kernel 8 launches by call: "
        + ", ".join(f"{k} {v}" for k, v in by.items())
        + f" (want {want}: {sum(WHISPER_FLASH.values())} per prefill + "
        f"{WHISPER_FLASH_PER_DECODE} per decode step, {prefills} prefills "
        f"and {steps} decode steps)")
    need(by == want and launches == sum(want.values()),
         f"[whisper]: kernel 8 launches {by}, not {want}")
    out = slice10_finish(torch, "[whisper]", runs, res, launches, peak,
                         {"launches_by": by, "src_len": src})
    del runs, res
    torch.cuda.empty_cache()
    return out


def phase_vlm(torch):
    """internvl2-2b whole at published width through serve_lm: kernel 8
    exactly 24 times a prefill, at S = 256 image + 7680 text tokens, then
    the shared checks."""
    runs, res, launches, calls, peak = slice10_serve(torch, "[vlm]", VLM)
    n = res["cfg"].vision.n_img_tokens + VLM["prompt_len"]
    log(f"[vlm] kernel 8 launches={launches} ({launches / 2:g} per prefill"
        f"), every one at Sq = Skv = {n}: "
        f"{all(c == (n, n, True) for c in calls)}")
    need(launches == 2 * VLM_FLASH_PER_PREFILL
         and all(c == (n, n, True) for c in calls),
         f"[vlm]: kernel 8 launched {launches} times, not "
         f"{VLM_FLASH_PER_PREFILL} a prefill at S {n}")
    out = slice10_finish(torch, "[vlm]", runs, res, launches, peak,
                         {"seq": n})
    del runs, res
    torch.cuda.empty_cache()
    return out


def phase_slice10_flash_timing(torch, whisper, vlm):
    """Kernel 8 at the whisper encoder's, cross-attention's (prefill and
    decode) and internvl2's prefill shapes (``time_flash_shape``): shape
    records for the kernels line's flash_attention row, each with its
    launches in the phase's two serve runs."""
    b = WHISPER["batch"]
    h, hkv, d = (WHISPER_HEADS[x] for x in ("h", "hkv", "d"))
    src, s, n = whisper["src_len"], WHISPER["prompt_len"], vlm["seq"]
    by = whisper["launches_by"]
    shapes = {
        "whisper_encoder_shape": ((b, src, src, h, hkv, d, False, 0),
                                  by["encoder"]),
        "whisper_cross_shape": ((b, s, src, h, hkv, d, False, 0),
                                by["cross prefill"]),
        "whisper_cross_decode_shape": ((b, 1, src, h, hkv, d, False, 0),
                                       by["cross decode"]),
        "internvl2_prefill_shape": (
            (VLM["batch"], n, n, VLM_HEADS["h"], VLM_HEADS["hkv"],
             VLM_HEADS["d"], True, 0), vlm["launches"]),
    }
    recs = {}
    for name, (shp, launches) in shapes.items():
        out = time_flash_shape(torch, *shp)
        r, info = out["bf16"], out["bf16"]["info"]
        bb, sq, skv, hh, hk, dd, causal, _ = shp
        log(f"[timing] flash_attention {name}: launches in the phase's "
            f"two serve runs {launches}")
        recs[name] = {
            "shape": f"B={bb} Sq={sq} Skv={skv} H={hh} Hkv={hk} D={dd} "
                     f"{'causal' if causal else 'non-causal'}",
            "launches": launches, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "plain_shape": f"B=1 Sq={sq} Skv={skv} H={hh} Hkv={hk} D={dd}",
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "registers": info["registers"],
            "smem_bytes_per_cta": info["smem_bytes"],
            "ms_f32": out["f32"]["ms"],
            "plain_ms_f32": out["f32"]["plain_ms"],
            "bound_ms_f32": out["f32"]["bound_ms"]}
    return recs


# ---------------------------------------------------------------------------
# slice 11: training
# ---------------------------------------------------------------------------

# [train]: smollm-135m at its published width and depth (30 layers,
# d_model 576, 9 heads / 3 KV heads of 64, vocab 49,152), bf16 parameters
# with an f32 master, remat on, through repro_torch.train.loop.train_loop
# with the reference CLI's selection defaults: DASH on grad features
# (embed_dim_cap 32, 4 samples), selection every 2 steps from a pool 4 ×
# the period's examples, batch 8 × 2048 tokens of make_lm_tokens, 8
# steps, warmup 2; then the same run with a failure at step 5 (inside
# period 2) and checkpoints every 2 steps under a temporary directory.
# Reckoned: 134.5 M parameters, 0.27 GB in bf16, 2.2 GB of f32 master,
# m, v and gradients; the (8, 2048, 49152) f32 logits 3.2 GB.
TRAIN = dict(arch="smollm-135m", batch=8, seq=2048, steps=8, warmup=2,
             lr=3e-3, selection_every=2, pool_factor=4, dim_cap=32,
             n_samples=4, fail_at=5, checkpoint_every=2,
             n_tokens=2_000_000)
# [train parity]: one f32 step of smollm-135m at full width, 2 layers,
# batch 2 × 512 (the loss's ``full`` attention), card against the CPU
# port from the same state.  Each gate is relative: the loss, the grad
# norm, the largest parameter change (≈ the learning rate: Adam's first
# step is g/|g|) and m (the clipped gradient / 10) over its largest
# entry.  Planted faults: one token of the batch changed (loss, grad
# norm, m), the learning rate 1 % high (the parameter change).  Readings
# on the H100 80GB HBM3 at 700 W: sound 8.426e-08, 0, 0 and 2.675e-06;
# the faults 4.132e-04, 4.892e-03, 1.000e-02 and 0.795; each gate lies
# a factor of 41 or more below its fault and 37 or more above its sound
# reading.
TRAIN_PARITY = dict(n_layers=2, batch=2, seq=512, lr=1e-3)
TRAIN_PARITY_TOL = dict(loss=1e-5, grad_norm=1e-5, step=1e-5, m=1e-4)


def profiled(torch, fn, cpu=True):
    """(wall s, device busy s, device events ranked by device time) of
    one call of ``fn`` under torch.profiler; busy is None when the
    profiler saw no device activity.  ``cpu=False`` traces the device
    alone: a train step makes some 60,000 launches, and reading the CPU
    operators' events back takes tens of seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side entries only (kernels, copies): the CPU operators that
    # launched them carry the same device time a second time.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events) / 1e6 if events else None
    return wall, busy, sorted(events, key=_device_us, reverse=True)


def train_run(torch, model, tcfg, tokens, ckpt=None, inject=None):
    """One ``train_loop`` run of TRAIN's recipe on the card."""
    from repro_torch.data import BatchSelector, TokenPipeline
    from repro_torch.train import train_loop

    c = TRAIN
    with TokenPipeline(tokens, c["batch"], c["seq"]) as pipe:
        sel = BatchSelector(c["batch"], algo="dash", feature_mode="grad",
                            embed_dim_cap=c["dim_cap"],
                            n_samples=c["n_samples"])
        return train_loop(model, tcfg, pipe, device="cuda", ckpt_dir=ckpt,
                          selector=sel,
                          selection_every=c["selection_every"],
                          selection_pool_factor=c["pool_factor"],
                          failure_injector=inject, log_every=1000)


def phase_train(torch):
    """smollm-135m trained at published width and depth through
    ``train_loop`` with DASH selection (TRAIN), uninterrupted and then
    killed at step 5 and resumed from a checkpoint.  Gates: every loss
    finite, the mean of the last 2 below that of the first 2; kernel 8
    exactly once per layer per feature chunk and kernel 4 at least once
    in each run; the resumed run's selections and losses equal the
    uninterrupted run's bit for bit.  Logs step seconds, tokens/s, peak
    memory, selection seconds, kernel 5's launches and one profiled
    step's busy share and top device operations."""
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import make_lm_tokens
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves
    from repro_torch.runtime import FailureInjector
    from repro_torch.train import make_train_step

    c = TRAIN
    cfg = get_config(c["arch"])
    need(cfg.remat and cfg.param_dtype == "bfloat16", "smollm config")
    model = build_model(cfg)
    tokens = make_lm_tokens(0, c["n_tokens"], cfg.vocab_size)
    tcfg = TrainConfig(total_steps=c["steps"], learning_rate=c["lr"],
                       warmup_steps=c["warmup"],
                       checkpoint_every=c["checkpoint_every"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    secs, clean, launches = synced(
        torch, lambda: train_run(torch, model, tcfg, tokens))
    peak = torch.cuda.max_memory_allocated()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="train_ckpt_") as tmp:
        rsecs, resumed, rlaunches = synced(torch, lambda: train_run(
            torch, model, tcfg, tokens, ckpt=tmp,
            inject=FailureInjector(fail_at=(c["fail_at"],))))
        saved = sorted(p.name for p in Path(tmp).iterdir())
    n_params = sum(p.numel() for p in tree_leaves(clean.state.params))
    tok_per_step = c["batch"] * c["seq"]
    steady = clean.step_seconds[2:]
    step_s = sum(steady) / len(steady)
    periods = c["steps"] // c["selection_every"]
    chunks = c["selection_every"] * c["pool_factor"]   # pool / k rows
    want_flash = periods * chunks * cfg.n_layers
    log(f"[train] {cfg.name} published width, {cfg.n_layers} layers, "
        f"{n_params} parameters, bf16 params + f32 master, remat on; "
        f"batch {c['batch']} x {c['seq']} tokens, {c['steps']} steps, "
        f"warmup {c['warmup']}, lr {c['lr']:g}; DASH on grad features "
        f"(cap {c['dim_cap']}, {c['n_samples']} samples), selection every "
        f"{c['selection_every']} steps from pools of "
        f"{c['batch'] * c['selection_every'] * c['pool_factor']}")
    log(f"[train] losses {[round(x, 6) for x in clean.losses]}")
    log(f"[train] step seconds {[round(x, 4) for x in clean.step_seconds]}"
        f"; steady mean (steps 2-{c['steps'] - 1}) {step_s:.4f} s = "
        f"{tok_per_step / step_s:.1f} tokens/s; run {secs:.3f} s; peak "
        f"{peak - held} bytes above the {held} held")
    log(f"[train] selection seconds "
        f"{[round(x, 4) for x in clean.selection_seconds]} (total "
        f"{clean.selection_time_s:.3f} s: grad features of the pool in "
        f"chunks of {c['batch']} rows, then BatchSelector.select); "
        f"launches={launches} (kernel 8 want {want_flash} = {periods} "
        f"selections x {chunks} chunks x {cfg.n_layers} layers; kernel 5 "
        f"{launches.get('aopt_filter_gains', 0)}: filters only when a "
        f"DASH round does)")
    log(f"[train] killed at step {c['fail_at']} and resumed: restarts="
        f"{resumed.restarts}, checkpoints {saved}; run {rsecs:.3f} s, "
        f"launches={rlaunches}; losses equal "
        f"{resumed.losses == clean.losses}, max |diff| "
        + (f"{max(abs(a - b) for a, b in zip(resumed.losses, clean.losses)):.3e}"
           if len(resumed.losses) == len(clean.losses) else "n/a")
        + f"; selections equal "
        f"{all(np.array_equal(resumed.selections.get(p), v) for p, v in clean.selections.items())}")
    # one more step from the trained (warm) state, profiled
    step = make_train_step(model, tcfg)
    row = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"]),
                        device="cuda", dtype=torch.int32)
    t_prof = time.perf_counter()
    wall, busy, events = profiled(
        torch, lambda: step(clean.state, {"tokens": row}), cpu=False)
    t_prof = time.perf_counter() - t_prof
    if busy is None:
        log(f"[train] profiled step: wall_s={wall:.4f}; device time not "
            f"measured (the profiler saw no device activity)")
    else:
        log(f"[train] profiled step: wall_s={wall:.4f} device_busy_s="
            f"{busy:.4f} busy_share={busy / wall:.4f} (under the profiler,"
            f" device trace only; {t_prof:.1f} s with the trace's reading)")
        for e in events[:10]:
            log(f"[train]   {_device_us(e) / 1e3:10.3f} ms  {e.count:6d} "
                f"calls  {e.key[:90]}")
    losses = clean.losses
    need(all(math.isfinite(x) for x in losses + resumed.losses),
         "[train]: a loss is not finite")
    need(sum(losses[-2:]) < sum(losses[:2]),
         f"[train]: the loss did not fall: {losses}")
    need(launches.get("flash_attention", 0) == want_flash
         and rlaunches.get("flash_attention", 0) == want_flash,
         f"[train]: kernel 8 launched {launches}, {rlaunches}")
    need(launches.get("aopt_gains", 0) > 0
         and rlaunches.get("aopt_gains", 0) > 0,
         "[train]: kernel 4 never launched")
    need(resumed.restarts == 1 and resumed.losses == clean.losses,
         "[train]: the resumed run's losses differ")
    need(sorted(resumed.selections) == sorted(clean.selections)
         and all(np.array_equal(resumed.selections[p], v)
                 for p, v in clean.selections.items()),
         "[train]: the resumed run's selections differ")
    out = {"launches": launches, "resumed_launches": rlaunches,
           "step_s": step_s, "tokens_per_s": tok_per_step / step_s,
           "peak": peak - held, "selection_s": clean.selection_time_s,
           "busy_share": None if busy is None else busy / wall,
           "n_layers": cfg.n_layers,
           "pool": c["batch"] * c["selection_every"] * c["pool_factor"],
           "k_sel": c["batch"] * c["selection_every"]}
    del clean, resumed, step
    torch.cuda.empty_cache()
    return out


def parity_step(torch, model, state, tokens, tcfg):
    """(loss, grad_norm, largest parameter change, new state) of one
    train step."""
    from repro_torch.tree import tree_leaves
    from repro_torch.train import make_train_step

    new, met = make_train_step(model, tcfg)(state, {"tokens": tokens})
    change = max(float((a.float() - b.float()).abs().max()) for a, b in
                 zip(tree_leaves(new.params), tree_leaves(state.params)))
    return float(met["loss"]), float(met["grad_norm"]), change, new


def phase_train_parity(torch):
    """One f32 train step of smollm-135m at full width, 2 layers, batch
    2 × 512, on the card and on the CPU from the same state; gated
    between the sound reading and a planted fault's (TRAIN_PARITY_TOL)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.models.transformer import params_to
    from repro_torch.tree import tree_leaves
    from repro_torch.train import init_train_state

    c = TRAIN_PARITY
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=c["n_layers"], dtype="float32",
                              param_dtype="float32")
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=10, learning_rate=c["lr"],
                       warmup_steps=0)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(model, gen, tcfg)
    tokens = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"]),
                           generator=gen, dtype=torch.int32)
    moved = tokens.clone()
    moved[0, 7] = (moved[0, 7] + 1) % cfg.vocab_size
    t0 = time.perf_counter()
    card = parity_step(torch, model, params_to(state, "cuda"),
                       tokens.cuda(), tcfg)
    cpu = parity_step(torch, model, state, tokens, tcfg)
    fault_tok = parity_step(torch, model, state, moved, tcfg)
    fault_lr = parity_step(torch, model, state, tokens, dataclasses.replace(
        tcfg, learning_rate=c["lr"] * 1.01))

    def rel(a, b):
        return abs(a - b) / abs(b)

    def m_err(a, b):
        ma, mb = tree_leaves(a.opt.m), tree_leaves(b.opt.m)
        scale = max(float(x.abs().max()) for x in mb)
        return max(float((x.cpu() - y).abs().max())
                   for x, y in zip(ma, mb)) / scale

    readings = {
        "loss": (rel(card[0], cpu[0]), rel(fault_tok[0], cpu[0])),
        "grad_norm": (rel(card[1], cpu[1]), rel(fault_tok[1], cpu[1])),
        "step": (rel(card[2], cpu[2]), rel(fault_lr[2], cpu[2])),
        "m": (m_err(card[3], cpu[3]), m_err(fault_tok[3], cpu[3])),
    }
    log(f"[train parity] {cfg.name} full width, {cfg.n_layers} layers, f32,"
        f" batch {c['batch']} x {c['seq']}, lr {c['lr']:g}: card loss "
        f"{card[0]:.7f} grad_norm {card[1]:.7f} largest change "
        f"{card[2]:.7e}; CPU {cpu[0]:.7f} {cpu[1]:.7f} {cpu[2]:.7e}; "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (sound, fault) in readings.items():
        tol = TRAIN_PARITY_TOL[name]
        log(f"[train parity] {name}: reading sound={sound:.3e} planted "
            f"fault={fault:.3e} (gate {tol:g}; fault: "
            f"{'learning rate +1 %' if name == 'step' else 'one token changed'})")
        need(sound <= tol, f"[train parity]: {name} reads {sound:.3e}")
        need(fault > tol, f"[train parity]: the {name} gate does not see "
             f"its planted fault ({fault:.3e})")
    return readings


def phase_train_timing(torch, train):
    """Kernel 8 at the train features' shape (B = one chunk of selector.k
    rows, S 2048, smollm's heads, causal) and kernel 4 at the train
    selection's (d = embed_dim_cap, n = the pool, one lane): shape
    records for the kernels line, each with its launches in [train]."""
    from repro_torch.kernels.aopt_gains import aopt_gains, aopt_gains_ref

    out = time_flash_shape(torch, TRAIN["batch"], TRAIN["seq"],
                           TRAIN["seq"], 9, 3, 64, True, 0)
    r, info = out["bf16"], out["bf16"]["info"]
    launches = train["launches"]
    flash = {"shape": f"B={TRAIN['batch']} S={TRAIN['seq']} H=9 Hkv=3 "
                      f"D=64 causal",
             "launches": launches.get("flash_attention", 0),
             "ms": r["ms"], "plain_ms": r["plain_ms"],
             "plain_shape": f"B=1 S={TRAIN['seq']} H=9 Hkv=3 D=64",
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"], "registers": info["registers"],
             "smem_bytes_per_cta": info["smem_bytes"],
             "ms_f32": out["f32"]["ms"],
             "plain_ms_f32": out["f32"]["plain_ms"],
             "bound_ms_f32": out["f32"]["bound_ms"]}
    log(f"[timing] flash_attention train features shape: launches in "
        f"[train] {flash['launches']}")
    d, n, g = TRAIN["dim_cap"], train["pool"], 1
    X, W, _, _, isig2 = make_aopt_operands(torch, d, n, g, 1, 1, n_sel=8,
                                           seed=5)
    b4, by4 = bound(4.0 * d * n * g + 3.0 * g * n,
                    4 * d * n * (1 + g) + 4 * g * n)
    t4 = time_ms(torch, lambda: aopt_gains(X, W, isig2))
    p4 = time_ms(torch, lambda: aopt_gains_ref(X, W, isig2))
    aopt = {"d": d, "n": n, "G": g, "ms": t4, "plain_ms": p4,
            "bound_ms": b4, "bound_by": by4, "library_ms": None,
            "launches": launches.get("aopt_gains", 0)}
    log(f"[timing] aopt_gains        f32  train selection shape d={d} "
        f"n={n} G={g}: kernel_ms={t4:.4f} plain_ms={p4:.4f} bound_ms="
        f"{b4:.3e} ({by4}) library_ms=n/a bound/kernel={b4 / t4:.3e} "
        f"launches in [train]={aopt['launches']}")
    return {"flash_attention": flash, "aopt_gains": aopt}


# ---------------------------------------------------------------------------
# slice 12: sharded training and the continuous-batching engine
# ---------------------------------------------------------------------------

# [train sharded]: TRAIN's recipe (smollm-135m whole, bf16 with an f32
# master, remat, DASH on grad features every 2 steps from pools of 4 ×
# the period's examples, batch 8 × 2048) for 4 steps through
# ``train_loop(mesh=)`` on spawned ranks, one launch at a time: world 2
# (gloo, both ranks on the card, mesh (data 2, model 1)), uninterrupted
# and then killed at step 3 with checkpoints every 2 steps under build/;
# world 1 (NCCL, mesh (1, 1)), uninterrupted, then resuming the world-2
# checkpoint (step 2) for the last step.  Gates (readings and planted
# faults logged beside them): world 2's step-0 loss against world 1's
# within SHARDED_LOSS_TOL["step0"], relative (the same parameters; the
# planted fault divides each rank's loss by its own token count), later
# steps within SHARDED_LOSS_TOL["later"]; each step's grad_norm within
# SHARDED_GRAD_NORM_TOL of world 1's, relative; world 2's step-0
# grad_norm on the pipeline's batch equal to world 1's in two
# microbatches.  The gradients are bf16 (the parameters' type): world 2
# sums those of two 4-row halves in f32, world 1 takes those of all 8
# rows, and the two part by that rounding alone: world 2 equals world 1
# in two microbatches bit for bit and both read 7.3e-03 against the
# whole batch.  Readings on the H100 80GB HBM3 at 700 W: losses
# 8.371e-08, 0, 2.676e-04, 1.876e-03, the own-count fault 9.988e-01;
# grad_norm 7.245e-03, 7.657e-03, 1.877e-03, 1.811e-04; a planted
# all-reduce that leaves out rank 1's gradient reads 0.415-0.560 on the
# grad norms and 1.590e-02, 1.579e-02 on the losses of steps 2-3 (the
# loss gate must see it too); period 0's selected ids equal (the same
# features: each rank's rows in the same chunks as one device's), later
# periods equal unless their features differ; the killed world-2 run's
# losses, selections and final parameters equal the uninterrupted run's
# bit for bit; the world-1 resume's loss against world 2's at the same
# step from the same state (SHARDED_LOSS_TOL["step0"]); kernel 8 once
# per layer per feature chunk on each rank, kernel 4 launched on each
# rank.
TRAIN_SHARDED = dict(steps=4, fail_at=3, checkpoint_every=2, timeout=900)
SHARDED_LOSS_TOL = {"step0": 1e-5, "later": 1e-2}
SHARDED_GRAD_NORM_TOL = 3e-2

# [engine]: h2o-danube-1.8b whole (the lm main's weights, bf16) behind
# ServeEngine(max_batch 4, max_seq 8192, eos -1): 8 requests, prompts of
# seed-0 lengths in [512, 6000] (past the 4096 window: ring caches), 32
# new tokens each.  Gate: each request's tokens equal its solo greedy
# decode (batch 1, the port's own prefill and decode steps), or the
# first difference comes at a step whose solo top-two logit margin is
# below ENGINE_MARGIN_GATE (the engine decodes 4 rows at once, the solo
# run 1: bf16 products of another shape round otherwise).  Readings on
# the H100 80GB HBM3 at 700 W: 4 of 8 requests identical, the others
# parting at solo margins 0.0156, 0.0312, 0.0000 and 0.0156 (bf16
# logits near 1 are spaced 0.0078); the gate is 8 such spacings.  And
# each request's logits, up to the first token where it parts from its
# solo run, within ENGINE_LOGIT_TOL of the solo run's largest (max abs
# difference over max abs): readings there 0 to 1.582e-02; two planted
# faults, served on the first 4 prompts for 4 tokens, read 0.261-0.290
# (every slot decoded one position on) and 1.17-1.56 (each admitted
# cache inserted into the next slot).
ENGINE = dict(max_batch=4, max_seq=8192, n_requests=8, lo=512, hi=6000,
              new_tokens=32, seed=0, fault_tokens=4)
ENGINE_MARGIN_GATE = 0.0625
ENGINE_LOGIT_TOL = 5e-2


def train_sharded_rank(ckpt, resume):
    """One rank of [train sharded]: the host mesh over the world, TRAIN's
    recipe for TRAIN_SHARDED's steps; world 2 runs uninterrupted and
    then killed at ``fail_at`` with checkpoints in ``ckpt``; world 1 runs
    uninterrupted and then, with ``resume``, resumes ``ckpt``.  Each
    run's counters are set to 0 just before and read just after."""
    import dataclasses
    import hashlib

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import BatchSelector, TokenPipeline, make_lm_tokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import FailureInjector
    from repro_torch.train import loop as loop_mod
    from repro_torch.train import step as step_mod
    from repro_torch.train import train_loop

    c, s = TRAIN, TRAIN_SHARDED
    mesh = make_host_mesh()
    world = len(mesh.ranks)
    cfg = get_config(c["arch"])
    model = build_model(cfg)
    tokens = make_lm_tokens(0, c["n_tokens"], cfg.vocab_size)
    tcfg = TrainConfig(total_steps=s["steps"], learning_rate=c["lr"],
                       warmup_steps=c["warmup"],
                       checkpoint_every=s["checkpoint_every"])

    def run(ckpt_dir=None, inject=None, drop=False):
        make, reduce = loop_mod.make_train_step, step_mod.all_reduce_buckets
        norms = []

        def recording(*a, **kw):
            step = make(*a, **kw)

            def stepped(state, batch):
                new, met = step(state, batch)
                norms.append(float(met["grad_norm"]))
                return new, met

            stepped.allreduce_seconds = step.allreduce_seconds
            return stepped

        loop_mod.make_train_step = recording
        if drop:
            # The planted fault: the all-reduce sums only the first data
            # rank's gradient (the others' rows left out).
            step_mod.all_reduce_buckets = lambda leaves, m, axes: reduce(
                [g * float(m.index(axes) == 0) for g in leaves], m, axes)
        try:
            with TokenPipeline(tokens, c["batch"], c["seq"]) as pipe:
                sel = BatchSelector(c["batch"], algo="dash",
                                    feature_mode="grad",
                                    embed_dim_cap=c["dim_cap"],
                                    n_samples=c["n_samples"])
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                secs, res, launches = synced(torch, lambda: train_loop(
                    model, tcfg, pipe, mesh=mesh, ckpt_dir=ckpt_dir,
                    selector=sel, selection_every=c["selection_every"],
                    selection_pool_factor=c["pool_factor"],
                    failure_injector=inject, log_every=1000))
                peak = torch.cuda.max_memory_allocated() - held
        finally:
            loop_mod.make_train_step = make
            step_mod.all_reduce_buckets = reduce
        digest = hashlib.sha256()
        for t in res.state.params["layers"][-1].values():
            if isinstance(t, torch.Tensor):
                digest.update(t.float().cpu().numpy().tobytes())
        return dict(secs=secs, losses=res.losses, grad_norms=norms,
                    launches=launches,
                    selections=res.selections, restarts=res.restarts,
                    step_seconds=res.step_seconds,
                    allreduce_seconds=res.allreduce_seconds,
                    selection_seconds=res.selection_seconds, peak=peak,
                    params_sha=digest.hexdigest())

    out = {"world": world, "rank": mesh.rank, "device": str(mesh.device)}
    out["clean"] = run()
    if world > 1:
        out["killed"] = run(ckpt, FailureInjector(fail_at=(s["fail_at"],)))
        out["saved"] = sorted(p.name for p in Path(ckpt).iterdir()) \
            if mesh.is_writer else None
        # The planted faults: one step where each rank's loss is divided
        # by its own token count instead of the global one; a run whose
        # all-reduce leaves out the second rank's gradient.
        out["fault_loss"], _ = step0_metrics(torch, model, tcfg, tokens,
                                             mesh, own_count=True)
        out["drop"] = run(drop=True)
        out["step0"] = step0_metrics(torch, model, tcfg, tokens, mesh)
    else:
        if resume:
            out["resumed"] = run(ckpt)
        out["step0"] = step0_metrics(torch, model, tcfg, tokens, mesh)
        out["step0_halves"] = step0_metrics(
            torch, model, dataclasses.replace(tcfg, microbatches=2), tokens,
            mesh)
    return out


def step0_metrics(torch, model, tcfg, tokens, mesh, own_count=False):
    """(loss, grad_norm) of step 0 from TRAIN's initial state, on the
    step-0 batch of TRAIN's pipeline (no selection), in ``tcfg``'s
    microbatches; with ``own_count`` (the planted fault) ``Model.loss``
    divides each rank's NLL by its own count (the data-parallel group
    hidden from it)."""
    from repro_torch.data import TokenPipeline, shard_batch
    from repro_torch.models import transformer
    from repro_torch.train import init_train_state, make_train_step

    c = TRAIN
    gen = torch.Generator(device=mesh.device).manual_seed(tcfg.seed)
    state = init_train_state(model, gen, tcfg)
    with TokenPipeline(tokens, c["batch"], c["seq"]) as pipe:
        batch = pipe.batch_for_step(0)
    step = make_train_step(model, tcfg, mesh=mesh)
    group = transformer.batch_group
    if own_count:
        transformer.batch_group = lambda: None
    try:
        _, met = step(state, shard_batch(batch, mesh,
                                         microbatches=tcfg.microbatches))
    finally:
        transformer.batch_group = group
    return float(met["loss"]), float(met["grad_norm"])


def phase_train_sharded(torch):
    """[train sharded]: see TRAIN_SHARDED."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks

    c, s = TRAIN, TRAIN_SHARDED
    cfg = get_config(c["arch"])
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_sharded_ckpt_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        w2 = spawn_ranks(train_sharded_rank, 2, (ckpt, False),
                         device="cuda", timeout_s=s["timeout"])
        t_w2 = time.perf_counter() - t0
        t0 = time.perf_counter()
        w1 = spawn_ranks(train_sharded_rank, 1, (ckpt, True),
                         device="cuda", timeout_s=s["timeout"])
        t_w1 = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    one = w1[0]
    periods = s["steps"] // c["selection_every"]
    pool = c["batch"] * c["selection_every"] * c["pool_factor"]
    tok_step = c["batch"] * c["seq"]
    log(f"[train sharded] {cfg.name} published width, {cfg.n_layers} "
        f"layers, TRAIN's recipe for {s['steps']} steps; world 2 (gloo, "
        f"both ranks on the card, mesh (data 2, model 1)) launch "
        f"{t_w2:.1f} s (two runs), world 1 (NCCL, mesh (1, 1)) launch "
        f"{t_w1:.1f} s (two runs)")
    runs = [("world 1", 0, one["clean"])] + [
        (f"world 2 rank {r['rank']}", r["rank"], r["clean"]) for r in w2]
    for name, rank, r in runs:
        steady = r["step_seconds"][1:]
        step_s = sum(steady) / len(steady)
        ar = r["allreduce_seconds"]
        log(f"[train sharded] {name}: losses "
            f"{[round(x, 6) for x in r['losses']]}; step seconds "
            f"{[round(x, 4) for x in r['step_seconds']]}, mean of steps "
            f"1-{s['steps'] - 1} {step_s:.4f} s = {tok_step / step_s:.1f} "
            f"tokens/s (global batch); all-reduce seconds per step "
            f"{[round(x, 4) for x in ar]}; selection seconds "
            f"{[round(x, 4) for x in r['selection_seconds']]}; run "
            f"{r['secs']:.3f} s; peak {r['peak']} bytes; launches="
            f"{r['launches']}")
    # gates
    w1l = one["clean"]["losses"]
    for r in w2:
        need(r["clean"]["losses"] == w2[0]["clean"]["losses"],
             "[train sharded]: the world-2 ranks report other losses")
    w2l = w2[0]["clean"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(w2l, w1l)]
    fault = w2[0]["fault_loss"]
    fault_rel = abs(fault - w1l[0]) / abs(w1l[0])
    log(f"[train sharded] world 2 against world 1: loss relative "
        f"differences {[f'{x:.3e}' for x in rel]} (gates "
        f"{SHARDED_LOSS_TOL}); planted fault (each rank's loss over its "
        f"own count) step 0 loss {fault:.6f} against {w1l[0]:.6f}: "
        f"reading {fault_rel:.3e}")
    need(all(math.isfinite(x) for x in w1l + w2l),
         "[train sharded]: a loss is not finite")
    need(len(w2l) == len(w1l) == s["steps"]
         and rel[0] <= SHARDED_LOSS_TOL["step0"]
         and max(rel) <= SHARDED_LOSS_TOL["later"],
         f"[train sharded]: world 2's losses {w2l} against world 1's {w1l}")
    need(fault_rel > SHARDED_LOSS_TOL["later"],
         "[train sharded]: the loss gate does not see its planted fault")
    # the summed gradient, read through each step's grad_norm
    gn1, gn2 = one["clean"]["grad_norms"], w2[0]["clean"]["grad_norms"]
    drop = w2[0]["drop"]
    g_rel = [abs(a - b) / abs(b) for a, b in zip(gn2, gn1)]
    d_rel = [abs(a - b) / abs(b) for a, b in zip(drop["grad_norms"], gn1)]
    dl_rel = [abs(a - b) / abs(b) for a, b in zip(drop["losses"], w1l)]
    log(f"[train sharded] grad_norm world 1 {gn1}, world 2 {gn2}: relative "
        f"differences {[f'{x:.3e}' for x in g_rel]} (gate "
        f"{SHARDED_GRAD_NORM_TOL}); planted fault (the all-reduce leaves "
        f"out rank 1's gradient) grad_norm {drop['grad_norms']}: readings "
        f"{[f'{x:.3e}' for x in d_rel]}; its losses {drop['losses']}: "
        f"readings against world 1's {[f'{x:.3e}' for x in dl_rel]}")
    need(len(gn2) == len(gn1) == len(drop["grad_norms"]) == s["steps"]
         and max(g_rel) <= SHARDED_GRAD_NORM_TOL,
         f"[train sharded]: world 2's grad norms {gn2} against world 1's "
         f"{gn1}")
    need(min(d_rel) > SHARDED_GRAD_NORM_TOL,
         "[train sharded]: the grad-norm gate does not see its planted "
         "fault at every step")
    need(max(dl_rel) > SHARDED_LOSS_TOL["later"],
         "[train sharded]: the loss gate does not see the dropped gradient")
    # World 2 sums the bf16 gradients of two 4-row halves in f32; world 1
    # in two microbatches does the same on one device.
    (_, g1), (_, gh), (_, g2) = (one["step0"], one["step0_halves"],
                                 w2[0]["step0"])
    log(f"[train sharded] step 0 on the pipeline's batch (no selection): "
        f"grad_norm world 1 {g1}, world 1 in two microbatches (world 2's "
        f"halves) {gh}, world 2 {g2}: world 2 equal to the halves' "
        f"{g2 == gh}, against the whole batch {abs(g2 - g1) / g1:.3e}")
    need(g2 == gh,
         f"[train sharded]: world 2's step-0 grad_norm {g2} is not one "
         f"device's sum of the same halves {gh}")
    sel1, sel2 = one["clean"]["selections"], w2[0]["clean"]["selections"]
    same = {p: bool(np.array_equal(sel1[p], sel2[p])) for p in sel1}
    log(f"[train sharded] selected ids equal per period (world 1 vs 2): "
        f"{same}")
    need(sorted(sel1) == sorted(sel2) == list(range(periods))
         and same[0], "[train sharded]: period 0's selection differs")
    first_part = min([p for p, e in same.items() if not e], default=None)
    if first_part is not None:
        # A later period selects on parameters trained apart by rounding
        # (the two worlds sum the gradients in another order).
        log(f"[train sharded] period {first_part} parts: its parameters "
            f"differ by rounding (losses up to it within the gate)")
    killed = w2[0]["killed"]
    clean2 = w2[0]["clean"]
    log(f"[train sharded] world 2 killed at step {s['fail_at']} and "
        f"resumed: restarts={killed['restarts']}, checkpoints "
        f"{w2[0]['saved']}; losses equal {killed['losses'] == clean2['losses']}"
        f", selections equal "
        f"{all(np.array_equal(killed['selections'][p], v) for p, v in clean2['selections'].items())}"
        f", final parameters equal "
        f"{killed['params_sha'] == clean2['params_sha']}")
    for r in w2:
        k, cl = r["killed"], r["clean"]
        need(k["restarts"] == 1 and k["losses"] == cl["losses"]
             and k["params_sha"] == cl["params_sha"]
             and sorted(k["selections"]) == sorted(cl["selections"])
             and all(np.array_equal(k["selections"][p], v)
                     for p, v in cl["selections"].items()),
             "[train sharded]: the resumed world-2 run differs")
    res1 = one["resumed"]
    last = s["steps"] - 1
    r_rel = abs(res1["losses"][0] - w2l[last]) / abs(w2l[last])
    log(f"[train sharded] world-2 checkpoint resumed at world 1: "
        f"{res1['restarts']} restarts, steps run {len(res1['losses'])}, "
        f"step {last} loss {res1['losses'][0]:.6f} against world 2's "
        f"{w2l[last]:.6f} (relative {r_rel:.3e}); launches="
        f"{res1['launches']}")
    need(len(res1["losses"]) == 1 and r_rel <= SHARDED_LOSS_TOL["step0"],
         "[train sharded]: the world-1 resume of the world-2 checkpoint")
    # kernel 8 once per layer per feature chunk, on each rank
    for world, ranks in ((1, [one]), (2, w2)):
        chunks = pool // world // c["batch"]
        want = periods * chunks * cfg.n_layers
        for r in ranks:
            got = r["clean"]["launches"]
            need(got.get("flash_attention", 0) == want,
                 f"[train sharded]: world {world} rank {r['rank']} kernel 8 "
                 f"{got.get('flash_attention', 0)} launches, want {want}")
            need(got.get("aopt_gains", 0) > 0,
                 f"[train sharded]: world {world} rank {r['rank']} never "
                 f"launched kernel 4")
        log(f"[train sharded] world {world}: kernel 8 {want} launches per "
            f"rank = {periods} selections x {chunks} chunks x "
            f"{cfg.n_layers} layers; kernel 4 "
            f"{[r['clean']['launches'].get('aopt_gains', 0) for r in ranks]}"
            f" per rank; kernel 5 "
            f"{[r['clean']['launches'].get('aopt_filter_gains', 0) for r in ranks]}")
    return {"w1": one, "w2": w2, "launch_s": (t_w1, t_w2),
            "rel": rel, "fault_rel": fault_rel}


def solo_greedy(torch, model, params, prompt, n_new):
    """Greedy decoding of one prompt alone (batch 1): tokens, each step's
    top-two logit margin and each step's logits."""
    batch = {"tokens": torch.from_numpy(prompt[None]).cuda()}
    toks, margins, steps = [], [], []
    with torch.no_grad():
        logits, cache = model.prefill(params, batch)
        pos = cache["step_offset"]
        for i in range(n_new):
            steps.append(logits[0].clone())
            top = torch.topk(logits[0].float(), 2).values
            margins.append(float(top[0] - top[1]))
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(int(tok[0]))
            if i == n_new - 1:
                break
            logits, cache = model.decode_step(params, cache, tok[:, None],
                                              pos + i)
    return toks, margins, steps


def recorded_engine(torch, model, params, fault=None):
    """ServeEngine at ENGINE's size whose prefills and decode steps keep
    each request's logits (``engine.logits``: request id → one (vocab,)
    row per token, in order).  ``fault`` plants an engine fault: "pos+1"
    decodes every slot one position on, "slot+1" inserts each admitted
    cache into the next slot."""
    from repro_torch.train import ServeEngine

    e = ENGINE
    engine = ServeEngine(model, params, max_batch=e["max_batch"],
                         max_seq=e["max_seq"], eos_id=-1, device="cuda")
    engine.logits = {}
    prefill, decode = model.prefill, model.decode_step

    def prefill_rec(p, batch, **kw):
        logits, cache = prefill(p, batch, **kw)
        engine.logits[len(engine.logits)] = [logits[0].clone()]
        return logits, cache

    def decode_rec(p, cache, toks, pos):
        if fault == "pos+1":
            pos = pos + 1
        logits, cache = decode(p, cache, toks, pos)
        for slot, req in enumerate(engine.active):
            if req is not None:
                engine.logits[req.rid].append(logits[slot].clone())
        return logits, cache

    engine.model = copy.copy(model)
    engine.model.prefill, engine.model.decode_step = prefill_rec, decode_rec
    return engine


def faulty_engine_logits(torch, model, params, prompts, fault):
    """Each request's logits from a recorded engine with ``fault``
    planted, serving ``prompts`` for ENGINE's fault_tokens each."""
    from repro_torch.train import engine as engine_mod

    insert = engine_mod.insert_slot
    if fault == "slot+1":
        engine_mod.insert_slot = lambda dst, src, slot: insert(
            dst, src, (slot + 1) % ENGINE["max_batch"])
    try:
        engine = recorded_engine(torch, model, params, fault)
        for p in prompts:
            engine.submit(p, max_new=ENGINE["fault_tokens"])
        engine.run_until_done()
    finally:
        engine_mod.insert_slot = insert
    logits = engine.logits
    del engine
    torch.cuda.empty_cache()
    return logits


def logit_reading(got, want):
    """max |got − want| over max |want|, over the logits of the steps
    whose inputs agree: up to and including the first token where the
    two greedy runs part."""
    n = min(len(got), len(want))
    part = next((i for i in range(n) if int(got[i].argmax())
                 != int(want[i].argmax())), n - 1)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got[:part + 1], want[:part + 1]))
    return err / max(float(w.float().abs().max()) for w in want[:part + 1])


def phase_engine(torch, lm):
    """[engine]: see ENGINE."""
    import numpy as np

    e = ENGINE
    model, params = lm["model"], lm["params"]
    cfg = model.cfg
    rng = np.random.default_rng(e["seed"])
    lens = rng.integers(e["lo"], e["hi"] + 1, e["n_requests"])
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    engine = recorded_engine(torch, model, params)
    steps, admit = [], []
    admit_fn = engine._admit

    def timed_admit():
        t0 = time.perf_counter()
        admit_fn()
        admit.append(time.perf_counter() - t0)

    engine._admit = timed_admit

    def serve():
        rids = [engine.submit(p, max_new=e["new_tokens"]) for p in prompts]
        while engine.pending or any(r is not None for r in engine.active):
            t0 = time.perf_counter()
            live = engine.step()
            steps.append((live, time.perf_counter() - t0 - admit[-1]))
        return rids

    secs, rids, launches = synced(torch, serve)
    peak = torch.cuda.max_memory_allocated() - held
    outs = {rid: list(map(int, req.out))
            for rid, req in engine.finished.items()}
    n_tok = sum(len(v) for v in outs.values())
    decode = [t for live, t in steps if live]
    log(f"[engine] {cfg.name} published width, {cfg.n_layers} layers, bf16;"
        f" ServeEngine(max_batch={e['max_batch']}, max_seq={e['max_seq']}):"
        f" {len(prompts)} requests, prompts {sorted(int(n) for n in lens)},"
        f" {e['new_tokens']} new tokens each; {secs:.3f} s = "
        f"{len(prompts) / secs:.3f} requests/s, {n_tok / secs:.1f} "
        f"tokens/s; {len(steps)} engine steps: decode host seconds per "
        f"step (admissions apart) mean {sum(decode) / len(decode):.4f}, "
        f"min {min(decode):.4f}, max {max(decode):.4f}; admissions "
        f"{sum(admit):.3f} s in all; peak {peak} "
        f"bytes above the {held} held; launches={launches}")
    logits = engine.logits
    del engine
    torch.cuda.empty_cache()
    t_solo = time.perf_counter()
    identical, worst = 0, 0.0
    solo_logits, readings = {}, []
    for rid, p in zip(rids, prompts):
        solo, margins, solo_logits[rid] = solo_greedy(
            torch, model, params, p, e["new_tokens"])
        readings.append(logit_reading(logits[rid], solo_logits[rid]))
        got = outs[rid]
        need(len(got) == e["new_tokens"],
             f"[engine]: request {rid} got {len(got)} tokens")
        if got == solo:
            identical += 1
            continue
        first = next(i for i, (a, b) in enumerate(zip(got, solo)) if a != b)
        log(f"[engine] request {rid} (prompt {len(p)}) parts from its solo "
            f"run at token {first}: solo top-two margin {margins[first]:.4f}"
            f" (gate {ENGINE_MARGIN_GATE})")
        worst = max(worst, margins[first])
        need(margins[first] < ENGINE_MARGIN_GATE,
             f"[engine]: request {rid} parts at a margin of "
             f"{margins[first]:.4f}")
    log(f"[engine] {identical} of {len(prompts)} requests identical to "
        f"their solo greedy runs ({time.perf_counter() - t_solo:.1f} s)")
    # The logits up to where each request parts from its solo run, beside
    # two planted engine faults served on the first max_batch prompts.
    faults = {}
    for fault in ("pos+1", "slot+1"):
        got = faulty_engine_logits(torch, model, params,
                                   prompts[:e["max_batch"]], fault)
        faults[fault] = [logit_reading(got[rid], solo_logits[rid])
                         for rid in rids[:e["max_batch"]]]
    log(f"[engine] logits against the solo runs' (max |engine - solo| over"
        f" max |solo|, up to the first differing token) per request: "
        f"{[f'{x:.3e}' for x in readings]} (gate {ENGINE_LOGIT_TOL}); "
        f"planted faults on requests 0-{e['max_batch'] - 1}, "
        f"{e['fault_tokens']} tokens each: " + "; ".join(
            f"{f} {[f'{x:.3e}' for x in v]}" for f, v in faults.items()))
    need(max(readings) <= ENGINE_LOGIT_TOL,
         f"[engine]: the engine's logits part from the solo runs' "
         f"({max(readings):.3e})")
    need(all(min(v) > ENGINE_LOGIT_TOL for v in faults.values()),
         "[engine]: the logits gate does not see a planted fault")
    want = cfg.n_layers * len(prompts)
    need(launches.get("flash_attention", 0) == want,
         f"[engine]: kernel 8 launched {launches}, want {want} "
         f"({cfg.n_layers} per admitted request)")
    return {"launches": launches, "lens": [int(n) for n in lens],
            "secs": secs, "identical": identical}


def phase_engine_timing(torch, engine):
    """Kernel 8 at [engine]'s B = 1 prefills, one per request's prompt
    length (danube's heads, window 4096, causal), bf16, beside its bound
    and SDPA with the same mask; the plain version at the median length.
    A shape record for the kernels line's flash_attention row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_ref,
        flash_cost,
    )
    from repro_torch.kernels.flash_attention.ref import attention_mask

    h, hkv, d, w = (LM_HEADS[x] for x in ("h", "hkv", "d", "window"))
    tot = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    bys = set()
    for s in engine["lens"]:
        flops, nbytes, exps = flash_cost(1, s, s, h, hkv, d, causal=True,
                                         window=w)
        q, k, v = flash_inputs(torch, 1, s, s, h, hkv, d, torch.bfloat16,
                               seed=3)
        parts = {"operations": max(flops / BF16_TC_FLOPS,
                                   exps / SFU_OPS_PER_S) * 1e3,
                 "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
        by = max(parts, key=parts.get)
        kw = dict(causal=True, window=w, softcap=0.0)
        t = time_flash(torch, q, k, v, kw)
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        mask = attention_mask(s, s, causal=True, window=w, q_offset=0,
                              device=q.device)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        log(f"[timing] flash_attention bf16 engine prefill B=1 S={s} H={h} "
            f"Hkv={hkv} D={d} window={w}: kernel_ms={t:.4f} bound_ms="
            f"{parts[by]:.4f} ({by}) library_ms={lib:.4f} (SDPA, same "
            f"mask) bound/kernel={parts[by] / t:.3f}")
        tot["ms"] += t
        tot["bound_ms"] += parts[by]
        tot["library_ms"] += lib
        bys.add(by)
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    med = sorted(engine["lens"])[len(engine["lens"]) // 2]
    q, k, v = flash_inputs(torch, 1, med, med, h, hkv, d, torch.bfloat16,
                           seed=3)
    plain = time_ms(torch, lambda: flash_attention_ref(
        q, k, v, causal=True, window=w, softcap=0.0), iters=2, warmup=1)
    t_med = time_flash(torch, q, k, v, dict(causal=True, window=w,
                                            softcap=0.0))
    del q, k, v
    torch.cuda.empty_cache()
    n = len(engine["lens"])
    row = {"shape": f"B=1 S={sorted(engine['lens'])} H={h} Hkv={hkv} D={d} "
                    f"window={w} causal (one prefill per request)",
           "launches": engine["launches"].get("flash_attention", 0),
           "ms": tot["ms"] / n, "bound_ms": tot["bound_ms"] / n,
           "bound_by": "/".join(sorted(bys)),
           "library_ms": tot["library_ms"] / n,
           "plain_ms": plain, "plain_shape": f"B=1 S={med}",
           "ms_at_plain_shape": t_med}
    log(f"[timing] flash_attention engine prefills: mean per call over the "
        f"{n} prompt lengths kernel_ms={row['ms']:.4f} bound_ms="
        f"{row['bound_ms']:.4f} library_ms={row['library_ms']:.4f}; at "
        f"S={med}: kernel_ms={t_med:.4f} plain_ms={plain:.4f}; launches in "
        f"[engine] {row['launches']}")
    return row


# ---------------------------------------------------------------------------
# slice 13: ZeRO-1 and the dry run
# ---------------------------------------------------------------------------

# [train zero1]: TRAIN's model and batch (smollm-135m whole, bf16 with an
# f32 master, remat, 8 × 2048 tokens of TRAIN's pipeline, no selection)
# for 3 steps through make_train_step(mesh=, grad_specs=zero1_specs(...))
# on spawned ranks, world 2 (gloo, both ranks on the card, mesh (data 2,
# model 1): smollm's 30-layer stacks go over data, each rank holds 15
# layers' optimizer state) and world 1 (NCCL); beside it, in each rank,
# the replicated data-parallel step ([train sharded]'s) from the same
# state on the same rows.  Gates: each step's loss within
# SHARDED_LOSS_TOL of the replicated step's (step 0 "step0", later
# "later"), each grad norm within SHARDED_GRAD_NORM_TOL, the gathered
# state after the last step within ZERO1_STATE_TOL of the replicated
# step's, each reading a norm over the whole tree: the parameters' and
# the master's difference over the replicated run's change from the
# initial state, m's and v's over the replicated run's; each rank's
# optimizer bytes equal to its share under the placements; the planted
# fault (each rank updates its part with its own gradient, the
# reduce-scatter's sum left out) reads above the grad-norm gate and the
# state gates at world 2.  Two runs of one step on the card part in the
# gradients' last bits (the embedding's backward adds with atomics), and
# Adam's g/√v turns that into up to ~lr on the parameters whose
# gradient is rounding noise: the largest difference is no gate, the
# norms are.  Readings on the H100 80GB HBM3 at 700 W: world 1 0 (the
# same bits); world 2 params 6.562e-03, master 2.446e-03, m 1.066e-03,
# v 6.850e-04 (the global norm from the parts' sums parts from the
# replicated step's in its last bits, and so the clip factor; norm
# scales near 1.0 then round to other bf16 values, 1.38 × lr); the
# planted fault, run 3 steps, 6.078e-01, 6.073e-01, 3.276e-01, 2.763e-01,
# its grad norms 0.44-0.57 off.  Each gate lies 4.6-9 × above its sound
# reading and 20-33 × below that fault's.  Since the tensor-parallel
# phases joined this spawn the fault runs "fault_steps" = 2 steps (its
# grad norms read at steps 0 and 1; its state after step 1, the first
# step with a learning rate above 0) and its state is held against the
# replicated run's after the same 2 steps (the run keeps that state);
# its readings are in PERF.md §6.
TRAIN_ZERO1 = dict(steps=3, fault_steps=2, timeout=900)
ZERO1_STATE_TOL = dict(params=3e-2, master=2e-2, m=1e-2, v=1e-2)

# [dryrun]: every runnable cell of the registry at 16×16 and at 2×16×16
# traced by repro_torch.launch.dryrun on meta tensors (no card) in
# DRYRUN["workers"] processes at the lowest CPU priority, the costliest
# cells first.  The pool starts before [registry parity], which checks
# results and times nothing, and is waited for when that phase ends, so
# that no timed phase shares the host's cores with it; 2×16×16 cells not
# done DRYRUN["budget_s"] after the wait begins are named and left out.  Then TRAIN's recipe as a
# ShapeConfig (8 × 2048, smollm-135m) traced at mesh 1×1 and data 2 and
# held to [train zero1]'s real steps: held_bytes equal to the real ZeRO-1
# state and rows on the card, the collective bytes by kind equal to what
# the real world-2 step moved (the mesh's methods wrapped in the rank),
# and peak_est_bytes within DRYRUN_PEAK_GATE of one real step's peak
# (torch.cuda.max_memory_allocated above what the process held besides
# the step's arguments), relative; the planted fault, the estimate of
# the model without remat, must read outside the gate.  Readings on the
# H100 80GB HBM3 at 700 W, before the trace counted the parameters' copy
# that ``detach`` makes a second time: 1.445e-02 (world 1: 18,919,857,428
# reckoned against 18,650,354,564 on the card), 2.841e-02 (world 2:
# 9,729,205,652 against 9,460,463,108), both 269,030,016 bytes (one bf16
# copy of the parameters) high; the fault 5.967.  After: 2.535e-05
# (18,650,827,412 against 18,650,354,564) and 3.039e-05 (9,460,175,636
# against 9,460,463,108); the fault 5.939.  With the layers summed from
# two super-blocks (launch/dryrun.py::_depth): 1.227e-07 (18,650,352,276
# against 18,650,354,564) and 8.061e-05 (9,459,700,500 against
# 9,460,463,108); the fault 5.939.
DRYRUN = dict(workers=8, budget_s=60.0)
DRYRUN_PEAK_GATE = 1e-2

# [train tp] and [serve tp] (slice 14), in [train zero1]'s world-2 spawn:
# a second mesh over the same two ranks, (data 1, model 2), gloo, both
# ranks on the card (gloo stages every collective through host memory).
# [train tp]: TRAIN's model and batch for TRAIN_TP["steps"] steps through
# make_train_step(mesh=, grad_specs=zero1_specs(...),
# tensor_parallel=True) on the rank's shards (smollm's 9/3 heads: the
# contracting path; d_ff and the vocabulary split), its losses and grad
# norms against world 1's replicated step ([train zero1]'s "rep", the
# same state and rows) under [train sharded]'s gates; each rank's
# parameter bytes equal to its share under the placements; the planted
# fault (the sum over model after every row-split product dropped) runs
# one step and must read above the step-0 loss gate; partial products
# rounded to bf16 before the sum run one step, logged, and are held at
# the product itself (TRAIN_TP_ROUNDING_GATE); the world-1 rank times
# partial_matmul's f32 GEMMs beside bf16 ones at the step's row-split
# shapes (partial_matmul_cost).  [serve tp]: SERVE_TP's
# archs at published width, bf16, seed-0 weights on each rank cut to its
# shards (danube: the head path, kernel 8 on 16 of 32 heads and 4 of 8
# KV heads at D 80; smollm: the contracting path, all heads, its linear
# cache split by slots), batch 2, prompt 2048, greedy; kernel 8 launched
# once per layer per prefill on each rank; against the same serve at
# world 1 on one card, [engine]'s gates: the tokens equal, or the first
# difference at a world-1 top-two margin below ENGINE_MARGIN_GATE, and
# the logits up to there within ENGINE_LOGIT_TOL; the planted fault
# (smollm's decode merge over the ranks' slots without the maxima's
# maximum) served for SERVE_TP["fault_tokens"] tokens must read above the
# logit gate.
TRAIN_TP = dict(steps=3)
# [train tp]'s loss gates.  The data-parallel steps keep each row's
# arithmetic, so their step-0 losses match world 1's to 8.4e-08 ([train
# sharded]);
# under tensor parallelism every split product is summed in another
# order and rounded to bf16 once, like one card's GEMM but not to the
# same bits, and 30 layers carry the odd ulp to the loss: the first card
# run read 1.901e-05 at step 0 (H100 80GB HBM3, 700 W), above [train
# sharded]'s 1e-5.  So step 0 is gated at 1e-4; later steps and the
# grad norms at [train sharded]'s.  The loss cannot tell partial
# products rounded to bf16 before their sum (a second rounding that the
# reference does not make) from f32 sums: one step so read 3.099e-06 off
# world 1's, nearer than the f32 sums' 1.901e-05 (H100 80GB HBM3, 700 W;
# world 1's tensor-core GEMM does not round like either), so that step
# is logged only.  The f32 sum is held where it acts
# (partial_sum_rounding): the share of a row-split product's bf16
# outputs that differ from the exact product rounded once, gated at
# TRAIN_TP_ROUNDING_GATE, beside the same product with bf16 partials,
# which must read above it; readings in PERF.md §6.
TRAIN_TP_LOSS_TOL = {"step0": 1e-4, "later": 1e-2}
TRAIN_TP_ROUNDING_GATE = 2e-2
SERVE_TP = dict(archs=("h2o-danube-1.8b", "smollm-135m"), batch=2,
                prompt=2048, new_tokens=16, fault_tokens=4, seed=0)


def zero1_collectives(mesh, log_to):
    """Wrap ``mesh``'s collectives so that each call over more than one
    member appends (kind, bytes) to ``log_to`` (``collective_bytes``, the
    dry run's count)."""
    from repro_torch.launch.mesh import collective_bytes

    def wrap(name, kind):
        inner = getattr(mesh, name)

        def call(x, axis, *a):
            if mesh.size(axis) > 1:
                log_to.append((kind, collective_bytes(kind, x,
                                                      mesh.size(axis))))
            return inner(x, axis, *a)
        setattr(mesh, name, call)

    for name, kind in (("psum", "all-reduce"), ("pmax", "all-reduce"),
                       ("all_gather", "all-gather"),
                       ("broadcast", "broadcast"),
                       ("psum_scatter", "reduce-scatter")):
        wrap(name, kind)

    def unwrap():
        for name in ("psum", "pmax", "all_gather", "broadcast",
                     "psum_scatter"):
            delattr(mesh, name)
    return unwrap


def serve_tp_run(torch, arch, mesh=None, n_new=None):
    """[serve tp]'s greedy serve of ``arch`` (SERVE_TP) on the card: on
    ``mesh``'s rank under tensor parallelism over its model axis, else
    whole on one card.  Tokens (B, n), each step's top-two margins (B,
    n) and logits (n, B, V) as numpy, kernel 8's launches, the rank's
    parameter bytes and their share under the placements."""
    import contextlib

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.dryrun import placed_bytes
    from repro_torch.models import build_model
    from repro_torch.sharding import activation_sharding_ctx
    from repro_torch.sharding.tensor_parallel import shard_params
    from repro_torch.train.step import tp_param_specs
    from repro_torch.utils.tree import tree_bytes

    c = SERVE_TP
    n_new = n_new or c["new_tokens"]
    cfg = get_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    params = model.init(gen)
    share = held = tree_bytes(params)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        specs = tp_param_specs(model, mesh)
        share = placed_bytes(params, specs, mesh)
        params = shard_params(params, specs, mesh)
        held = tree_bytes(params)
        ctx = activation_sharding_ctx(("data",), mesh=mesh,
                                      tensor_parallel=True)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(c["seed"])
    tok = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (c["batch"], c["prompt"])).astype(
            np.int32)).cuda()
    toks, margins, logs = [], [], []
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ctx, torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tok})
        launches = flash_attention.launches
        pos = cache["step_offset"]
        for i in range(n_new):
            logs.append(logits.float().cpu())
            top = torch.topk(logits.float(), 2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).cpu())
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(nxt.cpu())
            if i == n_new - 1:
                break
            logits, cache = model.decode_step(params, cache, nxt[:, None],
                                              pos + i)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del params, cache
    torch.cuda.empty_cache()
    return {"tokens": torch.stack(toks, 1).numpy(),
            "margins": torch.stack(margins, 1).numpy(),
            "logits": torch.stack(logs).numpy(), "launches": launches,
            "held": held, "share": share, "seconds": secs,
            "layers": cfg.n_layers}


def train_tp_run(torch, model, state, tcfg, mesh, batches, n, fault=None):
    """[train tp]'s steps (TRAIN_TP) on ``mesh``, (data 1, model 2): the
    rank's losses, grad norms, parameter bytes and their share, its
    first step's collectives (kind, bytes) and held bytes.  ``fault``
    plants "no_sum" (the sum over model after each row-split product
    dropped) or "bf16" (each partial product rounded to bf16 before the
    sum)."""
    from repro_torch.launch.dryrun import placed_bytes
    from repro_torch.models.layers import attention, mlp
    from repro_torch.sharding import batch_axes_for_mesh, zero1_specs
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.train import make_train_step, shard_train_state
    from repro_torch.train.step import tp_param_specs
    from repro_torch.utils.tree import tree_bytes

    cfg = model.cfg
    pspecs = tp_param_specs(model, mesh)
    specs = zero1_specs(pspecs, state.params, mesh,
                        batch_axes_for_mesh(mesh), cfg)
    st = shard_train_state(state, mesh, specs, cfg, param_specs=pspecs)
    out = {"param_bytes": tree_bytes(st.params),
           "param_share": placed_bytes(state.params, pspecs, mesh),
           "held": tree_bytes(st) + tree_bytes(batches[0])}
    step = make_train_step(model, tcfg, mesh=mesh, grad_specs=specs,
                           tensor_parallel=True)
    moved: list = []
    unwrap = zero1_collectives(mesh, moved)
    reduce, partial = tp.ModelGroup.reduce, tp.partial_matmul
    if fault == "no_sum":
        tp.ModelGroup.reduce = lambda self, x, dtype: x.to(dtype)
    elif fault == "bf16":
        # the GEMM's bf16 output, then the f32 sum: at model 2 the bits of
        # a bf16 sum (two bf16 values add exactly in f32)
        attention.partial_matmul = mlp.partial_matmul = \
            lambda x, w: (x @ w).float()
    losses, norms, secs, first = [], [], [], None
    try:
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, met = step(st, batches[i])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            if i == 0:
                first = list(moved)
    finally:
        unwrap()
        tp.ModelGroup.reduce = reduce
        attention.partial_matmul = mlp.partial_matmul = partial
    del st
    torch.cuda.empty_cache()
    return {**out, "losses": losses, "grad_norms": norms,
            "step_seconds": secs, "moved_step0": first}


def partial_sum_rounding(torch, cfg, mesh, rows, bf16=False):
    """[train tp]'s check that a row-split product is summed in f32 and
    rounded once: on ``mesh``'s model axis, the MLP's down projection at
    the step's shape ((rows, d_ff) @ (d_ff, d_model), seed-1 bf16
    operands, each rank its half of d_ff) through ``mlp.partial_matmul``
    and ``ModelGroup.reduce``, as the layer runs it; the share of the
    bf16 outputs that differ from the exact product rounded once to
    bf16.  ``bf16`` plants partial products rounded to bf16 before the
    sum."""
    from repro_torch.models.layers import mlp
    from repro_torch.sharding import activation_sharding_ctx
    from repro_torch.sharding.tensor_parallel import model_group

    gen = torch.Generator(device="cuda").manual_seed(1)
    k, n = cfg.d_ff, cfg.d_model
    x = torch.randn(rows, k, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5).to(
        torch.bfloat16)
    want = (x.double() @ w.double()).to(torch.bfloat16)
    partial = mlp.partial_matmul
    if bf16:
        mlp.partial_matmul = lambda a, b: (a @ b).float()
    try:
        with activation_sharding_ctx(("data",), mesh=mesh,
                                     tensor_parallel=True), torch.no_grad():
            grp = model_group(cfg)
            h = k // grp.size
            mine = slice(grp.index * h, (grp.index + 1) * h)
            got = grp.reduce(mlp.partial_matmul(x[:, mine], w[mine]),
                             torch.bfloat16)
    finally:
        mlp.partial_matmul = partial
    return float((got != want).double().mean())


def partial_matmul_cost(torch, cfg, rows):
    """The cost of summing [train tp]'s partial products in f32: per
    row-split product of a layer at model 2 (the contracting path's q,
    k, v from half of d_model; the MLP's down projection from half of
    d_ff), the ms of one forward and backward of ``partial_matmul`` (f32
    GEMMs) and of the bf16 GEMM with the same operands, on one card."""
    from repro_torch.sharding.tensor_parallel import partial_matmul

    a = cfg.attn
    qkv = (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, k, n in (("qkv", cfg.d_model // 2, qkv),
                       ("w2", cfg.d_ff // 2, cfg.d_model)):
        x = torch.randn(rows, k, generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_(True)
        w = (torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5).to(
            torch.bfloat16).requires_grad_(True)
        g = torch.randn(rows, n, generator=gen, device="cuda")

        def f32():
            partial_matmul(x, w).backward(g)

        def bf16():
            (x @ w).backward(g.to(torch.bfloat16))
        out[name] = {"f32_ms": time_ms(torch, f32),
                     "bf16_ms": time_ms(torch, bf16)}
    return out


def train_zero1_rank():
    """One rank of [train zero1]: see TRAIN_ZERO1; at world 2 also [train
    tp] and [serve tp] (TRAIN_TP, SERVE_TP), whose world-1 halves are the
    replicated step and the serve on one card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import TokenPipeline, make_lm_tokens, shard_batch
    from repro_torch.launch.dryrun import _zero1_stack, placed_bytes
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import (
        batch_axes_for_mesh,
        param_partition_specs,
        zero1_layout,
        zero1_specs,
    )
    from repro_torch.train import (
        gather_train_state,
        init_train_state,
        make_train_step,
        shard_train_state,
    )
    from repro_torch.tree import tree_leaves
    from repro_torch.utils.tree import tree_bytes

    c, z1 = TRAIN, TRAIN_ZERO1
    mesh = make_host_mesh()
    world = len(mesh.ranks)
    cfg = get_config(c["arch"])
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=z1["steps"], learning_rate=c["lr"],
                       warmup_steps=c["warmup"])
    # [train tp]'s mesh over the same ranks: every rank takes every row
    tp_mesh = make_mesh((1, 2), ("data", "model")) if world > 1 else None
    with TokenPipeline(make_lm_tokens(0, c["n_tokens"], cfg.vocab_size),
                       c["batch"], c["seq"]) as pipe:
        batches = [shard_batch(pipe.batch_for_step(i), mesh)
                   for i in range(z1["steps"])]
        whole = ([shard_batch(pipe.batch_for_step(i), tp_mesh)
                  for i in range(z1["steps"])] if tp_mesh else None)
    gen = torch.Generator(device=mesh.device).manual_seed(tcfg.seed)
    state = init_train_state(model, gen, tcfg)
    axes = batch_axes_for_mesh(mesh)
    specs = zero1_specs(param_partition_specs(state.params, cfg, mesh),
                        state.params, mesh, axes, cfg)
    share = 3 * placed_bytes(state.opt.master, specs, mesh, _zero1_stack(
        zero1_layout(specs, state.params, mesh, axes, cfg), mesh))

    def run(zero1, n, fault=False, keep=None):
        st = shard_train_state(state, mesh, specs, cfg) if zero1 else state
        held = tree_bytes(st) + tree_bytes(batches[0])
        opt_bytes = tree_bytes((st.opt.master, st.opt.m, st.opt.v))
        step = (make_train_step(model, tcfg, mesh=mesh, grad_specs=specs)
                if zero1 else make_train_step(model, tcfg, mesh=mesh))
        moved: list = []
        unwrap = zero1_collectives(mesh, moved)
        if fault:
            # the planted fault: each rank's part of its own gradient,
            # not summed over the ranks
            def own(x, axis):
                p, i = mesh.size(axis), mesh.index(axis)
                n_ = x.shape[0] // p
                return x[i * n_:(i + 1) * n_].clone()
            mesh.psum_scatter = own
        losses, norms, secs, peaks, first = [], [], [], [], None
        try:
            for i in range(n):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                st, met = step(st, batches[i])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                # the step's peak: what it held at its start (its
                # arguments) plus what it allocated above that
                peaks.append(torch.cuda.max_memory_allocated() - before
                             + held)
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
                if i == 0:
                    first = list(moved)
                if i + 1 == keep:
                    # a step writes into no state it was given
                    kept = st
        finally:
            unwrap()
        out = dict(losses=losses, grad_norms=norms, step_seconds=secs,
                   peaks=peaks, held=held, opt_bytes=opt_bytes,
                   moved_step0=first)
        if keep is not None:
            out["kept"] = kept
        if zero1:
            out["reduce_scatter_seconds"] = step.reduce_scatter_seconds
            out["all_gather_seconds"] = step.all_gather_seconds
            out["final"] = gather_train_state(st, mesh, specs, cfg)
        else:
            out["final"] = st
        return out

    rep = run(False, z1["steps"],
              keep=z1["fault_steps"] if world > 1 else None)
    zero = run(True, z1["steps"])
    r = rep.pop("final")
    # the replicated state after as many steps as the planted fault runs
    r_fault = rep.pop("kept", None)

    def norm(tree, minus=None):
        ls = tree_leaves(tree)
        ms = tree_leaves(minus) if minus is not None else [None] * len(ls)
        return math.sqrt(sum(
            float(((x.float() - y.float()) if y is not None
                   else x.float()).square().sum()) for x, y in zip(ls, ms)))

    def state_err(g, r):
        """``g`` against the replicated run's state ``r`` after as many
        steps."""
        return {"params": norm(g.params, r.params)
                / norm(r.params, state.params),
                "master": norm(g.opt.master, r.opt.master)
                / norm(r.opt.master, state.opt.master),
                "m": norm(g.opt.m, r.opt.m) / norm(r.opt.m),
                "v": norm(g.opt.v, r.opt.v) / norm(r.opt.v),
                "params_max_lr": max(
                    float((a.float() - b.float()).abs().max())
                    for a, b in zip(tree_leaves(g.params),
                                    tree_leaves(r.params))) / c["lr"]}

    out = {"world": world, "rank": mesh.rank, "rep": rep, "zero": zero,
           "share": share, "state_err": state_err(zero.pop("final"), r)}
    if world > 1:
        f = run(True, z1["fault_steps"], fault=True)
        out["fault_state_err"] = state_err(f.pop("final"), r_fault)
        del r_fault
        out["fault"] = f
        out["tp"] = train_tp_run(torch, model, state, tcfg, tp_mesh, whole,
                                 TRAIN_TP["steps"])
        out["tp_fault"] = train_tp_run(torch, model, state, tcfg, tp_mesh,
                                       whole, 1, fault="no_sum")
        out["tp_bf16"] = train_tp_run(torch, model, state, tcfg, tp_mesh,
                                      whole, 1, fault="bf16")
        rows = c["batch"] * c["seq"]
        out["rounding"] = partial_sum_rounding(torch, cfg, tp_mesh, rows)
        out["rounding_bf16"] = partial_sum_rounding(torch, cfg, tp_mesh,
                                                    rows, bf16=True)
    else:
        out["partial_cost"] = partial_matmul_cost(torch, cfg,
                                                  c["batch"] * c["seq"])
    del state, batches, whole
    torch.cuda.empty_cache()
    out["serve"] = {a: serve_tp_run(torch, a, tp_mesh)
                    for a in SERVE_TP["archs"]}
    if world > 1:
        from repro_torch.models.layers import attention

        def merge(m, l, acc, grp):       # the planted fault: no pmax
            return grp.psum(acc) / grp.psum(l)[..., None]

        attention.merge_partials = merge
        out["serve_fault"] = serve_tp_run(torch, "smollm-135m", tp_mesh,
                                          SERVE_TP["fault_tokens"])
    return out


def phase_train_zero1(torch):
    """[train zero1]: see TRAIN_ZERO1."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks

    c, z1 = TRAIN, TRAIN_ZERO1
    cfg = get_config(c["arch"])
    t0 = time.perf_counter()
    w2 = spawn_ranks(train_zero1_rank, 2, (), device="cuda",
                     timeout_s=z1["timeout"])
    t_w2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    w1 = spawn_ranks(train_zero1_rank, 1, (), device="cuda",
                     timeout_s=z1["timeout"])
    t_w1 = time.perf_counter() - t0
    log(f"[train zero1] {cfg.name} published width, {cfg.n_layers} layers, "
        f"bf16 params + f32 master, remat; batch {c['batch']} x {c['seq']}, "
        f"{z1['steps']} steps, lr {c['lr']:g} warmup {c['warmup']}; world 2 "
        f"(gloo, both ranks on the card, mesh (data 2, model 1)) launch "
        f"{t_w2:.1f} s, world 1 (NCCL) launch {t_w1:.1f} s")
    for r in w1 + w2:
        name = f"world {r['world']} rank {r['rank']}"
        for tag in ("rep", "zero"):
            x = r[tag]
            steady = x["step_seconds"][1:]
            log(f"[train zero1] {name} {'ZeRO-1' if tag == 'zero' else 'replicated'}"
                f": losses {[round(v, 6) for v in x['losses']]} grad norms "
                f"{[round(v, 6) for v in x['grad_norms']]} step seconds "
                f"{[round(v, 4) for v in x['step_seconds']]} (mean of steps "
                f"1-{z1['steps'] - 1} {sum(steady) / len(steady):.4f} s); "
                f"optimizer bytes {x['opt_bytes']}; step peak "
                f"{[int(p) for p in x['peaks']]} bytes"
                + (f"; reduce-scatter seconds "
                   f"{[round(v, 4) for v in x['reduce_scatter_seconds']]}, "
                   f"all-gather seconds "
                   f"{[round(v, 4) for v in x['all_gather_seconds']]}"
                   if tag == "zero" else ""))
        log(f"[train zero1] {name}: optimizer bytes held "
            f"{r['zero']['opt_bytes']}, its share under the placements "
            f"{r['share']}; gathered state against the replicated step's "
            f"{ {k: f'{v:.3e}' for k, v in r['state_err'].items()} } (gates "
            f"{ZERO1_STATE_TOL}; params_max_lr, the largest difference in "
            f"units of the learning rate, logged only)")
        need(r["zero"]["opt_bytes"] == r["share"],
             f"[train zero1]: {name} holds {r['zero']['opt_bytes']} optimizer"
             f" bytes, its share is {r['share']}")
        for k, tol in ZERO1_STATE_TOL.items():
            need(r["state_err"][k] <= tol,
                 f"[train zero1]: {name} gathered {k} reads "
                 f"{r['state_err'][k]:.3e}")
            if "fault_state_err" in r:
                need(r["fault_state_err"][k] > tol,
                     f"[train zero1]: the {k} gate does not see the planted"
                     f" fault ({r['fault_state_err'][k]:.3e})")

    def readings(a, b):
        loss = [abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                    b["losses"])]
        norm = [abs(x - y) / abs(y) for x, y in zip(a["grad_norms"],
                                                    b["grad_norms"])]
        return loss, norm

    for r in w1 + w2:
        loss, norm = readings(r["zero"], r["rep"])
        need(all(math.isfinite(x) for x in r["zero"]["losses"]),
             "[train zero1]: a loss is not finite")
        need(loss[0] <= SHARDED_LOSS_TOL["step0"]
             and max(loss) <= SHARDED_LOSS_TOL["later"]
             and max(norm) <= SHARDED_GRAD_NORM_TOL,
             f"[train zero1]: world {r['world']} rank {r['rank']} losses "
             f"{loss}, grad norms {norm} against the replicated step")
        log(f"[train zero1] world {r['world']} rank {r['rank']} ZeRO-1 "
            f"against replicated: loss {[f'{x:.3e}' for x in loss]} (gates "
            f"{SHARDED_LOSS_TOL}), grad norm {[f'{x:.3e}' for x in norm]} "
            f"(gate {SHARDED_GRAD_NORM_TOL})")
    fl, fn = readings(w2[0]["fault"], w2[0]["rep"])
    log(f"[train zero1] planted fault (each rank's own gradient, not "
        f"summed): loss {[f'{x:.3e}' for x in fl]}, grad norm "
        f"{[f'{x:.3e}' for x in fn]}; its state against the replicated "
        f"step's after the same {z1['fault_steps']} steps "
        f"{({k: f'{v:.3e}' for k, v in w2[0]['fault_state_err'].items()})}")
    need(min(fn) > SHARDED_GRAD_NORM_TOL,
         "[train zero1]: the grad-norm gate does not see the planted fault")
    check_train_tp(w1[0], w2, readings)
    check_serve_tp(torch, w1[0], w2)
    return {"w1": w1[0], "w2": w2, "launch_s": (t_w1, t_w2)}


def check_train_tp(w1, w2, readings):
    """[train tp]'s gates (TRAIN_TP) on the world-2 ranks' runs against
    world 1's replicated step."""
    for r in w2:
        x, name = r["tp"], f"rank {r['rank']}"
        loss, norm = readings(x, w1["rep"])
        log(f"[train tp] {name} mesh (data 1, model 2), ZeRO-1 on its "
            f"shards: losses {[round(v, 6) for v in x['losses']]} grad norms"
            f" {[round(v, 6) for v in x['grad_norms']]} step seconds "
            f"{[round(v, 4) for v in x['step_seconds']]}; parameter bytes "
            f"{x['param_bytes']}, their share under the placements "
            f"{x['param_share']}; against world 1's replicated step: loss "
            f"{[f'{v:.3e}' for v in loss]} (gates {TRAIN_TP_LOSS_TOL}), grad "
            f"norm {[f'{v:.3e}' for v in norm]} (gate "
            f"{SHARDED_GRAD_NORM_TOL})")
        need(x["param_bytes"] == x["param_share"],
             f"[train tp]: {name} holds {x['param_bytes']} parameter bytes, "
             f"its share is {x['param_share']}")
        need(all(math.isfinite(v) for v in x["losses"]),
             "[train tp]: a loss is not finite")
        need(loss[0] <= TRAIN_TP_LOSS_TOL["step0"]
             and max(loss) <= TRAIN_TP_LOSS_TOL["later"]
             and max(norm) <= SHARDED_GRAD_NORM_TOL,
             f"[train tp]: {name} losses {loss}, grad norms {norm}")
        fl, fn = readings(r["tp_fault"], w1["rep"])
        log(f"[train tp] {name} planted fault (no sum over model after the "
            f"row-split products): loss {fl[0]:.3e}, grad norm {fn[0]:.3e}")
        need(fl[0] > TRAIN_TP_LOSS_TOL["step0"]
             and fn[0] > SHARDED_GRAD_NORM_TOL,
             "[train tp]: the gates do not see the planted fault")
        bl, bn = readings(r["tp_bf16"], w1["rep"])
        log(f"[train tp] {name} partial products rounded to bf16 before "
            f"the sum over model, a step: loss {bl[0]:.3e}, grad norm "
            f"{bn[0]:.3e} against world 1's (logged only: the loss does "
            f"not tell them from the f32 sums, PERF.md §6)")
        log(f"[train tp] {name} the MLP's down projection at "
            f"{TRAIN['batch'] * TRAIN['seq']} rows, summed over model: "
            f"share of outputs off the exact product rounded once "
            f"{r['rounding']:.3e} (gate {TRAIN_TP_ROUNDING_GATE}); planted "
            f"bf16 partial products {r['rounding_bf16']:.3e}")
        need(r["rounding"] <= TRAIN_TP_ROUNDING_GATE,
             f"[train tp]: {name} sums partial products with "
             f"{r['rounding']:.3e} of the outputs off the exact product")
        need(r["rounding_bf16"] > TRAIN_TP_ROUNDING_GATE,
             "[train tp]: the rounding gate does not see partial products "
             "rounded to bf16 before their sum")
    cost = w1["partial_cost"]
    log(f"[train tp] the f32 sum's cost, one card, rows "
        f"{TRAIN['batch'] * TRAIN['seq']}, forward and backward of one "
        f"layer's row-split product at model 2: "
        + "; ".join(f"{k} partial_matmul (f32 GEMMs) {v['f32_ms']:.4f} ms, "
                    f"bf16 GEMM {v['bf16_ms']:.4f} ms"
                    for k, v in cost.items()))


def check_serve_tp(torch, w1, w2):
    """[serve tp]'s gates (SERVE_TP) on the world-2 ranks' serves against
    world 1's."""
    for arch in SERVE_TP["archs"]:
        want = w1["serve"][arch]
        log(f"[serve tp] {arch} world 1: {want['seconds']:.3f} s, kernel 8 "
            f"launched {want['launches']} times in the prefill")
        for r in w2:
            got, name = r["serve"][arch], f"{arch} rank {r['rank']}"
            log(f"[serve tp] {name} mesh (data 1, model 2): batch "
                f"{SERVE_TP['batch']}, prompt {SERVE_TP['prompt']}, "
                f"{SERVE_TP['new_tokens']} greedy tokens in "
                f"{got['seconds']:.3f} s; kernel 8 launched "
                f"{got['launches']} times in the prefill; parameter bytes "
                f"{got['held']} (share {got['share']})")
            need(got["launches"] == got["layers"],
                 f"[serve tp]: {name} launched kernel 8 {got['launches']} "
                 f"times, want {got['layers']}")
            need(got["held"] == got["share"],
                 f"[serve tp]: {name} holds {got['held']} parameter bytes")
            for b in range(SERVE_TP["batch"]):
                g, w = list(got["tokens"][b]), list(want["tokens"][b])
                reading = logit_reading(
                    [torch.from_numpy(x[b]) for x in got["logits"]],
                    [torch.from_numpy(x[b]) for x in want["logits"]])
                part = next((i for i, (p, q) in enumerate(zip(g, w))
                             if p != q), None)
                margin = (float(want["margins"][b][part])
                          if part is not None else None)
                log(f"[serve tp] {name} row {b}: "
                    + ("tokens equal to world 1's" if part is None else
                       f"parts from world 1 at token {part}, world 1's "
                       f"top-two margin {margin:.4f} (gate "
                       f"{ENGINE_MARGIN_GATE})")
                    + f"; logits {reading:.3e} (gate {ENGINE_LOGIT_TOL})")
                need(part is None or margin < ENGINE_MARGIN_GATE,
                     f"[serve tp]: {name} row {b} parts at a margin of "
                     f"{margin}")
                need(reading <= ENGINE_LOGIT_TOL,
                     f"[serve tp]: {name} row {b} logits read {reading:.3e}")
    want = w1["serve"]["smollm-135m"]
    n = SERVE_TP["fault_tokens"]
    for r in w2:
        got = r["serve_fault"]
        reading = max(logit_reading(
            [torch.from_numpy(x[b]) for x in got["logits"]],
            [torch.from_numpy(x[b]) for x in want["logits"][:n]])
            for b in range(SERVE_TP["batch"]))
        log(f"[serve tp] planted fault (smollm's decode merge without the "
            f"maxima's maximum), rank {r['rank']}: logits {reading:.3e}")
        need(reading > ENGINE_LOGIT_TOL,
             "[serve tp]: the logit gate does not see the planted fault")


def dryrun_cell(arch, shape, multi_pod):
    """One cell of [dryrun] in a worker process: its record, or its error
    record."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.dryrun import error_record, lower_cell

    t0 = time.perf_counter()
    try:
        r = lower_cell(arch, shape, multi_pod=multi_pod)
    except Exception as e:       # noqa: BLE001 — recorded, fails the phase
        r = error_record(arch, shape, "2x16x16" if multi_pod else "16x16",
                         "", e)
    r["wall_s"] = time.perf_counter() - t0
    return r


def dryrun_recipe(world, remat=True, model=1):
    """TRAIN's recipe traced by the dry run on mesh (world, model): its
    record."""
    import dataclasses

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import ShapeMesh

    cfg = dataclasses.replace(get_config(TRAIN["arch"]), remat=remat)
    shape = ShapeConfig("train_recipe", TRAIN["seq"], TRAIN["batch"],
                        "train")
    return trace_cell(cfg, shape, ShapeMesh((world, model),
                                            ("data", "model")))


def _dryrun_worker():
    import os

    os.nice(19)          # behind [registry parity], which it runs beside


def start_dryrun():
    """Start [dryrun]'s traces in a pool of daemon worker processes (ended
    at exit if the script fails first); returns what ``phase_dryrun``
    collects."""
    import multiprocessing

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_shape, runnable_cells

    order = {"train": 0, "prefill": 1, "long_decode": 2, "decode": 3}
    cells = sorted(runnable_cells(),
                   key=lambda c: order[get_shape(c[1]).kind])
    pool = multiprocessing.get_context("spawn").Pool(
        DRYRUN["workers"], initializer=_dryrun_worker)
    return {"pool": pool, "cells": cells, "t0": time.perf_counter(),
            "recipe": {w: pool.apply_async(dryrun_recipe, (w,))
                       for w in (1, 2)},
            "no_remat": pool.apply_async(dryrun_recipe, (2, False)),
            "tp": pool.apply_async(dryrun_recipe, (1, True, 2)),
            "single": [pool.apply_async(dryrun_cell, (a, s, False))
                       for a, s in cells],
            "multi": [pool.apply_async(dryrun_cell, (a, s, True))
                      for a, s in cells]}


def collect_dryrun(started):
    """Wait for [dryrun]'s pool (``start_dryrun()``'s) and end it: its
    records, for ``phase_dryrun``."""
    cells, multi, pool = started["cells"], started["multi"], started["pool"]
    t0 = time.perf_counter()
    try:
        records = [r.get() for r in started["single"]]
        recipe = {w: r.get() for w, r in started["recipe"].items()}
        no_remat = started["no_remat"].get()
        recipe_tp = started["tp"].get()
        while (time.perf_counter() - t0 < DRYRUN["budget_s"]
               and not all(r.ready() for r in multi)):
            time.sleep(0.5)
        done = [r.get() for r in multi if r.ready()]
        left = [c for c, r in zip(cells, multi) if not r.ready()]
    finally:
        pool.terminate()
        pool.join()
    return {"records": records, "recipe": recipe, "no_remat": no_remat,
            "recipe_tp": recipe_tp,
            "done": done, "left": left, "cells": cells,
            "t_pool": time.perf_counter() - started["t0"],
            "t_wait": time.perf_counter() - t0}


def phase_dryrun(torch, zero1, collected):
    """[dryrun]: see DRYRUN; ``collected`` is ``collect_dryrun()``'s."""
    from repro_torch.launch.dryrun import print_record

    records, done, left, cells = (collected[k] for k in
                                  ("records", "done", "left", "cells"))
    recipe, no_remat = collected["recipe"], collected["no_remat"]
    t_pool, t_wait = collected["t_pool"], collected["t_wait"]
    errors = [r for r in records + done if "error" in r]
    for r in records + done:
        if "error" in r:
            log(f"[dryrun] [FAIL] {r['arch']} × {r['shape']} ({r['mesh']}): "
                f"{r['error']}\n{r['traceback']}")
        else:
            print_record(r)
    # every record whole, for reading after the run (gitignored)
    (ROOT / "build").mkdir(exist_ok=True)
    with open(ROOT / "build" / "dryrun_records.json", "w") as f:
        json.dump({"cells": records + done, "recipe": recipe,
                   "no_remat": no_remat}, f, indent=1)
    log(f"[dryrun] {len(records)} runnable cells at 16x16 and {len(done)} of "
        f"{len(cells)} at 2x16x16 traced by {DRYRUN['workers']} processes, "
        f"ended {t_pool:.1f} s after they started beside [registry parity]; "
        f"the wait after that phase took {t_wait:.1f} s; 2x16x16 cells left "
        f"out (budget {DRYRUN['budget_s']} s): {left or 'none'}")
    need(not errors, f"[dryrun]: {len(errors)} cells failed to trace")
    need(len(records) == len(cells), "[dryrun]: a 16x16 cell is missing")
    # TRAIN's recipe against [train zero1]'s real steps
    real = {1: zero1["w1"], 2: zero1["w2"][0]}
    for w in (1, 2):
        r, x = recipe[w], real[w]["zero"]
        moved: dict = {}
        for kind, n in x["moved_step0"]:
            slot = moved.setdefault(kind, {"bytes": 0, "count": 0})
            slot["bytes"] += n
            slot["count"] += 1
        est, got = r["memory"]["peak_est_bytes"], x["peaks"][1]
        rel = abs(est - got) / got
        log(f"[dryrun] recipe world {w}: held_bytes {r['held_bytes']} "
            f"against the card's {x['held']}; collectives {r['collectives']} "
            f"against the real first step's {moved}; peak_est_bytes {est} "
            f"against step 1's {got} on the card: reading {rel:.3e} (gate "
            f"{DRYRUN_PEAK_GATE})")
        need(r["held_bytes"] == x["held"],
             f"[dryrun]: world {w} held_bytes {r['held_bytes']} != "
             f"{x['held']}")
        need({k: v["bytes"] for k, v in r["collectives"].items()}
             == {k: v["bytes"] for k, v in moved.items()},
             f"[dryrun]: world {w} collective bytes differ")
        need(rel <= DRYRUN_PEAK_GATE,
             f"[dryrun]: world {w} peak estimate reads {rel:.3e}")
    got = real[2]["zero"]["peaks"][1]
    fault = abs(no_remat["memory"]["peak_est_bytes"] - got) / got
    log(f"[dryrun] planted fault (the estimate without remat) "
        f"{no_remat['memory']['peak_est_bytes']} against {got}: reading "
        f"{fault:.3e}")
    need(fault > DRYRUN_PEAK_GATE,
         "[dryrun]: the peak gate does not see the planted fault")
    # the recipe at (data 1, model 2) against [train tp]'s rank
    r, x = collected["recipe_tp"], zero1["w2"][0]["tp"]
    moved = {}
    for kind, n in x["moved_step0"]:
        moved[kind] = moved.get(kind, 0) + n
    est = {k: v["bytes"] for k, v in r["collectives"].items()}
    log(f"[dryrun] recipe at (data 1, model 2), tensor parallel: held_bytes"
        f" {r['held_bytes']} against [train tp]'s {x['held']}; collective "
        f"bytes {est} against its first step's {moved}")
    need(r["held_bytes"] == x["held"],
         f"[dryrun]: tp held_bytes {r['held_bytes']} != {x['held']}")
    need(est == moved, "[dryrun]: tp collective bytes differ")
    return {"records": records + done, "left": left, "seconds": t_pool,
            "wait_s": t_wait}


# ---------------------------------------------------------------------------
# slice 6: R², the per-sample path, diversity, coreset, resilience
# ---------------------------------------------------------------------------

def phase_r2_main(torch, out):
    """R2Objective on the regression main's D1 (d = n = 8192, support
    256, k = 128): greedy, then dash_auto (6 guesses × 8 samples, eps
    0.25, α 0.6).  Values in [0, 1]; Def. 14 of DASH's set, solved in
    float64, within R2_GATE of its value (a planted fault, the set less
    one member, is read the same way); brute_r2 in f32 within 1e-3.
    RegressionObjective(*standardize(X, y)) is R2Objective's own
    construction, so its DASH under the same key must give the same set,
    value bits and rounds: kernels 1 and 3 are deterministic."""
    from repro_torch.core import (
        R2Objective,
        RegressionObjective,
        SeedKey,
        dash_auto,
        greedy,
    )
    from repro_torch.core.objectives.r2 import standardize

    k = MAIN["k"]
    X, y = out["objective"].X, out["objective"].y
    kw = dict(eps=0.25, alpha=0.6, n_samples=MAIN["n_samples"],
              n_guesses=MAIN["n_guesses"], device="cuda")
    obj = R2Objective(X, y, k, device="cuda")
    gs, g, gl = synced(torch, lambda: greedy(obj, k, device="cuda"))
    ds, res, dl = synced(torch, lambda: dash_auto(obj, k, SeedKey(0), **kw))
    twin = RegressionObjective(*standardize(X, y), k, device="cuda")
    ref = dash_auto(twin, k, SeedKey(0), **kw)
    idx = torch.nonzero(res.sel_mask).flatten()
    brute = float(obj.brute_r2(idx))
    yn = obj.y.double() / torch.linalg.norm(obj.y.double())

    def r2_64(cols):
        Xs = obj.X[:, cols].double()
        b64 = Xs.T @ yn
        return float(b64 @ torch.linalg.solve(Xs.T @ Xs, b64))

    value = float(res.value)
    brute64 = r2_64(idx)
    sound, planted = abs(brute64 - value), abs(r2_64(idx[:-1]) - value)
    same = (torch.equal(res.sel_mask, ref.sel_mask)
            and torch.equal(res.value, ref.value)
            and int(res.rounds) == int(ref.rounds))
    log(f"[r2 main] D1 d={MAIN['d']} n={MAIN['n']} support="
        f"{MAIN['support']} k={k} (the [main] data, standardized): greedy "
        f"value={float(g.value):.6f} host_s={gs:.3f} launches={gl}; dash "
        f"value={float(res.value):.6f} rounds={int(res.rounds)} selected="
        f"{int(res.sel_count)} host_s={ds:.3f} launches={dl}")
    log(f"[r2 main] Def. 14 of DASH's set in float64 {brute64:.9f}: "
        f"reading |R2_64 - value| sound={sound:.3e}, planted fault (one "
        f"member dropped)={planted:.3e} (gate {R2_GATE:g}); brute_r2 in "
        f"f32 {brute:.6f}, |brute - value|={abs(brute - value):.3e}; "
        f"determinism, against RegressionObjective(*standardize(X, y)): "
        f"same set, value bits and rounds={same} (value "
        f"{float(ref.value):.6f}, rounds {int(ref.rounds)})")
    for v in (float(g.value), float(res.value)):
        need(v == v and 0.0 <= v <= 1.0, f"R2 value {v} not in [0, 1]")
    need(sound <= R2_GATE, "Def. 14 of DASH's set is off its value")
    need(planted > R2_GATE, "the R2 reading does not see a dropped member")
    need(abs(brute - value) <= 1e-3, "brute_r2 of DASH's set is off its value")
    need(same, "R2 DASH differs from the standardized regression DASH")
    need(gl.get("regression_gains", 0) >= k and dl.get("filter_gains", 0) > 0,
         "R2 greedy or DASH did not launch kernels 1 and 3")
    return {"greedy_s": gs, "dash_s": ds, "launches": dl}


def _loo_estimate(torch, gains, idx, valid, fallback, drop_sample=None):
    """The filter statistic from per-sample gains (G, S, n): the
    leave-one-out average of ``_estimate_elem_gains``, or, with
    ``drop_sample``, that sample's leave-one-out weight dropped (the
    planted fault)."""
    g, s, n = gains.shape
    w = torch.ones((g, s, n), device=gains.device)
    w = w.scatter_add(2, idx, -valid.to(w.dtype))
    if drop_sample is not None:
        w[:, drop_sample] = 1.0
    wsum = w.sum(dim=1)
    est = torch.sum(gains * w, dim=1) / torch.clamp(wsum, min=1.0)
    return torch.where(wsum > 0, est, fallback)


def engine_off(obj):
    """A shallow copy of ``obj`` (the same tensors) with its filter
    engine switched off: DASH then takes the per-sample path."""
    view = copy.copy(obj)
    view.__dict__.pop("_precision_views", None)
    view.use_filter_engine = False
    return view


def phase_per_sample(torch, lattices):
    """``_estimate_elem_gains`` with use_filter_engine False (one
    ``gains(add_set(...))`` of all lanes per sample: kernels 1, 4, 6)
    and True (one engine call: kernels 3, 5, 7) on the same state and
    keys, at the regression, design and classification lattices.  The
    reading is max |per-sample − engine| over each lane's largest
    |engine| estimate; a planted fault (one sample's leave-one-out
    weight dropped) is read the same way; PER_SAMPLE_GATE lies between."""
    from repro_torch.core import DashConfig, SeedKey
    from repro_torch.core.dash import _estimate_elem_gains
    from repro_torch.core.estimators import sample_set_batch

    out = {}
    for tag, obj, g, m, b in lattices:
        gen = torch.Generator().manual_seed(g + m + b)
        idx0 = torch.stack([torch.randperm(obj.n, generator=gen)[:64]
                            for _ in range(g)]).to("cuda")
        st = obj.add_set(obj.init(g), idx0,
                         torch.ones_like(idx0, dtype=torch.bool))
        cfg = DashConfig(k=obj.kmax, n_samples=m).resolve(obj.n)
        alive = ~st.sel_mask
        allowed = torch.full((g,), b, device="cuda")
        keys = SeedKey(7, host=True).split(g)
        times, est = {}, {}
        views = {True: obj, False: engine_off(obj)}
        for engine in (False, True, False, True):
            times[engine], est[engine], launches = synced(
                torch, lambda: _estimate_elem_gains(
                    views[engine], st, alive, b, allowed, keys, cfg))
            out[(tag, engine)] = launches
        eng, per = est[True], est[False]
        idx, valid = sample_set_batch(keys, alive, b, m)
        gains = torch.stack([obj.gains(obj.add_set(st, idx[:, s_],
                                                   valid[:, s_]))
                             for s_ in range(m)], dim=1)
        fallback = obj.gains(st)
        rebuilt = _loo_estimate(torch, gains, idx, valid, fallback)
        fault = _loo_estimate(torch, gains, idx, valid, fallback,
                              drop_sample=0)
        scale = torch.clamp(eng.abs().amax(dim=1, keepdim=True), min=1e-30)

        def reading(x):
            return float(((x - eng).abs() / scale).max())

        sound, planted = reading(per), reading(fault)
        log(f"[per-sample] {tag}: G={g} m={m} b={b} n={obj.n}: reading "
            f"sound={sound:.3e} planted fault={planted:.3e} (gate "
            f"{PER_SAMPLE_GATE:g}); per-sample path rebuilt from its parts "
            f"bitwise={bool(torch.equal(rebuilt, per))}; per-sample "
            f"host_s={times[False]:.4f} launches={out[(tag, False)]} | "
            f"engine host_s={times[True]:.4f} launches={out[(tag, True)]} "
            f"(per-sample/engine {times[False] / times[True]:.2f}x)")
        need(bool(torch.isfinite(per).all()), f"{tag}: non-finite estimate")
        need(sound <= PER_SAMPLE_GATE,
             f"{tag}: the per-sample path disagrees with the engine")
        need(planted > PER_SAMPLE_GATE,
             f"{tag}: the gate does not see a dropped leave-one-out weight")
        del st, gains, eng, per
    return out


def phase_design_diversified(torch, design):
    """The diversified design that the design main's entry point ran
    ([design]: d = 1024, n = 65536, k = 128): DASH on f_A-opt + d over
    the 4 PC sign clusters (weight 0.2, 6 guesses × 8 samples, eps 0.25,
    the practical α); kernel 5 never launches (the per-sample path),
    kernel 4 does.  Then DiversityObjective alone with 64 clusters: lazy
    greedy = greedy."""
    from repro_torch import experimental_design as ed
    from repro_torch.core import (
        DiversityObjective,
        SeedKey,
        greedy,
        lazy_greedy,
        random_select,
    )

    obj, k, res = design["objective"], DESIGN["k"], design
    secs = res["diversified_s"]
    launches = {n: c for n, c in res["launches"]["diversified"].items() if c}
    dres, dobj = res["div_result"], res["div_objective"]
    rnd = random_select(dobj, k, SeedKey(1), device="cuda")
    base_v = float(dres.state.value)
    div_v = float(dobj.div.value(dres.sel_mask[None])[0])
    idx = torch.nonzero(dres.sel_mask).flatten()
    brute = float(obj.brute_value(idx))
    log(f"[design diversified] d={DESIGN['d']} n={DESIGN['n']} k={k}, "
        f"{ed.DIV_CLUSTERS} PC sign clusters, weight {ed.DIV_WEIGHT}, "
        f"alpha={design['alpha']:.3f}: dash value={res['div_value']:.6f} "
        f"(base {base_v:.6f} + diversity {div_v:.6f}; base by explicit "
        f"inverse {brute:.6f}) rounds={res['div_rounds']} selected="
        f"{res['div_selected']} filter_iterations="
        f"{int(dres.trace.filter_iters.sum())} host_s={secs:.3f} "
        f"launches={launches}; "
        f"RANDOM {float(rnd.value):.6f}; cluster sizes "
        f"{torch.bincount(res['clusters'], minlength=4).tolist()}, "
        f"coverage {res['coverage']}")
    need(res["div_value"] >= float(rnd.value),
         "diversified DASH is below RANDOM")
    need(abs(res["div_value"] - (base_v + div_v))
         <= 1e-6 * max(1.0, abs(res["div_value"])),
         "diversified value is not base + diversity")
    need(abs(brute - base_v) <= 1e-3 * max(1.0, abs(base_v)),
         "the base value disagrees with the explicit inverse")
    need(launches.get("aopt_filter_gains", 0) == 0,
         "diversified DASH launched kernel 5")
    need(launches.get("aopt_gains", 0) > 0,
         "diversified DASH never launched kernel 4")
    need(res["div_selected"] <= k, "diversified DASH selected more than k")

    gen = torch.Generator().manual_seed(0)
    clusters = torch.randint(0, DIV_CLUSTERS, (DESIGN["n"],), generator=gen)
    div = DiversityObjective(clusters, DIV_CLUSTERS, kmax=k, device="cuda")
    gsec, g, _ = synced(torch, lambda: greedy(div, k, device="cuda"))
    lsec, lz, _ = synced(torch, lambda: lazy_greedy(div, k, device="cuda"))
    same = torch.equal(g.sel_idx, lz.sel_idx)
    log(f"[design diversified] DiversityObjective alone, n={DESIGN['n']}, "
        f"{DIV_CLUSTERS} clusters, k={k}: greedy value={float(g.value):.6f} "
        f"host_s={gsec:.3f}; lazy greedy value={float(lz.value):.6f} "
        f"host_s={lsec:.3f}; pick for pick equal={same}")
    need(same, "lazy greedy departs from greedy on DiversityObjective")
    return launches


def phase_coreset(torch, lm):
    """Coreset selection on the LM main's model (h2o-danube-1.8b at full
    width, random weights, seed 0): grad features of 4096 sequences of
    128 tokens in batches of 64 (kernel 8 in every layer), projected to
    64 dims; DASH for k = 256 by the BatchSelector recipe, then backfill
    to k pool rows: k distinct rows, none in the padding.  Then DASH at
    OPT pinned to d·β², α = 1, whose last round filters: kernel 5 must
    launch, and its first output on this run's inputs is held against
    the per-sample path (kernel 4 on S ∪ R_i), read as in [per-sample]
    with a planted fault (one of sample 0's columns dropped).  RANDOM is
    logged, not gated: on these features DASH and RANDOM lie within
    RANDOM's own spread over seeds (PERF.md §6)."""
    from repro_torch.core import SeedKey, random_select, select
    from repro_torch.core.objectives import CoresetObjective, coreset_features

    c = CORESET
    model, params = lm["model"], lm["params"]
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (c["pool"], c["seq"]),
                           generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()

    def features():
        return torch.cat([
            coreset_features(model, params,
                             {"tokens": tokens[i:i + c["batch"]]},
                             mode="grad")
            for i in range(0, c["pool"], c["batch"])])

    fsec, feats, flaunch = synced(torch, features)
    peak = torch.cuda.max_memory_allocated()
    kp, kd = SeedKey(0).split(2)
    k = c["k"]

    def selection():
        obj = CoresetObjective.from_features(feats, k, dim_cap=c["dim_cap"],
                                             key=kp, device="cuda")
        top = select("topk", obj, k, device="cuda")
        opt = float(top.value) * c["opt_margin"]
        res = select("dash", obj, k, key=kd, opt=opt,
                     n_samples=c["n_samples"], device="cuda")
        return obj, top, opt, res

    ssec, (obj, top, opt, res), slaunch = synced(torch, selection)
    calls = []
    engine = obj.filter_gains_batch

    def record(state, idx, valid):
        gains = engine(state, idx, valid)
        if not calls:
            calls.append((state, idx, valid, gains))
        return gains

    obj.filter_gains_batch = record
    try:
        psec, pres, plaunch = synced(torch, lambda: select(
            "dash", obj, k, key=kd, opt=obj.d * obj.beta2,
            alpha=c["pinned_alpha"], n_samples=c["n_samples"],
            device="cuda"))
    finally:
        del obj.filter_gains_batch
    mask = res.sel_mask[: obj.n_real]
    chosen = torch.nonzero(mask).flatten()
    filler = torch.nonzero(~mask).flatten()[: k - chosen.numel()]
    rows = torch.cat([chosen, filler])
    rnd = random_select(obj, k, SeedKey(2), device="cuda")
    spread = [float(random_select(obj, k, SeedKey(s), device="cuda").value)
              for s in range(2, 18)]
    sound = planted = float("nan")
    if calls:
        st, idx, valid, eng = calls[0]

        def per_sample(valid):
            return torch.stack([obj.gains(obj.add_set(st, idx[:, s],
                                                      valid[:, s]))
                                for s in range(idx.shape[1])], dim=1)

        # The planted fault: sample 0 without its last column; that
        # column's own gain (0 in the engine's, as a member of R) is
        # left out of the fault's reading.
        last = int(torch.nonzero(valid[0, 0]).max())
        dropped = valid.clone()
        dropped[0, 0, last] = False
        keep = torch.ones_like(eng, dtype=torch.bool)
        keep[0, 0, idx[0, 0, last]] = False
        scale = torch.clamp(eng.abs().amax(dim=-1, keepdim=True), min=1e-30)
        sound = float(((per_sample(valid) - eng).abs() / scale).max())
        planted = float(((per_sample(dropped) - eng).abs() / scale
                         * keep).max())
    log(f"[coreset] {cfg.name} full width, random weights (seed 0): pool "
        f"{c['pool']} x {c['seq']} tokens in batches of {c['batch']}, grad "
        f"features {tuple(feats.shape)} in {fsec:.3f} s, launches={flaunch},"
        f" peak {peak - held} bytes above the {held} held; logits "
        f"{c['batch'] * c['seq'] * cfg.padded_vocab * 4} bytes a batch")
    log(f"[coreset] CoresetObjective d={obj.d} n={obj.n} (n_real "
        f"{obj.n_real}) k={k}: TOP-K {float(top.value):.6f}, OPT "
        f"{opt:.6f}; DASH value={float(res.value):.6f} selected="
        f"{int(res.sel_count)} rounds={int(res.raw.rounds)} (backfilled to "
        f"{rows.numel()} rows); RANDOM {float(rnd.value):.6f} (seeds 2-17: "
        f"{min(spread):.6f}-{max(spread):.6f}); selection {ssec:.3f} s, "
        f"launches={slaunch}")
    log(f"[coreset] DASH at OPT pinned to d*beta2 = {obj.d * obj.beta2:g}, "
        f"alpha {c['pinned_alpha']:g}: value={float(pres.value):.6f} "
        f"selected={int(pres.sel_count)} filter iterations per round "
        f"{pres.raw.trace.filter_iters.tolist()} alive "
        f"{pres.raw.trace.alive.tolist()}; {psec:.3f} s, launches="
        f"{plaunch}; kernel 5's first output against the per-sample path: "
        f"reading sound={sound:.3e} planted fault={planted:.3e} (gate "
        f"{PER_SAMPLE_GATE:g})")
    need(bool(torch.isfinite(feats).all()) and tuple(feats.shape)
         == (c["pool"], cfg.d_model), "coreset features malformed")
    need(flaunch.get("flash_attention", 0) == cfg.n_layers * c["pool"]
         // c["batch"], f"flash_attention launched {flaunch} times")
    need(rows.numel() == k and int(torch.unique(rows).numel()) == k
         and int(rows.max()) < obj.n_real, "coreset rows malformed")
    need(not bool(res.sel_mask[obj.n_real:].any()), "padding selected")
    need(slaunch.get("aopt_gains", 0) > 0, "coreset never launched kernel 4")
    need(plaunch.get("aopt_filter_gains", 0) > 0 and bool(calls),
         "the pinned coreset DASH never launched kernel 5")
    need(sound <= PER_SAMPLE_GATE,
         "kernel 5 disagrees with the per-sample path at the coreset shape")
    need(planted > PER_SAMPLE_GATE,
         "the coreset reading does not see a dropped column")
    need(not bool(pres.sel_mask[obj.n_real:].any()), "padding selected")
    launches = dict(flaunch)
    for part in (slaunch, plaunch):
        for name, count in part.items():
            launches[name] = launches.get(name, 0) + count
    return {"features_s": fsec, "selection_s": ssec, "pinned_s": psec,
            "launches": launches, "objective": obj}


def phase_resilience(torch, out):
    """dash_checkpointed on the regression main (one lane, OPT = 1.05 ×
    greedy's value): stepped = fused; killed at round ⌊r/2⌋ inside
    run_with_restart and resumed = uninterrupted, bit for bit; async =
    blocking saves; an expired Deadline raises with a carry."""
    import shutil
    import tempfile

    from repro_torch.ckpt import checkpoint_steps
    from repro_torch.core import (
        DashConfig,
        Deadline,
        ResilienceConfig,
        SeedKey,
        SelectionDeadlineExceeded,
        dash,
        dash_checkpointed,
    )
    from repro_torch.core.selection_loop import SelectionCarry
    from repro_torch.runtime import FailureInjector, run_with_restart

    obj, k = out["objective"], MAIN["k"]
    cfg = DashConfig(k=k, eps=0.25, alpha=0.6, n_samples=MAIN["n_samples"])
    r = cfg.resolve(obj.n).r
    opt = out["greedy_value"] * 1.05
    key = SeedKey(0)

    def same(a, b):
        return (torch.equal(a.sel_mask, b.sel_mask)
                and torch.equal(a.value, b.value)
                and all(torch.equal(getattr(a.trace, f), getattr(b.trace, f))
                        for f in a.trace._fields))

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_ckpt_", dir=ROOT / "build"))
    try:
        fsec, fused, _ = synced(torch, lambda: dash(obj, cfg, key, opt,
                                                    device="cuda"))
        ssec, stepped, _ = synced(torch, lambda: dash_checkpointed(
            obj, cfg, key, opt, resilience=ResilienceConfig(),
            device="cuda"))
        runs = {}
        for mode in ("async", "blocking"):
            rc = ResilienceConfig(ckpt_dir=str(tmp / mode), keep_last=r,
                                  async_save=mode == "async")
            runs[mode] = synced(torch, lambda: dash_checkpointed(
                obj, cfg, key, opt, resilience=rc, device="cuda"))
        snap = tmp / "async" / f"step_{r:08d}"
        snap_bytes = sum(f.stat().st_size for f in snap.iterdir())
        kept = len(checkpoint_steps(str(tmp / "async")))
        res = ResilienceConfig(ckpt_dir=str(tmp / "killed"))
        inj = FailureInjector(fail_at=(r // 2,))
        lives = []

        def step_fn(state, step):
            lives.append(len(lives))
            return dash_checkpointed(obj, cfg, key, opt, resilience=res,
                                     resume=len(lives) > 1,
                                     failure_injector=inj, device="cuda")

        ksec, resumed, _ = synced(torch, lambda: run_with_restart(
            total_steps=1, make_state=lambda: (None, 0),
            restore=lambda: None, step_fn=step_fn))
        try:
            dash_checkpointed(obj, cfg, key, opt,
                              resilience=ResilienceConfig(),
                              deadline=Deadline(0.0), device="cuda")
            late = None
        except SelectionDeadlineExceeded as e:
            late = e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    asec, arun, _ = runs["async"]
    bsec, brun, _ = runs["blocking"]
    log(f"[resilience] dash_checkpointed on the main D1 (d={MAIN['d']} "
        f"n={MAIN['n']} k={k}, one lane, OPT 1.05 x greedy = {opt:.6f}, "
        f"r={r}): value={float(stepped.value):.6f} selected="
        f"{int(stepped.sel_count)}; stepped = fused (set, value bits, "
        f"trace): {same(stepped, fused)}; killed at round {r // 2} and "
        f"resumed in {len(lives)} lives = uninterrupted: "
        f"{same(resumed, arun)}; async = blocking: {same(arun, brun)}")
    log(f"[resilience] host_s fused={fsec:.3f} stepped={ssec:.3f} "
        f"async saves={asec:.3f} blocking saves={bsec:.3f} killed+resumed="
        f"{ksec:.3f}; snapshot {snap_bytes} bytes, {kept} kept (keep_last "
        f"{r}); saving costs per round (host s over the stepped run's, / "
        f"{r}): async={(asec - ssec) / r:.4f} blocking="
        f"{(bsec - ssec) / r:.4f}")
    log(f"[resilience] expired deadline: "
        f"{type(late).__name__ if late else 'no exception'} rounds_done="
        f"{getattr(late, 'rounds_done', None)} carry="
        f"{type(getattr(late, 'carry', None)).__name__}")
    need(same(stepped, fused), "stepped DASH differs from fused DASH")
    need(len(lives) == 2 and same(resumed, arun),
         "the resumed run differs from the uninterrupted one")
    need(same(arun, brun) and same(arun, stepped),
         "async and blocking saves give different results")
    need(late is not None and late.rounds_done == 0
         and isinstance(late.carry, SelectionCarry),
         "an expired deadline did not raise with its carry")
    return {"fused_s": fsec, "stepped_s": ssec, "snapshot_bytes": snap_bytes}


# ---------------------------------------------------------------------------
# [sharded]: the sharded runtime (core/distributed.py) on spawned ranks —
# world 1 through NCCL, world 2 through gloo with both ranks on the card
# ---------------------------------------------------------------------------

SHARDED_AXES = ("pod", "data", "model")
# Full width: the three main paths' DASH through select(..., mesh=) on a
# (pod 1, data 1, model W) mesh, so W = 2 gives n_local = n / 2.
SHARDED_FULL = ("regression", "design", "classification")
SHARDED_KERNELS = {
    "regression": ("regression_gains", "filter_gains"),
    "design": ("aopt_gains", "aopt_filter_gains"),
    "classification": ("logistic_gains", "logistic_filter_gains"),
}
# The small inputs of the parity phases: D1 600 × 200 (k 40), the design
# 128 × 512 (k 32, α ∈ {0.3, 1}), D3 600 × 200 (support 50, k 20).
SHARDED_SMALL = {"regression": 40, "design": 32, "classification": 20}
SHARDED_TWINS = ("topk", "random", "stochastic_greedy", "fast")
SHARDED_TIMEOUT_S = 600
# f(S) of the world-1 greedy twin against single-device greedy's.
GREEDY_TWIN_TOL = 1e-6


def sharded_objective(torch, name, full, device, design_alphas=None):
    """(objective, k, select options) of a main path (``full``) or of its
    small parity input, on ``device``; data from the entry points'
    generators and seeds."""
    from repro_torch.core import (
        AOptimalityObjective,
        ClassificationObjective,
        RegressionObjective,
    )
    from repro_torch.data.synthetic import (
        make_d1_design,
        make_d1_regression,
        make_d3_classification,
    )

    base = dict(eps=0.25, n_samples=8, n_guesses=6)
    if name == "regression":
        cfg = MAIN if full else dict(d=600, n=200, support=40, k=40)
        X, y, _ = make_d1_regression(seed=0, n_samples=cfg["d"],
                                     n_features=cfg["n"],
                                     support=cfg["support"])
        return (RegressionObjective(X, y, cfg["k"], device=device), cfg["k"],
                dict(base, alpha=0.6))
    if name == "design":
        d, n, k = ((DESIGN["d"], DESIGN["n"], DESIGN["k"]) if full
                   else (128, 512, 32))
        alphas = design_alphas if full else [0.3, 1.0]
        X = make_d1_design(seed=0, n_samples=n, n_features=d)
        return (AOptimalityObjective(X, k, device=device), k,
                dict(base, alpha=min(alphas), alphas=list(alphas)))
    cfg = CLASS if full else dict(d=600, n=200, support=50, k=20)
    X, y, _ = make_d3_classification(seed=2, n_samples=cfg["d"],
                                     n_features=cfg["n"],
                                     support=cfg["support"])
    return (ClassificationObjective(X, y, cfg["k"], device=device), cfg["k"],
            dict(base, alpha=0.6))


def twin_opts(obj, algo, k):
    """FAST runs one probe, at OPT pinned to the lattice's geometric
    midpoint (its binary search's three probes take a minute on the
    small D1 twice over: twin and single-device)."""
    if algo != "fast":
        return {}
    from repro_torch.core.dash import opt_guess_lattice

    return {"opt": float(opt_guess_lattice(obj, 0.06, 1, k)[0])}


def recorded_dash(torch, obj, k, key, mesh, opts, path):
    """DASH through select(..., mesh=) with every filter decision's
    inputs kept (each iteration's f(S), alive and selected masks and the
    filter statistic, this rank's columns), saved to ``path``: what the
    flip analysis of :func:`first_flip` reads.  The recorder adds a
    value call per filter iteration and keeps every iteration's tensors,
    so its host time is not the runtime's (:func:`sharded_rank` times an
    untouched run).  Returns (host s, result, this rank's launches, the
    lattice's OPT guesses and α)."""
    import dataclasses

    import numpy as np

    from repro_torch.core import select
    from repro_torch.core import distributed as dist
    from repro_torch.core.dash import lattice_grid, opt_guess_lattice

    records, orig = [], dist._make_hooks

    def make(*a, **kw):
        hooks = orig(*a, **kw)

        def elem(state, alive, allowed, keys):
            eg = hooks.estimate_elem_gains(state, alive, allowed, keys)
            records.append((hooks.value(state), alive, state[1], eg))
            return eg

        return dataclasses.replace(hooks, estimate_elem_gains=elem)

    dist._make_hooks = make
    try:
        secs, res, launches = synced(torch, lambda: select(
            "dash", obj, k, key, mesh=mesh, **opts))
    finally:
        dist._make_hooks = orig
    np.savez(path, **{f"{f}_{i}": t.cpu().numpy()
                      for i, rec in enumerate(records)
                      for f, t in zip(("value", "alive", "sel", "eg"), rec)})
    guesses = opt_guess_lattice(obj, opts["eps"], opts["n_guesses"], k)
    lat_opts, lat_alphas = lattice_grid(
        guesses, opts.get("alphas", [opts["alpha"]]))
    return secs, res.raw, launches, (lat_opts.cpu().numpy(),
                                     lat_alphas.cpu().numpy())


def sharded_rank(world, root, design_alphas):
    """One rank of the [sharded] phase on the card (world 1: NCCL; world
    2: gloo).  Both worlds: the three main paths' DASH at full width.
    World 1: greedy on the main D1, DASH on the small inputs, and the
    resume of world 2's snapshot.  World 2: the TOP-K, RANDOM,
    stochastic greedy and FAST twins on the small inputs, and the small
    D1's checkpointed run, killed at round 2 and uninterrupted."""
    import torch

    from repro_torch.core import DashConfig, ResilienceConfig, SeedKey
    from repro_torch.core import select
    from repro_torch.core.distributed import dash_distributed
    from repro_torch.launch.mesh import make_mesh, to_numpy
    from repro_torch.runtime import FailureInjector

    mesh = make_mesh((1, 1, world), SHARDED_AXES)
    rank = mesh.index("model")
    out = {"device": str(mesh.device), "n_local": {}}
    # The small inputs first: they also warm the process up (CUDA
    # context, cuBLAS, the communicator) before the timed full runs.
    key = SeedKey(0, host=True)
    for name in SHARDED_SMALL:
        obj, k, opts = sharded_objective(torch, name, False, mesh.device)
        if world == 1:
            path = f"{root}/small_{name}_cuda_r0.npz"
            out["small", name] = to_numpy(recorded_dash(
                torch, obj, k, key, mesh, opts, path)) + (path,)
        else:
            for algo in SHARDED_TWINS:
                secs, res, launches = synced(torch, lambda: select(
                    algo, obj, k, key, mesh=mesh, **twin_opts(obj, algo, k)))
                out["twin", name, algo] = dict(
                    secs=secs, result=to_numpy(res.raw), launches=launches)
    for name in SHARDED_FULL:
        obj, k, opts = sharded_objective(torch, name, True, mesh.device,
                                         design_alphas)
        out["n_local"][name] = obj.n // world
        # The untouched run gives the host time and the launches; a
        # second, recorded run of the same call gives the flip records.
        secs, res, launches = synced(torch, lambda: select(
            "dash", obj, k, SeedKey(0), mesh=mesh, **opts))
        path = f"{root}/full_{name}_w{world}_r{rank}.npz"
        _, rec, _, lattice = recorded_dash(torch, obj, k, SeedKey(0), mesh,
                                           opts, path)
        out["full", name] = dict(secs=secs, result=to_numpy(res.raw),
                                 launches=launches, record=path,
                                 lattice=lattice,
                                 recorded_same=bool(torch.equal(
                                     res.raw.sel_mask, rec.sel_mask)))
        if name == "regression" and world == 1:
            secs, g, launches = synced(torch, lambda: select(
                "greedy", obj, k, mesh=mesh))
            out["greedy"] = dict(secs=secs, result=to_numpy(g.raw),
                                 launches=launches)
        del obj
        torch.cuda.empty_cache()
    obj, k, opts = sharded_objective(torch, "regression", False, mesh.device)
    cfg = DashConfig(k=k, eps=0.25, alpha=0.6, n_samples=8)
    opt = float(torch.max(obj.gains(obj.init()))) * 12.0
    ckpt = f"{root}/ckpt"
    if world == 2:
        out["uninterrupted"] = to_numpy(dash_distributed(obj, cfg, key, opt,
                                                         mesh))
        try:
            dash_distributed(obj, cfg, key, opt, mesh,
                             resilience=ResilienceConfig(ckpt_dir=ckpt),
                             failure_injector=FailureInjector(fail_at=(2,)))
            out["killed"] = None
        except RuntimeError as e:
            out["killed"] = str(e)
    else:
        out["resumed"] = to_numpy(dash_distributed(obj, cfg, key, opt, mesh,
                                                   resume=ckpt))
    return out


def sharded_cpu_rank(root):
    """World 1 on the CPU (gloo, the plain versions): DASH on the small
    inputs with the card's key, recorded like the card's."""
    import torch

    from repro_torch.core import SeedKey
    from repro_torch.launch.mesh import make_mesh, to_numpy

    mesh = make_mesh((1, 1, 1), SHARDED_AXES, device="cpu")
    out = {}
    for name in SHARDED_SMALL:
        obj, k, opts = sharded_objective(torch, name, False, "cpu")
        path = f"{root}/small_{name}_cpu_r0.npz"
        out[name] = to_numpy(recorded_dash(
            torch, obj, k, SeedKey(0, host=True), mesh, opts, path)) + (path,)
    return out


def load_records(paths):
    """The recorded iterations of one run, every rank's columns joined."""
    import numpy as np

    files = [np.load(p) for p in paths]
    out, i = [], 0
    while f"eg_{i}" in files[0].files:
        rec = {"value": files[0][f"value_{i}"]}
        for f in ("alive", "sel", "eg"):
            rec[f] = np.concatenate([z[f"{f}_{i}"] for z in files], axis=-1)
        out.append(rec)
        i += 1
    return out


def first_flip(rec_a, rec_b, opts, alphas, eps, k):
    """The first filter decision on which two runs of one lattice part.
    The runs share every input until then (noise from the same keys, the
    same gathered columns); a decision is alive & (statistic ≥
    α(1 + ε/2)·t/k) & not selected with t = (1 − ε)(OPT − f(S)).
    Returns None when no decision parts, else the iteration, lane,
    element, the element's margin to the threshold and the two runs'
    statistic difference there (the flip is sound only if the margin
    lies within that difference)."""
    import numpy as np

    for it, (a, b) in enumerate(zip(rec_a, rec_b)):
        if not (np.array_equal(a["alive"], b["alive"])
                and np.array_equal(a["sel"], b["sel"])):
            return dict(iteration=it, lane=None, element=None,
                        margin=None, diff=None, sound=False,
                        why="the runs' alive or selected sets part before "
                            "any filter decision did")
        t = np.maximum((1.0 - eps) * (opts - a["value"]), 0.0)
        thr = (alphas * (1.0 + eps / 2.0) * t / k)[:, None]
        da = a["alive"] & (a["eg"] >= thr) & ~a["sel"]
        db = b["alive"] & (b["eg"] >= thr) & ~b["sel"]
        if not np.array_equal(da, db):
            g, j = (int(v[0]) for v in np.nonzero(da != db))
            margin = abs(float(a["eg"][g, j]) - float(thr[g, 0]))
            diff = abs(float(a["eg"][g, j]) - float(b["eg"][g, j]))
            return dict(iteration=it, lane=g, element=j, margin=margin,
                        diff=diff, sound=margin <= diff, why="")
    return None


def compare_runs(tag, res_a, res_b, rec_a, rec_b, lattice, opts, k):
    """Log and gate two runs of one lattice under the bits rule: the same
    set, or the first parted filter decision's margin within the runs'
    statistic difference there."""
    import numpy as np

    same = bool(np.array_equal(res_a.sel_mask, res_b.sel_mask))
    va, vb = float(res_a.value), float(res_b.value)
    if same:
        log(f"[sharded] {tag}: same set ({int(res_a.sel_count)} selected), "
            f"values {va:.6f} {vb:.6f}, trace equal="
            f"{np.array_equal(res_a.trace.values, res_b.trace.values)}")
        return True
    flip = first_flip(load_records(rec_a), load_records(rec_b),
                      lattice[0], lattice[1], opts["eps"], k)
    log(f"[sharded] {tag}: sets part (values {va:.6f} {vb:.6f}); first "
        f"parted decision {flip}")
    need(flip is not None and flip["sound"],
         f"{tag}: the sets part beyond the bits rule ({flip})")
    return False


def phase_sharded(torch, out, design, cls):
    """select(..., mesh=) on spawned ranks: world 1 (NCCL) and world 2
    (gloo, both ranks on the card) at full width, the small inputs'
    parity with the CPU, the twins against the single-device port, and a
    world-2 snapshot resumed at world 1."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import SeedKey, select
    from repro_torch.launch.mesh import spawn_ranks

    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_sharded_", dir=ROOT / "build")
    alphas = list(design["alphas"])
    def timed_launch(*a, **kw):
        t0 = time.perf_counter()
        return spawn_ranks(*a, **kw), time.perf_counter() - t0

    try:
        # One launch at a time, so no rank's host time shares the cores
        # with another launch.
        w2, t_w2 = timed_launch(sharded_rank, 2, (2, root, alphas),
                                device="cuda", timeout_s=SHARDED_TIMEOUT_S)
        (w1,), t_w1 = timed_launch(sharded_rank, 1, (1, root, alphas),
                                   device="cuda", timeout_s=SHARDED_TIMEOUT_S)
        (cpu,), t_cpu = timed_launch(sharded_cpu_rank, 1, (root,),
                                     device="cpu",
                                     timeout_s=SHARDED_TIMEOUT_S)
        log(f"[sharded] launches took {t_w2:.1f} s (world 2), {t_w1:.1f} s "
            f"(world 1), {t_cpu:.1f} s (world 1 on the CPU), process start "
            f"and data included; devices {w1['device']}, "
            f"{[r['device'] for r in w2]}")
        floors = {"regression": out["random_value"],
                  "design": design["random_value"],
                  "classification": cls["random_value"]}
        top = {"regression": 1.0, "design": float(DESIGN["d"]),
               "classification": CLASS["d"] * math.log(2.0)}
        sharded_launches = {}
        for name in SHARDED_FULL:
            k = {"regression": MAIN["k"], "design": DESIGN["k"],
                 "classification": CLASS["k"]}[name]
            runs = [("w1", 0, w1)] + [("w2", r, w2[r]) for r in range(2)]
            for world, rank, res in runs:
                row = res["full", name]
                r = row["result"]
                log(f"[sharded] {name} {world} rank {rank}: n_local="
                    f"{res['n_local'][name]} host_s={row['secs']:.3f} "
                    f"rounds={int(r.rounds)} value={float(r.value):.6f} "
                    f"selected={int(r.sel_count)} best_guess="
                    f"{int(r.best_guess)} launches={row['launches']} "
                    f"recorded run same set={row['recorded_same']}")
                need(row["recorded_same"], f"[sharded] {name} {world} rank "
                     f"{rank}: the recorded run differs from the timed one")
                for kernel in SHARDED_KERNELS[name]:
                    need(row["launches"].get(kernel, 0) > 0,
                         f"[sharded] {name} {world} rank {rank} never "
                         f"launched {kernel}")
                    sharded_launches.setdefault(kernel, {})[
                        f"{world}_rank{rank}"] = row["launches"][kernel]
                v = float(r.value)
                need(v == v and 0.0 <= v <= top[name],
                     f"[sharded] {name} value {v} out of range")
                need(v > floors[name], f"[sharded] {name} DASH does not "
                     f"beat RANDOM ({floors[name]:.6f})")
            for r in range(2):
                need(np.array_equal(w2[r]["full", name]["result"].sel_mask,
                                    w2[0]["full", name]["result"].sel_mask),
                     f"[sharded] {name}: the world-2 ranks disagree")
            compare_runs(f"{name} full width world 1 vs world 2",
                         w1["full", name]["result"],
                         w2[0]["full", name]["result"],
                         [w1["full", name]["record"]],
                         [w2[r]["full", name]["record"] for r in range(2)],
                         w1["full", name]["lattice"], dict(eps=0.25), k)
        # At world 1 the twin runs kernel 1 at the single-device shape:
        # the same picks, and f(S) within GREEDY_TWIN_TOL.
        g = w1["greedy"]
        same = bool(np.array_equal(g["result"].sel_mask,
                                   out["greedy"].sel_mask.cpu().numpy()))
        dv = abs(float(g["result"].value) - out["greedy_value"])
        log(f"[sharded] greedy on the main D1, world 1: value="
            f"{float(g['result'].value):.6f} host_s={g['secs']:.3f} "
            f"launches={g['launches']} same set as single-device greedy="
            f"{same} |value diff|={dv:.3e}")
        need(same and dv <= GREEDY_TWIN_TOL,
             "[sharded] greedy at world 1 strays from single-device greedy")
        sharded_launches["regression_gains"]["greedy_w1"] = \
            g["launches"]["regression_gains"]
        # The small inputs: world 1 on the card against the CPU.
        for name in SHARDED_SMALL:
            card, cpu_run = w1["small", name], cpu[name]
            compare_runs(f"{name} small, card world 1 vs CPU world 1",
                         card[1], cpu_run[1], [card[4]], [cpu_run[4]],
                         card[3], dict(eps=0.25), SHARDED_SMALL[name])
        # The twins at world 2 against the single-device port on the card.
        key = SeedKey(0, host=True)
        for name, k in SHARDED_SMALL.items():
            obj, _, _ = sharded_objective(torch, name, False, "cuda")
            for algo in SHARDED_TWINS:
                single = select(algo, obj, k, key, device="cuda",
                                **twin_opts(obj, algo, k))
                twin = w2[0]["twin", name, algo]
                same = bool(np.array_equal(twin["result"].sel_mask,
                                           single.sel_mask.cpu().numpy()))
                dv = abs(float(twin["result"].value) - float(single.value))
                log(f"[sharded] twin {algo} on the small {name}, world 2: "
                    f"same set as one device={same} |value diff|={dv:.3e} "
                    f"host_s={twin['secs']:.3f} launches="
                    f"{twin['launches']}")
                need(same and dv < 1e-4, f"[sharded] the {algo} twin on the "
                     f"small {name} differs from the single-device port")
        # A world-2 snapshot resumed at world 1.
        same = bool(np.array_equal(w1["resumed"].sel_mask,
                                   w2[0]["uninterrupted"].sel_mask))
        log(f"[sharded] small D1 killed at world 2 ({w2[0]['killed']}) and "
            f"resumed at world 1: same set as the uninterrupted world-2 run="
            f"{same}, values {float(w1['resumed'].value):.6f} "
            f"{float(w2[0]['uninterrupted'].value):.6f}")
        need(w2[0]["killed"] is not None and same,
             "[sharded] the resumed run differs from the uninterrupted one")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return sharded_launches


# ---------------------------------------------------------------------------
# 14. timing
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# slice 8: the selection service
# ---------------------------------------------------------------------------

# The service's queue caps: the 20 DASH requests on d1 meet the bucket
# cap of 16 (4 shed); the whole load fills max_pending exactly.
SERVE_ADMISSION = dict(max_batch=8, max_queue=16, max_pending=32)
SERVE_K = 128
# The degraded slice: k = 64 with a 5 s deadline against the example's
# seeded latency model (dash and stochastic greedy observed at 100 s).
SERVE_DEADLINE = dict(k=64, deadline_s=5.0, seeded_s=100.0)
SERVE_UPDATE_COLS = 64
# The pinned d1 requests' (OPT, α): R²'s upper bound and the regression
# main's α.  On an H100 the bucket's seed 8 then filters 79 iterations in
# one round; at the policy's α 0.5, at OPT 1.0 or greedy's value, every
# lane filtered once.
SERVE_D1_GUESS = dict(opt=1.0, alpha=0.6)
# The phase's own budget, about a tenth of the script's.
SERVE_BUDGET_S = 90.0


def serve_load(design_guess):
    """The offered load: the deadline slice first (so that its budget is
    not spent queued behind the DASH buckets), 20 DASH requests on d1
    (seeds 0-7 at the server's TOP-k probe OPT, under which D1's DASH
    hardly filters; seeds 8-15 pinned at ``SERVE_D1_GUESS``, where it
    does;
    seeds 16-19 meet the queue cap), 8 on the design
    (pinned at the design main's winning (OPT, α): on the unit-norm
    design every singleton gain ties, so the TOP-k probe is the first k
    columns' value, no better than RANDOM's), 4 stochastic greedy on
    d1."""
    from repro_torch.serve import SelectRequest

    d_opt, d_alpha = design_guess
    k, dl = SERVE_K, SERVE_DEADLINE
    reqs = [SelectRequest("d1", dl["k"], 100 + s, deadline_s=dl["deadline_s"])
            for s in range(4)]
    reqs += [SelectRequest("d1", k, s,
                           **(SERVE_D1_GUESS if 8 <= s < 16 else {}))
             for s in range(20)]
    reqs += [SelectRequest("design", k, 200 + s, opt=d_opt, alpha=d_alpha)
             for s in range(8)]
    reqs += [SelectRequest("d1", k, 300 + s, algo="stochastic_greedy")
             for s in range(4)]
    return reqs


def serve_server(tenants, chaos=None, device="cuda"):
    """A server with the phase's admission caps, the default ServePolicy
    and the example's seeded latency model, the tenants registered."""
    from repro_torch.serve import (
        AdmissionPolicy,
        LatencyModel,
        SelectionServer,
    )

    lm = LatencyModel()
    lm.observe("dash", SERVE_DEADLINE["seeded_s"])
    lm.observe("stochastic_greedy", SERVE_DEADLINE["seeded_s"])
    srv = SelectionServer(admission=AdmissionPolicy(**SERVE_ADMISSION),
                          latency=lm, chaos=chaos, device=device)
    for name, kind, X, y, kmax in tenants:
        srv.register(name, kind, X, y, kmax=kmax)
    return srv


def serve_counted(torch, srv, reqs):
    """Serve ``reqs``; returns (replies, host s, launches per tenant and
    kernel), every kernel's counter set to 0 just before and read after
    each launch.  A tenant's ``filter_iters`` counts its DASH buckets'
    filter iterations (each round's most active lane's, read from the
    carries' ``DashTrace``): one kernel 3 or 5 launch each."""
    kernels = counted_kernels()
    per = {}
    orig = srv._launch
    events, restore = serve_recorder(elems=False)

    def launch(entry, k, tier, members, dl):
        for f in kernels.values():
            f.launches = 0
        del events[:]
        orig(entry, k, tier, members, dl)
        c = per.setdefault(entry.name, {})
        for name, f in kernels.items():
            if f.launches:
                c[name] = c.get(name, 0) + f.launches
        c["filter_iters"] = c.get("filter_iters", 0) + sum(
            int(ev[1].max()) for ev in events)

    srv._launch = launch
    try:
        secs, replies, _ = synced(torch, lambda: srv.serve(reqs))
    finally:
        del srv._launch
        restore()
    return replies, secs, per


def serve_recorder(elems=True):
    """Record every DASH round a bucket runs: with ``elems``, each filter
    iteration's inputs (f(S), alive and selected masks, the statistic),
    and after each round the carry's ``filter_iters`` column.  Returns
    (events, restore)."""
    import dataclasses

    from repro_torch.serve import batcher

    events, orig = [], batcher.make_round_body

    def make(hooks, cfg):
        def elem(state, alive, allowed, keys):
            eg = hooks.estimate_elem_gains(state, alive, allowed, keys)
            events.append(("elem", hooks.value(state).cpu().numpy(),
                           alive.cpu().numpy(),
                           hooks.sel_mask(state).cpu().numpy(),
                           eg.cpu().numpy()))
            return eg

        body = orig(dataclasses.replace(hooks, estimate_elem_gains=elem)
                    if elems else hooks, cfg)

        def round_body(rho, carry, opt, alpha):
            c = body(rho, carry, opt, alpha)
            events.append(("round",
                           c.trace.filter_iters[:, rho].cpu().numpy()))
            return c

        return round_body

    batcher.make_round_body = make
    return events, lambda: setattr(batcher, "make_round_body", orig)


def lane_records(events, lane):
    """The recorded filter iterations in which ``lane`` was active, as
    :func:`first_flip`'s one-lane records: a lane is active from the
    start of a round, so they are the first ``filter_iters[lane, rho]``
    iterations of each round."""
    recs, this_round = [], []
    for ev in events:
        if ev[0] == "elem":
            this_round.append(ev)
            continue
        for _, value, alive, sel, eg in this_round[:int(ev[1][lane])]:
            recs.append({"value": value[lane:lane + 1],
                         "alive": alive[lane:lane + 1],
                         "sel": sel[lane:lane + 1],
                         "eg": eg[lane:lane + 1]})
        this_round = []
    return recs


def recorded_serve(torch, srv, reqs):
    """Serve one bucket's requests under :func:`serve_recorder`."""
    events, restore = serve_recorder()
    try:
        replies = srv.serve(reqs)
    finally:
        restore()
    torch.cuda.synchronize()
    return replies, events


def bits_rule(tag, rep_a, rep_b, ev_a, ev_b, lane_a, lane_b, opt, alpha,
              cfg):
    """Two replies of one request under the bits rule of ``[sharded]``:
    the same set, or the first parted filter decision's margin within the
    two runs' statistic difference there.  Returns the number of filter
    iterations in which the lane was active in run a."""
    import numpy as np

    rec_a, rec_b = lane_records(ev_a, lane_a), lane_records(ev_b, lane_b)
    if np.array_equal(rep_a.sel_mask, rep_b.sel_mask):
        log(f"[serve] {tag}: same set ({rep_a.sel_count} selected), "
            f"values {rep_a.value:.6f} {rep_b.value:.6f}, filter "
            f"iterations {len(rec_a)} {len(rec_b)}")
        return len(rec_a)
    flip = first_flip(rec_a, rec_b, np.float32([opt]), np.float32([alpha]),
                      cfg.eps, cfg.k)
    log(f"[serve] {tag}: sets part (values {rep_a.value:.6f} "
        f"{rep_b.value:.6f}, filter iterations {len(rec_a)} "
        f"{len(rec_b)}); first parted decision {flip}")
    need(flip is not None and flip["sound"],
         f"{tag}: the sets part beyond the bits rule ({flip})")
    return len(rec_a)


def serve_checks(replies, n_offered, chaos):
    """The contract on one load's replies: one terminal reply each, no
    FAILED, a retry hint on every rejection."""
    from repro_torch.serve import FAILED, OK, REJECTED

    need(len(replies) == n_offered and all(r is not None for r in replies),
         "a request ended without a terminal reply")
    for i, r in enumerate(replies):
        need(r.status in (OK, REJECTED),
             f"request {i}: {r.status} ({r.detail})"
             + (" in the chaos run" if chaos else ""))
        need(r.status != FAILED, f"request {i} failed: {r.detail}")
        if r.status == REJECTED:
            need(r.retry_after_s > 0, f"request {i} rejected without a hint")


def phase_serve(torch, out, design):
    """The selection service (``repro_torch.serve``) on the card at full
    width: two tenants (the main D1 and the design main), the offered
    load of :func:`serve_load` through one ``SelectionServer``; the same
    load under a chaos schedule; lane 0 alone against its 8-lane bucket;
    every DASH bucket against ``select_batched``; a warm column update
    against a fresh server; the small D1 and design, card against CPU."""
    import numpy as np

    from repro_torch.core import SeedKey, random_select, select_batched
    from repro_torch.core.dash import lattice_grid, opt_guess_lattice
    from repro_torch.core.selection_loop import DashConfig
    from repro_torch.data.synthetic import make_d1_design, make_d1_regression
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.serve import OK, REJECTED, SelectRequest, ServePolicy

    t_phase = time.perf_counter()
    k, pol = SERVE_K, ServePolicy()
    reg, dobj = out["objective"], design["objective"]
    X1, y1 = reg.X, reg.y
    Xd = dobj.X
    d_design = Xd.shape[0]
    tenants = [("d1", "regression", X1, y1, k),
               ("design", "aopt", Xd, None, k)]
    rand = {"d1": float(random_select(reg, k, SeedKey(1),
                                      device="cuda").value),
            "design": float(random_select(dobj, k, SeedKey(1),
                                          device="cuda").value)}
    ranges = {"d1": 1.0, "design": float(d_design)}   # β² = 1
    g_opts, g_alphas = lattice_grid(
        opt_guess_lattice(dobj, 0.25, DESIGN["n_guesses"], k),
        design["alphas"])
    best = int(np.argmax([lane["value"] for lane in design["lanes"]]))
    guess = (float(g_opts[best]), float(g_alphas[best]))
    reqs = serve_load(guess)
    tenant_of = [r.dataset for r in reqs]

    def check_values(replies):
        for r, t in zip(replies, tenant_of):
            if r.status != OK:
                continue
            need(r.value == r.value and 0.0 <= r.value <= ranges[t],
                 f"{t} value {r.value} out of [0, {ranges[t]}]")
            if r.tier == "dash":
                need(r.value >= rand[t],
                     f"a DASH reply on {t} ({r.value}) is below RANDOM "
                     f"({rand[t]})")

    # -- the load ---------------------------------------------------------
    srv = serve_server(tenants)
    replies, secs, per = serve_counted(torch, srv, reqs)
    serve_checks(replies, len(reqs), chaos=False)
    check_values(replies)
    ok = [r for r in replies if r.status == OK]
    shed = [r for r in replies if r.status == REJECTED]
    need(len(shed) == 4, f"{len(shed)} requests shed, expected 4")
    need(all(r.tier == "topk" and r.degraded for r in replies[:4]),
         "the deadline slice was not served degraded at topk")
    for rec in srv.launch_log:
        log(f"[serve] launch tier={rec['tier']} lanes={rec['lanes']} "
            f"requests={rec['requests']} rounds={rec['rounds']} "
            f"attempts={rec['attempts']} host_s={rec['host_s']:.4f}")
    lat = np.array([r.latency_s for r in ok])
    log(f"[serve] drain: {len(reqs)} offered, {len(ok)} served "
        f"({sum(r.degraded for r in ok)} degraded), {len(shed)} shed "
        f"(retry hints {[round(r.retry_after_s, 4) for r in shed]}) in "
        f"{secs:.3f} s: {len(ok) / secs:.2f} served requests/s; reply "
        f"latency p50={np.percentile(lat, 50):.4f} s "
        f"p99={np.percentile(lat, 99):.4f} s")
    obs = {}
    for rec in srv.launch_log:
        obs.setdefault(rec["tier"], []).append(rec["host_s"])
    log(f"[serve] per-tier EWMA (dash and stochastic_greedy seeded at "
        f"{SERVE_DEADLINE['seeded_s']} s): "
        + ", ".join(f"{t}={v:.4f} s" for t, v in
                    srv.latency.observed().items())
        + "; mean launch host s: "
        + ", ".join(f"{t}={sum(v) / len(v):.4f}" for t, v in obs.items()))
    log(f"[serve] launches per tenant (filter_iters: the DASH buckets' "
        f"filter iterations): {per}")
    pd1, pdes = per.get("d1", {}), per.get("design", {})
    need(pd1.get("regression_gains", 0) > 0
         and pd1.get("filter_gains", 0) > 0,
         f"kernels 1 and 3 did not both launch on d1: {pd1}")
    need(pdes.get("aopt_gains", 0) > 0
         and pdes.get("aopt_filter_gains", 0) > 0,
         f"kernels 4 and 5 did not both launch on the design: {pdes}")
    need(pd1.get("filter_gains") == pd1.get("filter_iters")
         and pdes.get("aopt_filter_gains") == pdes.get("filter_iters"),
         "a filter iteration did not launch its engine once: kernel 3 "
         f"{pd1.get('filter_gains')} of {pd1.get('filter_iters')}, kernel "
         f"5 {pdes.get('aopt_filter_gains')} of {pdes.get('filter_iters')}")

    # -- every DASH bucket against select_batched --------------------------
    probe = srv.cache.get("d1").opt_probe[k] * pol.opt_margin
    cfgs = {}
    for tag, name, obj, seeds, opt, alpha in (
            ("d1 probe", "d1", reg, range(0, 8), probe, pol.alpha),
            ("d1 pinned", "d1", reg, range(8, 16), SERVE_D1_GUESS["opt"],
             SERVE_D1_GUESS["alpha"]),
            ("design", "design", dobj, range(200, 208)) + guess):
        cfg = DashConfig(k=k, eps=pol.eps, alpha=alpha,
                         n_samples=pol.n_samples).resolve(obj.n)
        cfgs[tag] = (opt, alpha, cfg)
        want = select_batched("dash", obj, k, [SeedKey(s) for s in seeds],
                              opt=opt, alpha=alpha, eps=pol.eps,
                              n_samples=pol.n_samples, device="cuda")
        got = [r for r, q in zip(replies, reqs)
               if q.dataset == name and q.algo == "dash" and q.k == k
               and q.key in seeds]
        need(len(got) == 8, f"{tag}: {len(got)} replies of a bucket")
        masks = want.sel_mask.cpu().numpy()
        for lane, r in enumerate(got):
            need(np.array_equal(r.sel_mask, masks[lane]),
                 f"{tag} seed {seeds[lane]}: the served set is not "
                 "select_batched's")
        iters = want.raw.trace.filter_iters.cpu().numpy()
        log(f"[serve] {tag} seeds {seeds.start}-{seeds.stop - 1}: 8 sets "
            f"= select_batched's, bit for bit (OPT {opt:.6f}, alpha "
            f"{alpha}, r={cfg.r}, b={cfg.block}); values "
            f"{[round(r.value, 6) for r in got]}; filter iterations a "
            f"lane {iters.sum(axis=1).tolist()}, in "
            f"{int((iters.max(axis=0) > 0).sum())} of {cfg.r} rounds")
        if tag == "d1 pinned":
            need(iters.sum() > 0, "the pinned d1 bucket never filtered")

    # -- chaos: every hedged reply is the unfailed run's set ---------------
    csrv = serve_server(tenants, chaos=FailureInjector(fail_at=(1,)))
    creplies, csecs, _ = serve_counted(torch, csrv,
                                       serve_load(guess))
    serve_checks(creplies, len(reqs), chaos=True)
    check_values(creplies)
    hedged, hedged_pinned = 0, 0
    for base, r, q in zip(replies, creplies, reqs):
        need(r.status == base.status, "the chaos run's statuses differ")
        if r.status == OK and r.attempts > 1:
            hedged += 1
            hedged_pinned += q.dataset == "d1" and q.opt is not None
            need(np.array_equal(base.sel_mask, r.sel_mask),
                 "a hedged reply's set is not the unfailed run's")
    need(hedged > 0 and hedged_pinned == 8,
         f"the chaos schedule did not hedge every bucket ({hedged} hedged, "
         f"{hedged_pinned} of the pinned d1 bucket)")
    log(f"[serve] chaos fail_at=(1,): {hedged} hedged replies ("
        f"{hedged_pinned} of the pinned d1 bucket) = the unfailed run's "
        f"sets, bit for bit; {csrv.stats['hedge_retries']} hedge retries; "
        f"drain {csecs:.3f} s")

    # -- the design at the server's default OPT (the TOP-k probe) ----------
    dreqs = [SelectRequest("design", k, 210 + s) for s in range(8)]
    dreplies, dsecs, dper = serve_counted(torch, srv, dreqs)
    serve_checks(dreplies, len(dreqs), chaos=False)
    dvals = [r.value for r in dreplies]
    need(all(0.0 <= v <= ranges["design"] for v in dvals),
         f"a default-OPT design value out of range: {dvals}")
    pinned = [r.value for r, q in zip(replies, reqs) if q.dataset == "design"]
    log(f"[serve] design at the default OPT ({pol.opt_margin} x the TOP-k "
        f"probe {srv.cache.get('design').opt_probe[k]:.6f}): values "
        f"{min(dvals):.6f}-{max(dvals):.6f} (mean "
        f"{sum(dvals) / len(dvals):.6f}) against RANDOM's "
        f"{rand['design']:.6f} and the pinned bucket's mean "
        f"{sum(pinned) / len(pinned):.6f}; {dper.get('design')}; "
        f"{dsecs:.3f} s (not gated against RANDOM)")

    # -- lane 0 alone against its 8-lane bucket (the pinned one) -----------
    opt, alpha, cfg = cfgs["d1 pinned"]
    bucket, ev8 = recorded_serve(torch, srv, [
        SelectRequest("d1", k, s, **SERVE_D1_GUESS) for s in range(8, 16)])
    need(all(np.array_equal(a.sel_mask, b.sel_mask)
             for a, b in zip(bucket, replies[12:20])),
         "a repeated bucket gave other sets")
    alone, ev1 = recorded_serve(torch, srv, [
        SelectRequest("d1", k, 8, **SERVE_D1_GUESS)])
    need(srv.launch_log[-1]["lanes"] == 1, "lane 0 alone was not B = 1")
    active = bits_rule("d1 seed 8 alone (B=1) vs lane 0 of its pinned "
                       "8-lane bucket", alone[0], bucket[0], ev1, ev8, 0, 0,
                       opt, alpha, cfg)
    need(active > 0, "lane 0 of the pinned bucket never filtered alone")

    # -- a warm update of 64 columns ---------------------------------------
    entry = srv.cache.get("d1")
    builds, probe0 = entry.builds, entry.opt_probe[k]
    rng = np.random.default_rng(5)
    idx = np.arange(0, reg.n, reg.n // SERVE_UPDATE_COLS)[:SERVE_UPDATE_COLS]
    cols = rng.normal(size=(reg.d, SERVE_UPDATE_COLS)).astype(np.float32)
    cols -= cols.mean(axis=0, keepdims=True)
    cols /= np.linalg.norm(cols, axis=0, keepdims=True)
    srv.update_columns("d1", idx, cols)
    need(not entry.opt_probe, "the warm update kept the OPT probe")
    wreqs = [SelectRequest("d1", k, 400 + s,
                           **(SERVE_D1_GUESS if s % 2 else {}))
             for s in range(8)]
    warm = srv.serve(wreqs)
    X2 = X1.cpu().numpy().copy()
    X2[:, idx] = cols
    fresh = serve_server([("d1", "regression", X2, y1, k)])
    cold = fresh.serve(wreqs)
    need(all(r.status == OK for r in warm + cold), "a warm reply failed")
    need(all(np.array_equal(a.sel_mask, b.sel_mask)
             for a, b in zip(warm, cold)),
         "after the warm update the sets are not a fresh server's")
    need(entry.builds == builds, "the warm update built a runner")
    need(k in entry.opt_probe, "the OPT probe was not recomputed")
    log(f"[serve] warm update of {SERVE_UPDATE_COLS} d1 columns: 8 sets = "
        f"a fresh server's, runner builds {builds} -> {entry.builds}, "
        f"objective builds {entry.objective_builds}, OPT probe "
        f"{probe0:.6f} -> {entry.opt_probe[k]:.6f}")
    del fresh, X2

    # -- small inputs: the card against the CPU, host noise -----------------
    Xs, ys, _ = make_d1_regression(seed=0, n_samples=600, n_features=200,
                                   support=40)
    Xds = make_d1_design(seed=0, n_samples=512, n_features=128)
    small = [("d1", "regression", Xs, ys, 40), ("design", "aopt", Xds, None,
                                                32)]

    def small_opt(name, lane):
        # d1's odd lanes pinned at 1.0, where its DASH filters.
        return 1.0 if name == "d1" and lane % 2 else None

    runs = {}
    for dev in ("cpu", "cuda"):
        s_srv = serve_server(small, device=dev)
        runs[dev] = [recorded_serve(torch, s_srv, [
            SelectRequest(name, kk, SeedKey(s, host=True),
                          opt=small_opt(name, s)) for s in range(4)])
            for name, _, _, _, kk in small]
        runs[dev].append((s_srv.serve([SelectRequest(
            "d1", 40, SeedKey(9, host=True), algo="topk")]), None))
        runs[dev].append({name: s_srv.cache.get(name).opt_probe[kk]
                          for name, _, _, _, kk in small})
    for (name, _, X, _, kk), (rc, ec), (rg, eg_) in zip(
            small, runs["cpu"][:2], runs["cuda"][:2]):
        scfg = DashConfig(k=kk, eps=pol.eps, alpha=pol.alpha,
                          n_samples=pol.n_samples).resolve(X.shape[1])
        sopt = runs["cpu"][3][name] * pol.opt_margin
        active = 0
        for lane, (a, b) in enumerate(zip(rc, rg)):
            need(a.status == OK and b.status == OK, "a small reply failed")
            active += bits_rule(
                f"small {name} lane {lane}, CPU vs card", a, b, ec, eg_,
                lane, lane, small_opt(name, lane) or sopt, pol.alpha, scfg)
        need(name != "d1" or active > 0,
             "the small d1's pinned lanes never filtered")
    tc, tg = runs["cpu"][2][0][0], runs["cuda"][2][0][0]
    need(np.array_equal(tc.sel_mask, tg.sel_mask),
         "small d1 TOP-k: the card's set is not the CPU's")
    secs_phase = time.perf_counter() - t_phase
    log(f"[serve] phase took {secs_phase:.1f} s (budget "
        f"{SERVE_BUDGET_S:.0f} s)")
    need(secs_phase < 2 * SERVE_BUDGET_S, "the serve phase ran far past "
         "its budget")
    return per


def time_ms(torch, fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_timing(torch, worst, launches):
    from repro_torch.kernels.common import quantize
    from repro_torch.kernels.filter_gains import (
        filter_gains,
        filter_gains_lattice_ref,
    )
    from repro_torch.kernels.marginal_gains import (
        regression_gains,
        regression_gains_ref,
    )
    from repro_torch.kernels.filter_gains.ops import (
        engine_plan,
        kernel_info as engine_info,
        workspace_elems as engine_workspace_elems,
    )
    from repro_torch.kernels.marginal_gains.ops import (
        kernel_info,
        split_plan,
        workspace_elems,
    )

    d, n, k = MAIN["d"], MAIN["n"], MAIN["k"]
    G, m, b = MAIN["n_guesses"], MAIN["n_samples"], MAIN_BLOCK
    X, Q, D, R, csq = make_operands(torch, d, n, k, b, m, G, seed=7)
    q1, r1 = Q[:1].contiguous(), R[:1, 0].contiguous()
    rG = R[:, 0].contiguous()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for prec in ("f32", "bf16"):
        xb = 4 if prec == "f32" else 2
        Xs = X.to(torch.float32 if prec == "f32" else torch.bfloat16)
        Xq = quantize(X, prec)
        # regression_gains at greedy's shape (one lane, full kcap basis)
        # and at DASH's current-state call (G lanes).
        b1, by1 = bound(2.0 * d * n * (k + 1),
                        xb * d * n + 4 * (d * k + d + 2 * n))
        t1 = time_ms(torch, lambda: regression_gains(Xs, q1, r1, csq,
                                                     precision=prec))
        p1 = time_ms(torch, lambda: regression_gains_ref(Xq, q1, r1, csq))
        bG, _ = bound(2.0 * d * n * (k + 1) * G,
                      xb * d * n + 4 * (G * d * k + G * d + n + G * n))
        tG = time_ms(torch, lambda: regression_gains(Xs, Q, rG, csq,
                                                     precision=prec))
        info = kernel_info(Xs.dtype)
        for lanes, t, bd in ((1, t1, b1), (G, tG, bG)):
            s_, rps = split_plan(lanes, d, n, k, sms)
            log(f"[timing] regression_gains {prec:4s} G={lanes}: "
                f"kernel_ms={t:.4f} bound_ms={bd:.4f} bound/kernel="
                f"{bd / t:.3f} achieved "
                f"{2.0 * d * n * (k + 1) * lanes / t / 1e9:.1f} TFLOP/s; "
                f"S={s_} ({rps} rows per slice), workspace "
                f"{4 * workspace_elems(lanes, n, k, s_)} bytes; partial "
                f"kernel {info['registers']} registers/thread, "
                f"{info['spill_bytes']} spill bytes, {info['smem_bytes']} B "
                f"shared/CTA, {info['threads']} threads/CTA, "
                f"{info['ctas_per_sm']} CTAs/SM")
        # filter_gains at DASH's lattice shape.
        b2, by2 = bound(2.0 * d * n * (G * k + G * m * (b + 1)),
                        xb * d * n + 4 * (G * d * k + G * m * d * b
                                          + G * m * d + n + G * m * n))
        t2 = time_ms(torch, lambda: filter_gains(Xs, Q, D, R, csq,
                                                 precision=prec))
        plan, fs, frows = engine_plan(G, m, d, n, k, b, sms)
        finfo = engine_info(Xs.dtype)
        log(f"[timing] filter_gains     {prec:4s} G={G} m={m}: "
            f"kernel_ms={t2:.4f} achieved "
            f"{2.0 * d * n * plan.width / t2 / 1e9:.1f} TFLOP/s "
            f"({2.0 * d * n * plan.kp / t2 / 1e9:.1f} with the padding); "
            f"stacked kp={plan.kp} ({plan.width} vectors), S={fs} ({frows} "
            f"rows per slice), workspace "
            f"{4 * engine_workspace_elems(plan, n, fs)} bytes; partial "
            f"kernel {finfo['registers']} registers/thread, "
            f"{finfo['spill_bytes']} spill bytes, {finfo['smem_bytes']} B "
            f"shared/CTA, {finfo['ctas_per_sm']} CTAs/SM")
        p2 = time_ms(torch, lambda: filter_gains_lattice_ref(Xq, Q, D, R,
                                                             csq))
        lib1 = lib2 = None
        if prec == "f32":
            # cuBLAS f32 products that dominate each kernel (no epilogue):
            # only part of the function, timed as a yardstick.
            qt = q1[0].t().contiguous()
            lib1 = time_ms(torch, lambda: qt @ X)
            stacked = torch.cat([Q.permute(0, 2, 1).reshape(-1, d),
                                 D.permute(0, 1, 3, 2).reshape(-1, d),
                                 R.reshape(-1, d)]).contiguous()
            lib2 = time_ms(torch, lambda: stacked @ X)
        for name, t, p, bd, by, lib in (
            ("regression_gains", t1, p1, b1, by1, lib1),
            ("filter_gains", t2, p2, b2, by2, lib2),
        ):
            log(f"[timing] {name:16s} {prec:4s} kernel_ms={t:.4f} "
                f"plain_ms={p:.4f} bound_ms={bd:.4f} ({by}) "
                f"library_ms={'n/a' if lib is None else f'{lib:.4f}'}"
                f"{' (cuBLAS product only)' if lib is not None else ''} "
                f"bound/kernel={bd / t:.3f}")
            if prec == "f32":
                rows.append({
                    "name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "launches": launches[name],
                    "launches_per_call": LAUNCHES_PER_CALL[name],
                    "max_abs_err": worst[name], "ms": t, "plain_ms": p,
                    "bound_ms": bd, "bound_by": by, "library_ms": lib,
                })
        del Xs, Xq
    log(f"[timing] shapes: d={d} n={n} kcap={k} G={G} m={m} b={b}; "
        f"regression_gains at G=1, filter_gains over G*m={G * m} states")
    return rows


def phase_sharded_timing(torch):
    """Each of the six selection kernels at the shape a world-2 shard of
    ``[sharded]`` gives it (n_local = n / 2, DASH's lattice), f32:
    kernel and plain version (CUDA events) beside the bound."""
    from repro_torch.kernels.aopt_gains import aopt_gains, aopt_gains_ref
    from repro_torch.kernels.filter_gains import (
        aopt_filter_gains,
        aopt_filter_gains_lattice_ref,
        filter_gains,
        filter_gains_lattice_ref,
        logistic_filter_gains,
        logistic_filter_gains_lattice_ref,
    )
    from repro_torch.kernels.logistic_gains import (
        logistic_gains,
        logistic_gains_ref,
    )
    from repro_torch.kernels.marginal_gains import (
        regression_gains,
        regression_gains_ref,
    )

    out = {}

    def row(name, shape, t, p, bd_by, lib=None, lib_what=""):
        bd, by = bd_by[:2]
        out[name] = {"shape": shape, "ms": t, "plain_ms": p, "bound_ms": bd,
                     "bound_by": by, "library_ms": lib}
        lib_s = "n/a" if lib is None else f"{lib:.4f} ({lib_what})"
        log(f"[timing] {name:21s} f32 sharded shape {shape}: kernel_ms="
            f"{t:.4f} plain_ms={p:.4f} bound_ms={bd:.4f} ({by}) "
            f"library_ms={lib_s} bound/kernel={bd / t:.3f}")

    d, n, k = MAIN["d"], MAIN["n"] // 2, MAIN["k"]
    G, m, b = MAIN["n_guesses"], MAIN["n_samples"], MAIN_BLOCK
    X, Q, D, R, csq = make_operands(torch, d, n, k, b, m, G, seed=17)
    rG = R[:, 0].contiguous()
    # cuBLAS f32 products that dominate each kernel (no epilogue): only
    # part of the function, timed as a yardstick.
    qt = Q.permute(0, 2, 1).reshape(-1, d).contiguous()
    row("regression_gains", f"d={d} n_local={n} G={G} k={k}",
        time_ms(torch, lambda: regression_gains(X, Q, rG, csq)),
        time_ms(torch, lambda: regression_gains_ref(X, Q, rG, csq)),
        bound(2.0 * d * n * (k + 1) * G,
              4 * (d * n + G * d * k + G * d + n + G * n)),
        time_ms(torch, lambda: qt @ X), "cuBLAS f32 Q^T X of the G lanes")
    stacked = torch.cat([qt, D.permute(0, 1, 3, 2).reshape(-1, d),
                         R.reshape(-1, d)]).contiguous()
    row("filter_gains", f"d={d} n_local={n} G={G} m={m} b={b}",
        time_ms(torch, lambda: filter_gains(X, Q, D, R, csq)),
        time_ms(torch, lambda: filter_gains_lattice_ref(X, Q, D, R, csq)),
        bound(2.0 * d * n * (G * k + G * m * (b + 1)),
              4 * (d * n + G * d * k + G * m * d * b + G * m * d + n
                   + G * m * n)),
        time_ms(torch, lambda: stacked @ X),
        "cuBLAS f32 stacked [Q;D;R]^T X")
    del X, Q, D, R, csq, qt, stacked
    d, n, g = DESIGN["d"], DESIGN["n"] // 2, DESIGN_LANES
    m, b = DESIGN["n_samples"], DESIGN_BLOCK
    X, W, E, F, isig2 = make_aopt_operands(torch, d, n, g, m, b, n_sel=64,
                                           seed=19)
    row("aopt_gains", f"d={d} n_local={n} G={g}",
        time_ms(torch, lambda: aopt_gains(X, W, isig2)),
        time_ms(torch, lambda: aopt_gains_ref(X, W, isig2)),
        bound(4.0 * d * n * g + 3.0 * g * n, 4 * (d * n * (1 + g) + g * n)))
    et = E.permute(0, 1, 3, 2).reshape(g, m * b, d)
    et_all = et.reshape(g * m * b, d).contiguous()
    et = et.contiguous()
    row("aopt_filter_gains", f"d={d} n_local={n} G={g} m={m} b={b}",
        time_ms(torch, lambda: aopt_filter_gains(X, W, E, F, isig2)),
        time_ms(torch, lambda: aopt_filter_gains_lattice_ref(X, W, E, F,
                                                             isig2)),
        bound(4.0 * d * n * g + g * m * n * (4.0 * d * b + 2.0 * b * b
                                             + 6.0 * b + 6.0),
              4 * (d * n * (1 + g) + g * m * (d * b + b * b + n))),
        time_ms(torch, lambda: (et_all @ X, torch.bmm(et, W))),
        "cuBLAS f32 E^T X and E_g^T W_g only")
    del X, W, E, F, et, et_all
    d, n, G = CLASS["d"], CLASS["n"] // 2, CLASS["n_guesses"]
    m, b, steps = CLASS["n_samples"], CLASS_BLOCK, 3
    X, y, Eta, etas = make_logistic_operands(torch, d, n, G, m, b,
                                             n_sel=64, seed=23)
    row("logistic_gains", f"d={d} n_local={n} G={G}",
        time_ms(torch, lambda: logistic_gains(X, y, Eta, steps=steps)),
        time_ms(torch, lambda: torch.stack([
            logistic_gains_ref(X, y, e, steps=steps) for e in Eta]),
            iters=3, warmup=1),
        logistic_bound(d, n, G, steps, 4))
    row("logistic_filter_gains", f"d={d} n_local={n} states={G * m}",
        time_ms(torch, lambda: logistic_filter_gains(X, y, etas,
                                                     steps=steps)),
        time_ms(torch, lambda: logistic_filter_gains_lattice_ref(
            X, y, etas, steps=steps), iters=3, warmup=1),
        logistic_bound(d, n, G * m, steps, 4))
    return out


def phase_serve_timing(torch, per):
    """Kernels 1, 3, 4 and 5 at the shapes ``[serve]``'s 8-lane DASH
    buckets give them (the default ServePolicy's m = 4; d1 at the main
    D1, b = 10; the design at the design main, b = 8), f32: kernel, plain
    version and a cuBLAS yardstick (CUDA events) beside the bound, with
    the launches ``[serve]`` counted (``per``, by tenant)."""
    from repro_torch.kernels.aopt_gains import aopt_gains, aopt_gains_ref
    from repro_torch.kernels.filter_gains import (
        aopt_filter_gains,
        aopt_filter_gains_lattice_ref,
        filter_gains,
        filter_gains_lattice_ref,
    )
    from repro_torch.kernels.marginal_gains import (
        regression_gains,
        regression_gains_ref,
    )
    from repro_torch.serve import ServePolicy

    out = {}
    G, m = SERVE_ADMISSION["max_batch"], ServePolicy().n_samples

    def row(name, tenant, shape, t, p, bd_by, lib, lib_what):
        bd, by = bd_by[:2]
        launches = per.get(tenant, {}).get(name, 0)
        out[name] = {"shape": shape, "launches": launches, "ms": t,
                     "plain_ms": p, "bound_ms": bd, "bound_by": by,
                     "library_ms": lib}
        lib_s = "n/a" if lib is None else f"{lib:.4f} ({lib_what})"
        log(f"[timing] {name:17s} f32 serve shape {shape}: kernel_ms="
            f"{t:.4f} plain_ms={p:.4f} bound_ms={bd:.4f} ({by}) "
            f"library_ms={lib_s} bound/kernel={bd / t:.3f}; launches in "
            f"[serve] ({tenant}) {launches}")

    d, n, k, b = MAIN["d"], MAIN["n"], MAIN["k"], MAIN_BLOCK
    X, Q, D, R, csq = make_operands(torch, d, n, k, b, m, G, seed=29)
    rG = R[:, 0].contiguous()
    qt = Q.permute(0, 2, 1).reshape(-1, d).contiguous()
    row("regression_gains", "d1", f"d={d} n={n} G={G} k={k}",
        time_ms(torch, lambda: regression_gains(X, Q, rG, csq)),
        time_ms(torch, lambda: regression_gains_ref(X, Q, rG, csq)),
        bound(2.0 * d * n * (k + 1) * G,
              4 * (d * n + G * d * k + G * d + n + G * n)),
        time_ms(torch, lambda: qt @ X), "cuBLAS f32 Q^T X of the G lanes")
    stacked = torch.cat([qt, D.permute(0, 1, 3, 2).reshape(-1, d),
                         R.reshape(-1, d)]).contiguous()
    row("filter_gains", "d1", f"d={d} n={n} G={G} m={m} b={b}",
        time_ms(torch, lambda: filter_gains(X, Q, D, R, csq)),
        time_ms(torch, lambda: filter_gains_lattice_ref(X, Q, D, R, csq)),
        bound(2.0 * d * n * (G * k + G * m * (b + 1)),
              4 * (d * n + G * d * k + G * m * d * b + G * m * d + n
                   + G * m * n)),
        time_ms(torch, lambda: stacked @ X),
        "cuBLAS f32 stacked [Q;D;R]^T X")
    del X, Q, D, R, csq, qt, stacked
    d, n, b = DESIGN["d"], DESIGN["n"], DESIGN_BLOCK
    X, W, E, F, isig2 = make_aopt_operands(torch, d, n, G, m, b, n_sel=64,
                                           seed=31)
    row("aopt_gains", "design", f"d={d} n={n} G={G}",
        time_ms(torch, lambda: aopt_gains(X, W, isig2)),
        time_ms(torch, lambda: aopt_gains_ref(X, W, isig2)),
        bound(4.0 * d * n * G + 3.0 * G * n, 4 * (d * n * (1 + G) + G * n)),
        None, "")
    et = E.permute(0, 1, 3, 2).reshape(G, m * b, d)
    et_all = et.reshape(G * m * b, d).contiguous()
    et = et.contiguous()
    row("aopt_filter_gains", "design", f"d={d} n={n} G={G} m={m} b={b}",
        time_ms(torch, lambda: aopt_filter_gains(X, W, E, F, isig2)),
        time_ms(torch, lambda: aopt_filter_gains_lattice_ref(X, W, E, F,
                                                             isig2)),
        bound(4.0 * d * n * G + G * m * n * (4.0 * d * b + 2.0 * b * b
                                             + 6.0 * b + 6.0),
              4 * (d * n * (1 + G) + G * m * (d * b + b * b + n))),
        time_ms(torch, lambda: (et_all @ X, torch.bmm(et, W))),
        "cuBLAS f32 E^T X and E_g^T W_g only")
    del X, W, E, F, et, et_all
    torch.cuda.empty_cache()
    return out


def phase_aopt_timing(torch, worst, launches):
    from repro_torch.kernels.aopt_gains import aopt_gains, aopt_gains_ref
    from repro_torch.kernels.common import quantize
    from repro_torch.kernels.filter_gains import (
        aopt_filter_gains,
        aopt_filter_gains_lattice_ref,
    )
    from repro_torch.kernels.filter_gains.ops import (
        AOPT_ROUND_B,
        aopt_kernel_info,
        aopt_plan,
        aopt_scratch_elems,
    )

    d, n = DESIGN["d"], DESIGN["n"]
    m, b = DESIGN["n_samples"], DESIGN_BLOCK
    X, W, E, F, isig2 = make_aopt_operands(torch, d, n, DESIGN_LANES, m, b,
                                           n_sel=64, seed=11)
    rows = []
    # aopt_gains at greedy's shape (one lane); aopt_filter_gains at the
    # design DASH lattice (12 lanes) and at the 6 lanes of one α.
    shapes = (("aopt_gains", 1), ("aopt_filter_gains", DESIGN_LANES),
              ("aopt_filter_gains", DESIGN["n_guesses"]))
    for prec in ("f32", "bf16"):
        xb = 4 if prec == "f32" else 2
        sdt = torch.float32 if prec == "f32" else torch.bfloat16
        Xs, Ws = X.to(sdt), W.to(sdt)
        Xq, Wq = quantize(X, prec), quantize(W, prec)
        for name, g in shapes:
            Wg, Wqg = Ws[:g], Wq[:g]
            Eg, Fg = E[:g].contiguous(), F[:g].contiguous()
            lib = None
            if name == "aopt_gains":
                bd, by = bound(4.0 * d * n * g + 3.0 * g * n,
                               xb * d * n * (1 + g) + 4 * g * n)
                t = time_ms(torch, lambda: aopt_gains(Xs, Wg, isig2,
                                                      precision=prec))
                p = time_ms(torch, lambda: aopt_gains_ref(Xq, Wqg, isig2))
            else:
                bd, by = bound(4.0 * d * n * g
                               + g * m * n * (4.0 * d * b + 2.0 * b * b
                                              + 6.0 * b + 6.0),
                               xb * d * n * (1 + g)
                               + 4 * g * m * (d * b + b * b + n))
                t = time_ms(torch, lambda: aopt_filter_gains(
                    Xs, Wg, Eg, Fg, isig2, precision=prec))
                p = time_ms(torch, lambda: aopt_filter_gains_lattice_ref(
                    Xq, Wqg, Eg, Fg, isig2))
                if prec == "f32":
                    # cuBLAS f32 E^T X and E_g^T W_g alone: only the two
                    # products of the function, timed as a yardstick.
                    et = Eg.permute(0, 1, 3, 2).reshape(g, m * b, d)
                    et_all = et.reshape(g * m * b, d).contiguous()
                    et = et.contiguous()
                    lib = time_ms(torch, lambda: (et_all @ X,
                                                  torch.bmm(et, W[:g])))
            lib_s = "n/a" if lib is None else f"{lib:.4f} (cuBLAS only)"
            log(f"[timing] {name:17s} {prec:4s} G={g:2d} kernel_ms={t:.4f} "
                f"plain_ms={p:.4f} bound_ms={bd:.4f} ({by}) "
                f"library_ms={lib_s} bound/kernel={bd / t:.3f}")
            if name == "aopt_filter_gains":
                log_aopt_plan(torch, prec, g, m, b, aopt_plan,
                              aopt_kernel_info, t)
            if prec == "f32" and (name == "aopt_gains"
                                  or g == DESIGN_LANES):
                rows.append({
                    "name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "launches": launches[name],
                    "launches_per_call": LAUNCHES_PER_CALL[name],
                    "max_abs_err": worst[name], "ms": t, "plain_ms": p,
                    "bound_ms": bd, "bound_by": by, "library_ms": lib,
                })
        del Xs, Ws, Xq, Wq
    # aopt_filter_gains past one chunk: b = 128 Woodbury columns per
    # sample in two chunks of 64, at the 6 lanes of one α.
    g, wb = DESIGN["n_guesses"], 2 * AOPT_ROUND_B
    Ew = torch.randn((g, m, d, wb), device="cuda") * (0.1 / math.sqrt(d))
    Fw = Ew.transpose(-1, -2) @ Ew
    Wg = W[:g]
    tw = time_ms(torch, lambda: aopt_filter_gains(X, Wg, Ew, Fw, isig2),
                 iters=3, warmup=1)
    bw, byw = bound(4.0 * d * n * g
                    + g * m * n * (4.0 * d * wb + 2.0 * wb * wb
                                   + 6.0 * wb + 6.0),
                    4 * d * n * (1 + g) + 4 * g * m * (d * wb + wb * wb + n))
    # cuBLAS f32 E^T X and E_g^T W_g alone at b = 128: the yardstick.
    et = Ew.permute(0, 1, 3, 2).reshape(g, m * wb, d).contiguous()
    et_all = et.reshape(g * m * wb, d)
    libw = time_ms(torch, lambda: (et_all @ X, torch.bmm(et, Wg)), iters=3,
                   warmup=1)
    log(f"[timing] aopt_filter_gains f32  G={g:2d} b={wb} (chunks of "
        f"{AOPT_ROUND_B}): kernel_ms={tw:.4f} bound_ms={bw:.4f} ({byw}) "
        f"library_ms={libw:.4f} (cuBLAS only) bound/kernel={bw / tw:.3f}; "
        f"scratch {4 * aopt_scratch_elems(g, m, n, wb)} bytes")
    log_aopt_plan(torch, "f32", g, m, wb, aopt_plan, aopt_kernel_info, tw)
    del Ew, Fw, Wg, et, et_all
    log(f"[timing] shapes: d={d} n={n} m={m} b={b}; aopt_gains at G=1 "
        f"(no single library call computes it), aopt_filter_gains over "
        f"G*m states at G={DESIGN_LANES} (the design lattice) and "
        f"G={DESIGN['n_guesses']}")
    return rows


def phase_coreset_timing(torch, launches):
    """Kernels 4 and 5 at the coreset's shape (d = 64, n = 4096, one
    lane; kernel 5 over m = 4 samples of b = 22), f32: CUDA-event ms,
    the plain version's, the bound and, for kernel 5, cuBLAS's two
    products alone; beside the [coreset] run's launches."""
    from repro_torch.kernels.aopt_gains import aopt_gains, aopt_gains_ref
    from repro_torch.kernels.filter_gains import (
        aopt_filter_gains,
        aopt_filter_gains_lattice_ref,
    )

    d, n, g = CORESET["dim_cap"], CORESET["pool"], 1
    m, b = CORESET["n_samples"], CORESET_BLOCK
    X, W, E, F, isig2 = make_aopt_operands(torch, d, n, g, m, b, n_sel=128,
                                           seed=5)
    b4, by4 = bound(4.0 * d * n * g + 3.0 * g * n,
                    4 * d * n * (1 + g) + 4 * g * n)
    t4 = time_ms(torch, lambda: aopt_gains(X, W, isig2))
    p4 = time_ms(torch, lambda: aopt_gains_ref(X, W, isig2))
    b5, by5 = bound(4.0 * d * n * g + g * m * n * (4.0 * d * b + 2.0 * b * b
                                                   + 6.0 * b + 6.0),
                    4 * d * n * (1 + g) + 4 * g * m * (d * b + b * b + n))
    t5 = time_ms(torch, lambda: aopt_filter_gains(X, W, E, F, isig2))
    p5 = time_ms(torch, lambda: aopt_filter_gains_lattice_ref(X, W, E, F,
                                                              isig2))
    et = E.permute(0, 1, 3, 2).reshape(g, m * b, d).contiguous()
    et_all = et.reshape(g * m * b, d)
    lib5 = time_ms(torch, lambda: (et_all @ X, torch.bmm(et, W)))
    out = {}
    for name, t, p, bd, by, lib in (
        ("aopt_gains", t4, p4, b4, by4, None),
        ("aopt_filter_gains", t5, p5, b5, by5, lib5),
    ):
        log(f"[timing] {name:17s} f32  coreset shape d={d} n={n} G={g} "
            f"m={m} b={b}: kernel_ms={t:.4f} plain_ms={p:.4f} bound_ms="
            f"{bd:.4f} ({by}) library_ms="
            f"{'n/a' if lib is None else f'{lib:.4f} (cuBLAS only)'} "
            f"bound/kernel={bd / t:.3f} launches in [coreset]="
            f"{launches.get(name, 0)}")
        out[name] = {"d": d, "n": n, "G": g, "m": m, "b": b, "ms": t,
                     "plain_ms": p, "bound_ms": bd, "bound_by": by,
                     "library_ms": lib, "launches": launches.get(name, 0)}
    return out


def log_aopt_plan(torch, prec, g, m, b, aopt_plan, aopt_kernel_info, t):
    """Kernel 5's plan at (G, m, b) and what the CUDA runtime says of the
    instance it runs: registers, spills, shared memory, CTAs per SM; the
    rate of its t and u flops in time t."""
    d, n = DESIGN["d"], DESIGN["n"]
    plan = aopt_plan(m, b)
    info = aopt_kernel_info(
        torch.float32 if prec == "f32" else torch.bfloat16)
    ctas = -(-n // 128) * g * plan.units
    log(f"[timing] aopt_filter_gains {prec:4s} G={g:2d} b={b}: slot "
        f"{plan.bs} columns, {plan.ms} per unit, {plan.nc} chunk(s), "
        f"{plan.units} unit(s) per guess, {ctas} CTAs; "
        f"{info['registers']} registers/thread, {info['spill_bytes']} spill "
        f"bytes, {info['smem_bytes']} B shared/CTA, {info['ctas_per_sm']} "
        f"CTAs/SM; t and u at "
        f"{4.0 * d * b * g * m * n / t / 1e9:.1f} TFLOP/s")


def phase_fast_timing(torch, reg_obj, launches):
    """Kernels 3, 5 and 7 at FAST's prefix shapes (k = 128: 129 prefixes
    of b = 128 columns; kernel 7 over 129 states), f32: CUDA-event ms,
    the plain version's, the bound and a cuBLAS yardstick, beside the
    registry runs' launches.  The bounds count what the prefixes need:
    prefix j holds j columns (Σ_j j = 8256 of the 16,512 slots) and the
    regression basis |S| = 1 of its 128 (the kernels multiply the zero
    columns too).  Also the MGS deltas of the 129 prefixes
    (``expand_basis``), the regression engine's other step."""
    from repro_torch.kernels.filter_gains import (
        aopt_filter_gains,
        aopt_filter_gains_lattice_ref,
        filter_gains,
        filter_gains_lattice_ref,
        logistic_filter_gains,
        logistic_filter_gains_lattice_ref,
    )
    from repro_torch.kernels.filter_gains.ops import (
        aopt_scratch_elems,
        engine_plan,
        pack_basis,
        workspace_elems,
    )

    b = FAST_L
    m = b + 1
    cols = b * (b + 1) // 2            # the prefixes' nonzero columns
    sq = sum(j * j for j in range(b + 1))   # Σ_j j²: F's nonzero entries
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    torch.cuda.empty_cache()

    # kernel 3: d = n = 8192, |S| = 1, one lane of 129 prefixes.
    d, n, k = MAIN["d"], MAIN["n"], MAIN["k"]
    X, Q, D, R, csq = make_operands(torch, d, n, k, b, m, 1, seed=21,
                                    fast=(1, 0))
    plan, fs, _ = engine_plan(1, m, d, n, k, b, sms)
    t = time_ms(torch, lambda: filter_gains(X, Q, D, R, csq), iters=5,
                warmup=1)
    p = time_ms(torch, lambda: filter_gains_lattice_ref(X, Q, D, R, csq),
                iters=2, warmup=1)
    bd, by = bound(2.0 * d * n * (1 + cols + m),
                   4 * (d * n + d * (1 + cols + m) + n + m * n))
    stacked = pack_basis(Q, D, R, plan).t().contiguous()
    lib = time_ms(torch, lambda: stacked @ X, iters=5, warmup=1)
    dense = 2.0 * d * n * plan.kp / F32_PEAK_FLOPS * 1e3
    del stacked, X, Q, D, R, csq
    st = reg_obj.add_set(reg_obj.init(), torch.tensor([[0]], device="cuda"),
                         torch.ones((1, 1), dtype=torch.bool, device="cuda"))
    idx = torch.randperm(n, device="cuda")[1:b + 1]
    idx = idx[None, None, :].expand(1, m, b).contiguous()
    mask = prefix_slots(torch, b, 0, "cuda")[None]
    t_mgs = time_ms(torch, lambda: reg_obj.expand_basis(st, idx, mask),
                    iters=2, warmup=1)
    rows["filter_gains"] = dict(
        shape=f"d={d} n={n} G=1 m={m} b={b} |S|=1 (kp {plan.kp}, S {fs})",
        ms=t, plain_ms=p, bound_ms=bd, bound_by=by, library_ms=lib,
        launches=launches.get("filter_gains"))
    log(f"[timing] filter_gains     f32  FAST prefixes d={d} n={n} m={m} "
        f"b={b} |S|=1: kernel_ms={t:.4f} plain_ms={p:.4f} bound_ms={bd:.4f} "
        f"({by}; {1 + cols + m} nonzero basis vectors of kp={plan.kp}, "
        f"dense {dense:.4f} ms) library_ms={lib:.4f} (cuBLAS f32 stacked "
        f"basis^T X only) bound/kernel={bd / t:.3f}; S={fs}, workspace "
        f"{4 * workspace_elems(plan, n, fs)} bytes; expand_basis (MGS "
        f"deltas of the {m} prefixes) {t_mgs:.4f} ms; FAST launches in the "
        f"registry main {launches.get('filter_gains')}")
    del st, idx, mask
    torch.cuda.empty_cache()

    # kernel 5: the design main, d = 1024, n = 65536, one lane.
    d, n = DESIGN["d"], DESIGN["n"]
    X, W, E, F, isig2 = make_aopt_operands(torch, d, n, 1, m, b, 40, seed=23,
                                           ragged=0)
    t = time_ms(torch, lambda: aopt_filter_gains(X, W, E, F, isig2), iters=3,
                warmup=1)
    p = time_ms(torch, lambda: aopt_filter_gains_lattice_ref(X, W, E, F,
                                                             isig2),
                iters=2, warmup=1)
    bd, by = bound(4.0 * d * n + n * (4.0 * d * cols + 2.0 * sq
                                      + 6.0 * cols + 6.0 * m),
                   4 * (2 * d * n + d * cols + sq + m * n))
    et = E[0].permute(0, 2, 1).reshape(m * b, d).contiguous()
    lib = time_ms(torch, lambda: (et @ X, et @ W[0]), iters=2, warmup=1)
    rows["aopt_filter_gains"] = dict(
        shape=f"d={d} n={n} G=1 m={m} b={b}", ms=t, plain_ms=p, bound_ms=bd,
        bound_by=by, library_ms=lib,
        launches=launches.get("aopt_filter_gains"))
    log(f"[timing] aopt_filter_gains f32  FAST prefixes d={d} n={n} m={m} "
        f"b={b}: kernel_ms={t:.4f} plain_ms={p:.4f} bound_ms={bd:.4f} "
        f"({by}; the prefixes' {cols} nonzero columns of {m * b}) "
        f"library_ms={lib:.4f} (cuBLAS f32 E^T X and E^T W only) "
        f"bound/kernel={bd / t:.3f}; scratch "
        f"{4 * aopt_scratch_elems(1, m, n, b)} bytes; FAST launches on the "
        f"design main {launches.get('aopt_filter_gains')}")
    del X, W, E, F, et
    torch.cuda.empty_cache()

    # kernel 7: the classification main, d = n = 8192, 129 states.
    d, n, steps = CLASS["d"], CLASS["n"], 3
    X, y, _, etas = make_logistic_operands(torch, d, n, 1, m, b, 1, seed=25,
                                           ragged=0)
    t = time_ms(torch, lambda: logistic_filter_gains(X, y, etas, steps=steps),
                iters=3, warmup=1)
    p = time_ms(torch, lambda: logistic_filter_gains_lattice_ref(
        X, y, etas, steps=steps), iters=1, warmup=1)
    bd, by, terms = logistic_bound(d, n, m, steps, 4)
    rows["logistic_filter_gains"] = dict(
        shape=f"d={d} n={n} states={m}", ms=t, plain_ms=p, bound_ms=bd,
        bound_by=by, library_ms=None,
        launches=launches.get("logistic_filter_gains"))
    log(f"[timing] logistic_filter_gains f32 FAST prefixes d={d} n={n} "
        f"states={m}: kernel_ms={t:.4f} plain_ms={p:.4f} bound_ms={bd:.4f} "
        f"({by}: bytes {terms['bytes']:.4f}, f32 flops "
        f"{terms['f32_flops']:.4f}, special-function units "
        f"{terms['sfu']:.4f}) library_ms=none bound/kernel={bd / t:.3f}; "
        f"FAST launches on the classification main "
        f"{launches.get('logistic_filter_gains')}")
    del X, y, etas
    torch.cuda.empty_cache()
    return rows


# f32 flops of one log1pf (csrc/logistic_gains.cu::log1pf_01): 4 adds
# and multiplies and 11 FMAs of 2 flops.
LOG1PF_FLOPS = 26.0


def logistic_bound(d, n, states, steps, xb):
    """The least time for ``states`` Newton sweeps over X (d, n): the
    larger of the bytes (X once in its storage type, y, the logits and
    the gains), the f32 flops and the transcendentals on the
    special-function units.  Counted per element and state from the
    reference's recurrence (csrc/logistic_gains.cu's header): each Newton
    step 11 flops, one exponential and one reciprocal on the
    special-function units; the closing pass 8 flops, one expf there and
    one log1pf; per row and state the old log-likelihood term, 5 flops,
    one expf and one log1pf.  log1pf takes no special-function unit: it
    is integer arithmetic and a polynomial, LOG1PF_FLOPS f32 flops
    (csrc: log1pf_01).  Returns (bound_ms, bound_by, {term: ms})."""
    elems = states * d * n
    flops = (elems * (11.0 * steps + 8.0 + LOG1PF_FLOPS)
             + states * d * (5.0 + LOG1PF_FLOPS))
    sfu = elems * (2.0 * steps + 1.0) + states * d * 1.0
    nbytes = xb * d * n + 4.0 * (d + states * d + states * n)
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "f32_flops": flops / F32_PEAK_FLOPS * 1e3,
             "sfu": sfu / SFU_OPS_PER_S * 1e3}
    top = max(terms, key=terms.get)
    return terms[top], "bytes" if top == "bytes" else "operations", terms


def phase_logistic_timing(torch, worst, launches):
    from repro_torch.kernels.common import quantize, sm_count
    from repro_torch.kernels.filter_gains import (
        logistic_filter_gains,
        logistic_filter_gains_lattice_ref,
    )
    from repro_torch.kernels.logistic_gains import (
        logistic_gains,
        logistic_gains_ref,
    )
    from repro_torch.kernels.logistic_gains.ops import (
        ENGINE_STATES_PER_PASS,
        cluster_plan,
        kernel_info,
    )

    d, n = CLASS["d"], CLASS["n"]
    G, m, b = CLASS["n_guesses"], CLASS["n_samples"], CLASS_BLOCK
    X, y, E, etas = make_logistic_operands(torch, d, n, G, m, b, n_sel=64,
                                           seed=13)
    e1 = E[:1].contiguous()
    steps = 3
    rows = []
    for prec in ("f32", "bf16"):
        xb = 4 if prec == "f32" else 2
        Xs = X.to(torch.float32 if prec == "f32" else torch.bfloat16)
        Xq = quantize(X, prec)
        # logistic_gains at greedy's shape (one lane) and at DASH's
        # current-state call (G lanes); the engine over the G*m states of
        # DASH's lattice.
        sms = sm_count(X.device)
        plans = {"logistic_gains": cluster_plan(1, d, n, Xs.dtype, sms),
                 "logistic_filter_gains": cluster_plan(
                     G * m, d, n, Xs.dtype, sms, ENGINE_STATES_PER_PASS)}
        bG, _, _ = logistic_bound(d, n, G, steps, xb)
        tG = time_ms(torch, lambda: logistic_gains(Xs, y, E, steps=steps,
                                                   precision=prec))
        log(f"[timing] logistic_gains        {prec:4s} states={G:2d} "
            f"kernel_ms={tG:.4f} bound_ms={bG:.4f} bound/kernel="
            f"{bG / tG:.3f}")
        for name, states, run, plain in (
            ("logistic_gains", 1,
             lambda: logistic_gains(Xs, y, e1, steps=steps, precision=prec),
             lambda: logistic_gains_ref(Xq, y, e1[0], steps=steps)),
            ("logistic_filter_gains", G * m,
             lambda: logistic_filter_gains(Xs, y, etas, steps=steps,
                                           precision=prec),
             lambda: logistic_filter_gains_lattice_ref(Xq, y, etas,
                                                       steps=steps)),
        ):
            bd, by, terms = logistic_bound(d, n, states, steps, xb)
            t = time_ms(torch, run)
            p = time_ms(torch, plain, iters=3, warmup=1)
            plan = plans[name]
            info = kernel_info(Xs.dtype, plan)
            extra = (f"; plan C={plan.cluster} R={plan.rows} BN={plan.bn} "
                     f"L={plan.states_per_pass} slab {plan.smem_bytes} "
                     f"bytes/CTA tail_rows={plan.tail_rows} "
                     f"CTAs={plan.ctas}; {info['registers']} "
                     f"registers/thread, {info['spill_bytes']} spill bytes, "
                     f"{info['smem_bytes']} B shared/CTA, "
                     f"{info['threads']} threads/CTA, "
                     f"{info['active_clusters']} active clusters of "
                     f"{plan.cluster}")
            need(info["spill_bytes"] == 0
                 and info["smem_bytes"] == plan.smem_bytes,
                 f"{name} {prec}: {info} at {plan}")
            log(f"[timing] {name:21s} {prec:4s} states={states:2d} "
                f"kernel_ms={t:.4f} plain_ms={p:.4f} bound_ms={bd:.4f} "
                f"({by}: bytes {terms['bytes']:.4f}, f32 flops "
                f"{terms['f32_flops']:.4f}, special-function units "
                f"{terms['sfu']:.4f}) library_ms=none bound/kernel="
                f"{bd / t:.3f}{extra}")
            if prec == "f32":
                rows.append({
                    "name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "launches": launches[name],
                    "launches_per_call": LAUNCHES_PER_CALL[name],
                    "max_abs_err": worst[name], "ms": t, "plain_ms": p,
                    "bound_ms": bd, "bound_by": by, "bound_terms_ms": terms,
                    "library_ms": None,
                })
        del Xs, Xq
    log(f"[timing] shapes: d={d} n={n} steps={steps}; logistic_gains at "
        f"G=1 and G={G}, logistic_filter_gains over G*m={G * m} states (no "
        f"single library call computes either)")
    return rows


# ---------------------------------------------------------------------------
# 15. where the time goes
# ---------------------------------------------------------------------------

def _device_us(event):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def profile_runs(out, design, cls, fast_opt):
    """The runs the profile phase replays: the main phase's greedy and
    DASH, the design main phase's DASH and the classification main
    phase's greedy and DASH, each as it ran there, and the first
    FAST_PROFILE_ROUNDS rounds of one probe of the registry main's FAST,
    at the OPT guess its binary search kept (``fast_opt``)."""
    from repro_torch.core import SeedKey, dash_auto, greedy, select

    obj, k = out["objective"], MAIN["k"]
    dobj, cobj = design["objective"], cls["objective"]
    return {
        "greedy": lambda: greedy(obj, k, device="cuda"),
        "dash": lambda: dash_auto(obj, k, SeedKey(0), eps=0.25, alpha=0.6,
                                  n_samples=MAIN["n_samples"],
                                  n_guesses=MAIN["n_guesses"],
                                  device="cuda"),
        "design dash": lambda: dash_auto(
            dobj, DESIGN["k"], SeedKey(0), eps=0.25, alpha=design["alpha"],
            alphas=design["alphas"], n_samples=DESIGN["n_samples"],
            n_guesses=DESIGN["n_guesses"], device="cuda"),
        "classification greedy": lambda: greedy(cobj, CLASS["k"],
                                                device="cuda"),
        "classification dash": lambda: dash_auto(
            cobj, CLASS["k"], SeedKey(0), eps=0.25, alpha=cls["alpha"],
            n_samples=CLASS["n_samples"], n_guesses=CLASS["n_guesses"],
            device="cuda"),
        f"registry fast ({FAST_PROFILE_ROUNDS} rounds)": lambda: select(
            "fast", obj, k, key=SeedKey(0), opt=fast_opt,
            max_rounds=FAST_PROFILE_ROUNDS, device="cuda"),
    }


def slice6_profile_runs(torch, design, lm):
    """The diversified design DASH of ``[design diversified]`` and one
    batch of ``[coreset]``'s grad features, each as it ran there."""
    from repro_torch import experimental_design as ed
    from repro_torch.core.objectives import coreset_features

    tok = torch.randint(0, lm["model"].cfg.vocab_size,
                        (CORESET["batch"], CORESET["seq"]), device="cuda",
                        dtype=torch.int32)
    return {
        "design diversified dash": lambda: ed.diversified(
            design["objective"], DESIGN["k"], design["alpha"], seed=0,
            n_guesses=DESIGN["n_guesses"], n_samples=DESIGN["n_samples"]),
        "coreset grad features (one batch)": lambda: coreset_features(
            lm["model"], lm["params"], {"tokens": tok}, mode="grad"),
    }


# The kernels of csrc/*.cu by name, as the profiler lists them (kernel 8's
# are flash_wgmma_kernel, flash_mma_kernel and flash_simt_kernel).
OWN_KERNEL = re.compile(r"gains_|epilogue_kernel|aopt_filter|flash_")


def phase_profile(torch, runs):
    """Replay each run under torch.profiler (``profiled``)."""
    for algo, fn in runs.items():
        wall, busy, ranked = profiled(torch, fn, cpu=False)
        if busy is None:
            log(f"[profile] {algo}: wall_s={wall:.4f}; device time not "
                f"measured (the profiler saw no device activity)")
            continue
        log(f"[profile] {algo}: wall_s={wall:.4f} device_busy_s={busy:.4f} "
            f"busy_share={busy / wall:.4f} (under the profiler)")
        # The 8 largest, then the port's own kernels further down.
        for e in ranked[:8] + [e for e in ranked[8:]
                               if OWN_KERNEL.search(e.key)]:
            log(f"[profile]   {_device_us(e) / 1e3:10.3f} ms  "
                f"{e.count:6d} calls  {e.key[:90]}")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch is missing; run it from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    name, smi = phase_device(torch)
    phase_build()
    d, n, k = MAIN["d"], MAIN["n"], MAIN["k"]
    G, m = MAIN["n_guesses"], MAIN["n_samples"]
    worst = phase_kernels(torch, [
        (d, n, k, MAIN_BLOCK, m, G),    # the main path's lattice shapes
        (d, n, k, MAIN_BLOCK, 1, 1),    # greedy's one-lane shape
        (d, n // 2, k, MAIN_BLOCK, m, G),   # [sharded]: a world-2 shard
        (1000, 1537, 37, 1, 3, 2),      # ragged n, b = 1, G > 1, m > 1
        (257, 513, 0, 3, 4, 2),         # odd d, k = 0
        (513, 777, 130, 17, 2, 3),      # k, b above one basis tile
        (1023, 777, 37, 3, 2, 2),       # S > 1, ragged slice; element copies
        (24, 1000, 4, 1, 2, 1),         # d below one 32-row stage
        (600, 500, 120, 10, 2, 1),      # a state's segment across a tile
        # FAST's prefix sweep at k = 128: |S| = 1 of a 128-column basis,
        # 129 prefixes of b = 128 (kp 16,896); and a small ragged one
        (d, n, k, FAST_L, FAST_L + 1, 1, (1, 0)),
        (1000, 1537, 37, 20, 21, 1, (5, 3)),
    ])
    dd, dn, dk, dm = (DESIGN["d"], DESIGN["n"], DESIGN["k"],
                      DESIGN["n_samples"])
    worst.update(phase_aopt_kernels(torch, [
        # d, n, G, m, b, |S|, sigma2
        (dd, dn, DESIGN_LANES, dm, DESIGN_BLOCK, 64, 1.0),  # design lattice
        # [sharded]: the design lattice on a world-2 shard
        (dd, dn // 2, DESIGN_LANES, dm, DESIGN_BLOCK, 64, 1.0),
        (dd, dn, 1, dm, DESIGN_BLOCK, dk - 1, 1.0),  # greedy's last state
        (1000, 1537, 2, 3, 1, 5, 0.5),   # ragged d and n, b = 1, σ² ≠ 1
        (257, 513, 2, 4, 0, 7, 1.0),     # b = 0: the singleton gain
        (513, 777, 3, 2, 64, 9, 1.0),    # b at one chunk: 8 groups of 8
        (dd, 4099, 2, 4, 128, 40, 1.0),  # b = 128: two chunks of 64
        (100, 300, 1, 9, 3, 3, 2.0),     # m above one CTA's 8 samples
        (dd, 4099, 2, 8, 17, 40, 1.0),   # 3 groups, ragged last group
        (dd, 4099, 2, 8, 9, 40, 1.0),    # m·b = 72 past one chunk
        # FAST's prefix sweep: 129 prefixes of b = 128, and a small one
        (dd, dn, 1, FAST_L + 1, FAST_L, 40, 1.0, 0),
        (300, 1000, 1, FAST_L + 1, FAST_L, 9, 1.0, 5),
        # the coreset's lattice: dim_cap 64, n 4096, one lane, m = 4,
        # b = 22 (k = 256 over 12 rounds)
        (CORESET["dim_cap"], CORESET["pool"], 1, CORESET["n_samples"],
         CORESET_BLOCK, 128, 1.0),
        # [train]'s selection: embed_dim_cap 32, a pool of 64, one lane,
        # m = 4, b = 3 (k = 16 over 6 rounds)
        (TRAIN["dim_cap"], 64, 1, TRAIN["n_samples"], 3, 8, 1.0),
    ]))
    cd, cn, cg, cm = CLASS["d"], CLASS["n"], CLASS["n_guesses"], \
        CLASS["n_samples"]
    worst.update(phase_logistic_kernels(torch, [
        # d, n, G, m, b, |S|, steps
        (cd, cn, cg, cm, CLASS_BLOCK, 64, 3),    # the main lattice
        (cd, cn // 2, cg, cm, CLASS_BLOCK, 64, 3),   # [sharded]: a shard
        (cd, cn, 1, 1, CLASS_BLOCK, CLASS["k"] - 1, 3),  # greedy's last
        (cd, cn, 1, 1, CLASS_BLOCK, 0, 3),       # greedy's first: η = 0
        (cd, cn, 1, 7, CLASS_BLOCK, 64, 3),      # 7 states: a ragged batch
        (1000, 1537, 2, 3, 5, 7, 1),             # ragged d, n; 1 step
        (1000, 1537, 2, 3, 5, 7, 4),             # 4 steps
        (600, 700, 5, 8, 4, 9, 3),               # G*m = 40
        (20000, 300, 1, 4, 5, 3, 3),             # the engine at 1 CTA/SM
        # past the on-chip capacity: the tail read from global memory
        # (and past the 58,080 rows the engine's first port could hold)
        (100_000, 100, 1, 3, 5, 3, 3),
        # FAST's prefix sweep: 129 states (prefixes of b = 128)
        (cd, cn, 1, FAST_L + 1, FAST_L, 1, 3, 0),
    ]))
    lm_worst = phase_lm_kernels(torch, LM_FLASH_CASES)
    log(f"[kernels] done at {time.perf_counter() - t0:.1f} s")
    out, launches, _ = phase_main(torch)
    log(f"[main] done at {time.perf_counter() - t0:.1f} s")
    registry = phase_registry_main(torch, out["random_value"])
    fast_launches = dict(registry["rows"]["fast"]["launches"])
    log(f"[registry main] done at {time.perf_counter() - t0:.1f} s")
    phase_parity(torch)
    design, design_launches, _ = phase_design_main(torch)
    launches.update(design_launches)
    log(f"[design] done at {time.perf_counter() - t0:.1f} s")
    phase_design_parity(torch)
    cls, class_launches, _ = phase_class_main(torch)
    launches.update(class_launches)
    log(f"[class] done at {time.perf_counter() - t0:.1f} s")
    phase_class_parity(torch)
    paths = phase_registry_paths(torch, design, cls)
    for tag in ("design", "class"):
        fast_launches.update(paths[(tag, "fast")][2])
    log(f"[registry design, class] done at {time.perf_counter() - t0:.1f} s")
    dryrun = start_dryrun()
    atexit.register(dryrun["pool"].terminate)
    phase_registry_parity(torch)
    log(f"[registry parity] done at {time.perf_counter() - t0:.1f} s")
    dryrun = collect_dryrun(dryrun)
    log(f"[dryrun] pool waited for, done at {time.perf_counter() - t0:.1f} "
        f"s")
    lm, launches["flash_attention"], _ = phase_lm_main(torch)
    log(f"[lm] done at {time.perf_counter() - t0:.1f} s")
    phase_lm_consistency(torch, lm["model"], lm["params"])
    phase_lm_parity(torch)
    log(f"[lm parity] done at {time.perf_counter() - t0:.1f} s")
    t6 = time.perf_counter()
    phase_r2_main(torch, out)
    log(f"[r2 main] done at {time.perf_counter() - t0:.1f} s")
    phase_per_sample(torch, [
        ("regression", out["objective"], MAIN["n_guesses"],
         MAIN["n_samples"], MAIN_BLOCK),
        ("design", design["objective"], DESIGN_LANES, DESIGN["n_samples"],
         DESIGN_BLOCK),
        ("classification", cls["objective"], CLASS["n_guesses"],
         CLASS["n_samples"], CLASS_BLOCK)])
    log(f"[per-sample] done at {time.perf_counter() - t0:.1f} s")
    phase_design_diversified(torch, design)
    log(f"[design diversified] done at {time.perf_counter() - t0:.1f} s")
    coreset = phase_coreset(torch, lm)
    log(f"[coreset] done at {time.perf_counter() - t0:.1f} s")
    phase_resilience(torch, out)
    log(f"[resilience] done at {time.perf_counter() - t0:.1f} s; slice 6's "
        f"phases took {time.perf_counter() - t6:.1f} s")
    t7 = time.perf_counter()
    sharded_launches = phase_sharded(torch, out, design, cls)
    log(f"[sharded] done at {time.perf_counter() - t0:.1f} s; the phase "
        f"took {time.perf_counter() - t7:.1f} s")
    serve_per = phase_serve(torch, out, design)
    log(f"[serve] done at {time.perf_counter() - t0:.1f} s")
    t9 = time.perf_counter()
    phase_moe(torch)
    log(f"[moe] done at {time.perf_counter() - t0:.1f} s")
    hybrid = phase_hybrid(torch)
    log(f"[hybrid] done at {time.perf_counter() - t0:.1f} s; slice 9's "
        f"phases took {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    phase_xlstm(torch)
    log(f"[xlstm] done at {time.perf_counter() - t0:.1f} s")
    whisper = phase_whisper(torch)
    log(f"[whisper] done at {time.perf_counter() - t0:.1f} s")
    vlm = phase_vlm(torch)
    log(f"[vlm] done at {time.perf_counter() - t0:.1f} s; slice 10's "
        f"phases took {time.perf_counter() - t10:.1f} s")
    t11 = time.perf_counter()
    train = phase_train(torch)
    log(f"[train] done at {time.perf_counter() - t0:.1f} s")
    phase_train_parity(torch)
    log(f"[train parity] done at {time.perf_counter() - t0:.1f} s; slice "
        f"11's phases took {time.perf_counter() - t11:.1f} s")
    t12 = time.perf_counter()
    train_sharded = phase_train_sharded(torch)
    log(f"[train sharded] done at {time.perf_counter() - t0:.1f} s")
    engine = phase_engine(torch, lm)
    log(f"[engine] done at {time.perf_counter() - t0:.1f} s; slice 12's "
        f"phases took {time.perf_counter() - t12:.1f} s")
    t13 = time.perf_counter()
    zero1 = phase_train_zero1(torch)
    log(f"[train zero1] done at {time.perf_counter() - t0:.1f} s; the phase "
        f"took {time.perf_counter() - t13:.1f} s")
    t_dry = time.perf_counter()
    phase_dryrun(torch, zero1, dryrun)
    log(f"[dryrun] done at {time.perf_counter() - t0:.1f} s; the phase took "
        f"{time.perf_counter() - t_dry:.1f} s; slice 13's phases took "
        f"{time.perf_counter() - t13:.1f} s")
    t_timing = time.perf_counter()
    rows = phase_timing(torch, worst, launches)
    rows += phase_aopt_timing(torch, worst, launches)
    rows += phase_logistic_timing(torch, worst, launches)
    rows += phase_lm_timing(torch, lm_worst, launches)
    sharded_rows = phase_sharded_timing(torch)
    fast_rows = phase_fast_timing(torch, out["objective"], fast_launches)
    coreset_rows = phase_coreset_timing(torch, coreset["launches"])
    serve_rows = phase_serve_timing(torch, serve_per)
    hybrid_row = phase_hybrid_flash_timing(torch, hybrid["launches"])
    slice10_rows = phase_slice10_flash_timing(torch, whisper, vlm)
    train_rows = phase_train_timing(torch, train)
    engine_row = phase_engine_timing(torch, engine)
    per_rank = {name: {f"world {w}": [r["clean"]["launches"].get(name, 0)
                                      for r in ranks]
                       for w, ranks in ((1, [train_sharded["w1"]]),
                                        (2, train_sharded["w2"]))}
                for name in ("flash_attention", "aopt_gains",
                             "aopt_filter_gains")}
    for row in rows:
        if row["name"] in train_rows:
            row["train_shape"] = train_rows[row["name"]]
        if row["name"] in per_rank:
            row["train_sharded_launches_per_rank"] = per_rank[row["name"]]
        if row["name"] == "flash_attention":
            row["engine_prefill_shape"] = engine_row
        if row["name"] in serve_rows:
            row["serve_shape"] = serve_rows[row["name"]]
        if row["name"] == "flash_attention":
            row["hybrid_d256_shape"] = hybrid_row
            row.update(slice10_rows)
        if row["name"] in fast_rows:
            row["fast_prefix_shape"] = fast_rows[row["name"]]
        if row["name"] in coreset_rows:
            row["coreset_shape"] = coreset_rows[row["name"]]
        if row["name"] in sharded_launches:
            row["sharded_shape"] = dict(sharded_rows[row["name"]],
                                        launches=sharded_launches[row["name"]])
    log(f"[timing] done at {time.perf_counter() - t0:.1f} s; the phase "
        f"took {time.perf_counter() - t_timing:.1f} s")
    runs = profile_runs(out, design, cls,
                        float(registry["rows"]["fast"]["result"].raw.opt))
    runs.update(slice6_profile_runs(torch, design, lm))
    runs.update(served_profile_runs("lm", lm))
    phase_profile(torch, runs)
    log(f"[profile] done at {time.perf_counter() - t0:.1f} s")
    log(f"[smoke] total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
