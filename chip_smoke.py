#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from src/repro_torch (nvcc, into
build/repro_torch/), then runs, each phase failing the script on error:

  1. the card's name and power limit (nvidia-smi), the kernel build time
     and ptxas's registers, stack and spill bytes per kernel (no B7
     instantiation, no B7-bwd instantiation and no bf16 B5-bwd kernel may
     have a stack or spill),
     and the card's floor for
     one launch (a one-element torch op: events per call, device time);
  2. B1 (noc_arbitrate) against its plain torch version, bitwise, on (rows,
     L) lane rows sampled from a lane-engine run on the card and on seeded
     random rows at the paper's 256 lanes (each also as int8 / transposed
     rows), and on dense operands as the "arb" engine hands them to
     arbitrate_lanes (six cycles of an "arb" run, six random states; each
     also recast to other element types and strides) against
     router.arbitrate; one device kernel per arbitrate_lanes and per
     arbitrate_rows call (torch.profiler); timed per call: arbitrate_lanes
     as the engine calls it, the raw launch and device time;
  3. B2 (noc_fused_cycles) against the plain `cycle_step_lanes` stepped as
     many times, bitwise on every LaneState field, for 1 and 500 cycles,
     then B3 (noc_fused_cycles_probed) against the same with the flight-
     recorder carry, from a non-zero carry, bitwise on every LaneState and
     ProbeLanes field; B2 and B3 are timed in turns (B2, B3, B3, B2); B2's
     clocked instantiation (not counted in LAUNCHES) runs the same 500
     cycles, bitwise equal to B2, and prints where one simulated cycle goes
     (SM clocks per stage);
     phases 2 and 3 take their inputs from sim's own per-epoch builders,
     under a fault stream and a placement stream built here, so that every
     link, router, MC and node-class mask is live;
  4. engine congruence at the full grid for CONG_EPOCHS = 3 epochs x 500
     cycles through simulate_with_trace: "fused" (B3), "arb" (B1, exactly
     1500 launches) and "ref" (plain dense torch) from one generator seed
     agree bitwise on counters, applied_config, kf_signal, gpu_vc_quota and
     every SimTrace channel (kf on SHIFT_PATH_BFS, which must change its
     applied_config; kf with the guard and joint control under fault and
     placement streams built for 3 epochs, every mask kind and both
     telemetry faults inside them; 4subnet and fair on STO);
  5. the main paths, 120 epochs x 500 cycles each: simulate(NoCConfig(
     mode="kf"), "SHIFT_PATH_BFS") and mode="fair" through B2 (exactly 120
     launches per run), with counter invariants and summarize(); then the
     traced path, simulate_with_trace of kf with the guard, joint control
     and 120-epoch fault and placement streams through B3 (120 launches, no
     B2), its SimResult bitwise the untraced run's, and the recorder:
     TraceRecorder(observe=True).record_to an npz, RecordedTrace.load, and
     the replay through simulate bitwise the untraced run; every run
     draws the JAX package's threefry streams from its seed;
  [sweep] the paper sweep on B2 at batch > 1: simulate_batch of {baseline,
     fair, kf, 4subnet} x seeds {0, 1} at the full grid (exactly 120 B2
     launches for the 8 rows), each row bitwise its standalone simulate;
     the 60-row predictor ablation (benchmarks/torch_fig_ablation.py: 4
     scenarios x 5 predictors x 3 seeds, 120 epochs) in one sweep under
     threefry's original scheme, its 20 gpu_ipc cells within 2e-6 of the
     JAX package's committed noc_ablation row in BENCH_noc.json (read-only)
     and its gate (KF >= every naive predictor on SHIFT_PATH_BFS); the
     gate scenario under the default scheme, its kf cell within 2e-6 of
     the reference's 0.735548; B2 at batch 60 (the ablation's epoch-0
     inputs) bitwise against its plain version on every LaneState field, 1
     cycle from the zero state and 1 and 100 cycles from the state 500
     cycles in; the ablation's wall and aggregate simulated cycles/s, B2's
     ms per launch at batch 60 beside batch 1, and the time to draw one
     paper run's streams;
  [scen] the named fault and placement scenarios through sweep on B2, under
     threefry's original scheme: the fault study (benchmarks/
     torch_fig_faults.py: healthy + FLAP_BFS / BROWNOUT / TELEM_GLITCH /
     FLAP_DURING_SHIFT x kf_guarded / kf / always_off x 3 seeds = 45 rows)
     and the placement study (torch_fig_placement.py: 5 scenarios x
     bandwidth / placement / joint x 3 seeds + the identity pair = 48
     rows), each grid exactly 120 B2 launches, its 15 gpu_ipc cells within
     2e-6 of the JAX package's committed noc_faults / noc_placement row in
     BENCH_noc.json (read-only), its bitwise verdict (healthy_bitwise,
     identity_bitwise), its probed runs through B3 (4 guarded runs, one
     joint run; 120 launches each) equal to the row's integer probes, and
     its gate; then under the default scheme TELEM_GLITCH / kf_guarded and
     MIX_PATH_STO_BFS / joint against the reference's 0.728684 and
     0.735650 (2e-6), and the Fig. 4 traces (torch_fig4_traffic.py, PATH)
     with their CoV claim; each grid's wall and aggregate simulated
     cycles/s;
  [replay] the predictor grid on replayed serving traces
     (benchmarks/torch_fig_trace_replay.py: 5 predictors x seeds 0-2 = 15
     rows, 120 epochs, kf_q 2e-2, one sweep, exactly 120 B2 launches
     each): (a) the JAX package's trace rebuilt from BENCH_noc.json's
     committed noc_trace_replay row (its hlo_phases costs through the
     port's demand_from_costs; each phase's rate the row's to the last
     bit), under threefry's original scheme (the row's), each
     predictor's mean GPU IPC within 2e-6 of the row and kf_beats_all
     equal to the row's; (b) the trace of the port's own prefill and
     decode steps (launch.op_cost on meta), each phase's flops, bytes,
     intensity and rate beside the row's, the verdict and margins printed
     and not gated; (c) the record -> npz -> replay check, bitwise;
  [trace] the flight-recorder renderer (benchmarks/torch_noc_trace.py) on
     the card: its check (a probed 4-epoch capture, 4 B3 launches and no
     other, invariants, npz round trip, ASCII and CSV) and its record, the
     probes-on (B3) over probes-off (B2) steady wall ratio of an 8 x 100
     run, median of 5;
  [bench] the port's benchmark drivers, each against a ledger in a temp
     dir: (a) benchmarks/torch_bench_sweep.py's smoke grid (4 points x 4 x
     50 cycles; serial arms on "ref", the batched arm on "fused"), the
     batched rows bitwise the serial rows, exactly one B2 launch an epoch,
     the row appended through the ledger and stamped with the card's
     name; (b) torch_bench_fleet_kf.py at n = 64 and 1024 (one B4 launch
     an epoch); (c) torch_kernels_bench.main(["--record", ...]): B5 f32,
     B6, B4 at three sizes, B1 on the (4, 36) lanes and B2 through
     simulate, each held against its plain version (2e-5 for B5 in f32,
     bitwise for the others) before it is timed; (d) torch_check_bench
     --grid smoke over that ledger, exit 0; (e) the one-card dry run
     (repro_torch.launch.dryrun, meta tensors) of llama3.2-3b's decode_32k
     and train_4k cells at its published config, rendered by
     torch_roofline_table.py; the phase's launches go onto the kernels
     line;
  [B4] the KF bank kernel (kf_bank) against its plain version, bitwise,
     at n = 7 ... 1,048,576 filters and M = 3, 5 observations, in its step
     form and its epoch form (the boost signal fused in, against
     kf_bank_epoch_plain), timed with its bytes bound (GB/s at n =
     1,048,576 on events and on device time); then the fleet path:
     FleetKF(65,536).epoch for 200 epochs (exactly 200 launches, one
     device kernel an epoch under torch.profiler), held against the same
     epochs through the plain version on the card, and an epoch timed
     alone (events, device time);
  [B5] the flash attention kernels (flash_attn: bf16 through the wgmma
     kernel fed by TMA, f32 through the SIMT kernel) against their plain
     version at the llama3.2-3b shape (S = 48, 512, 2048, causal), the
     h2o-danube-1.8b shape at S = 6144 with its 4096 window, the grok-1
     shape with its logit cap (S = 512, also with kv_len < Sk, and 2048),
     zamba2's shared block (H = KV = 32, D = 80, causal) at S = 512 and
     2048, llama4-maverick's (H 40, KV 8, D 128: GQA groups of 5) at
     S = 512 and 2048, seamless-m4t's encoder (H = KV = 16, D = 64, no
     mask) at 1536 frames, also with kv_len = 1000, its decoder (causal)
     at S = 2048 and internvl2's (H 16, KV 8, D 128) at S = 2048; the
     bf16 kernel and torch's scaled_dot_product_attention timed at each
     llama, zamba2 and maverick shape, seamless's encoder and internvl2's
     (device time under torch.profiler, and CUDA events per call)
     beside the bound, and the kernel alone at grok-1's S = 2048 (SDPA has
     no logit cap);
  [serve-w] llama3.2-3b at full width cut to 2 layers: prefill of a
     256-token prompt and 2 decode steps on the card (B5) against the same
     parameters on the CPU (plain), relative L2 of K/V and logits; the
     CPU's run and the comparison (as [serve-mw]'s and [serve-zw]'s) later,
     on a worker thread beside [train]'s steps, which keep the card busy;
  [serve] the serving main path: Engine(mode="kf") over 32 requests on
     llama3.2-3b at full width (28 layers) on the card, exactly 28 B5
     launches per prefill, every request finished, finite logits, and
     EngineStats equal to the same Engine run at smoke size on the CPU
     (the reference's zero-token prompts make the schedule independent of
     the model's numbers); the run's wall time (no sync added inside it),
     then a decode step and a 512-token prefill each timed alone, back to
     back, and profiled for the device's busy time; then the same checks
     on a second workload (mean gen 32, max_len 768) on which the KF must
     boost and switch at least once, with its wall and its boosted and
     switch counts;
  [B6] the selective-scan kernel (mamba_scan) against its plain version
     `scan_ref`, bitwise, at the JAX kernel test's four shapes and at the
     forward shape (1, 2048, 8192, 16), timed there beside its bytes bound;
  [B7] the fused scan kernel (mamba_fused) against its plain version within
     1e-5 (abs + rel), at the JAX test's two shapes in f32, at
     (1, L, 8192, 16) with bf16 xc/B/C and a nonzero h0 for L = 48, 517,
     2048, and at zamba2's S = 64: (1, 517, 5120, 64) in bf16 and f32, from
     h0 and from zero, (1, 2048, 5120, 64) bf16, a ragged D = 5001 and an
     unaligned base (the element copies), with how many are bitwise; its
     instantiation (states per thread, steps in flight, threads per block,
     steps per tile); timed at each model shape with CUDA events per call
     and with torch.profiler's device time per launch, beside its bound
     (at S = 64 also beside the mamba2 scan's own bound, which has one
     exponential a head, not one a state);
  [fwd-m] falcon-mamba-7b at full width, depth cut to 8 of its 64
     layers (to keep the script inside its time limit; random weights
     from the seed), B = 1, L = 2048: lm.forward with use_kernel
     (exactly 8 B6 launches) and without (exactly 8 B7 launches), logits
     of the two within relative L2 1e-2, and the wall of each;
  [serve-mw] falcon-mamba-7b at full width cut to 2 layers: forward +
     prefill of a 300-token prompt and 2 decode steps on the card (B7)
     against the same parameters on the CPU (plain), relative L2 <= 1e-2
     on the logits, SSM states and conv rings;
  [serve-m] the [serve] runs on that 8-layer falcon-mamba-7b: exactly 8
     B7 launches per prefill (256 a workload), EngineStats equal to a CPU
     smoke run, the wall, a decode step and a 512-token prefill timed
     alone, and the second workload's boosts and switches;
  [fwd-z] zamba2-2.7b at full width, depth cut to 12 of its 54 layers
     (12 mamba2 layers in 2 super-blocks of 6, the shared attention block
     after each; to keep the script inside its time limit; random weights
     from the seed), B = 1, L = 2048: lm.forward with exactly 12 B7 and 2
     B5 launches, its wall, tokens/s and the device's busy share;
  [serve-zw] zamba2-2.7b at full width cut to 6 layers (one super-block
     and one application of the shared block): forward + prefill of a
     300-token prompt and 2 decode steps on the card (B7, B5) against the
     same parameters on the CPU (plain), relative L2 <= 1e-2 on the logits,
     every mamba2 SSM state and conv ring and the shared block's K/V; where
     the card misses 1e-2, the distance after each block is printed beside
     the CPU's own drift between its bf16 GEMMs and its f32 ones (the
     witness), and the bound is max(1e-2, 1.5 x the witness);
  [serve-z] the [serve] runs on that 12-layer zamba2-2.7b: exactly 12 B7
     and 2 B5 launches per prefill, EngineStats equal to a CPU smoke run, the
     wall, a decode step and a 512-token prefill timed alone;
  [fwd-g] grok-1-314b at full width (d_model 6144, 48/8 heads, logit cap
     30, 8 experts of d_ff 32768, top-2), depth cut to 2 of its 64 layers
     (~22 GB of bf16 weights; random weights from the seed), B = 1, L =
     2048 (one dispatch group, capacity 640): lm.forward with exactly 2 B5
     launches, finite logits, the expert load summing to k = 2, lb and zl
     finite, TF32 off for the router's f32 product; the wall, tokens/s and
     the device's busy share;
  [serve-gw] that model's first layer (13.1 GB): forward + prefill of a
     300-token prompt and 2 decode steps on the card (B5) against the same
     parameters on the CPU (plain), relative L2 <= 1e-2 on the logits and
     K/V, and every MoE call's routes compared: the expert choices equal,
     or each differing one a near-tie (the CPU's probability margin within
     twice the router drift of the witness, the CPU's bf16 GEMMs against
     its f32 ones), and the capacity positions equal except those the
     differing choices move; where a choice differs or the logits miss
     1e-2 the witness runs, and the bound is max(1e-2, 1.5 x its worst
     field); the host's free memory before the CPU copy;
  [serve-g] the [serve] runs on the 4-layer grok-1: exactly 4 B5 launches
     per prefill, EngineStats equal to a CPU smoke run, the wall, a decode
     step and a 512-token prefill timed alone;
  [fwd-l], [serve-lw], [serve-l] the same three for llama4-maverick-400b-
     a17b at full width (d_model 5120, 40/8 heads, 128 experts of d_ff
     8192, top-1, a shared expert, MoE every second layer), depth cut to
     one super-block (2 layers, a dense and a MoE one; 37.1 GB): 2 B5
     launches per forward or prefill; [serve-lw] on the whole 2-layer
     model;
  [B5b] the flash backward kernels (flash_attn_bwd: delta, then dK/dV and
     dQ, on wgmma fed by TMA in bf16 and SIMT in f32, one call; the
     log-sum-exp from B5's forward) against flash_attention_plain_bwd
     at llama3.2-3b's shape (S = 48, 512, 2048, and B = 4 at S = 2048),
     h2o-danube's window (S = 6144, window 4096), grok-1's cap (S = 512),
     zamba2's D = 80 and maverick's groups of 5, seamless-m4t's training
     shapes (4, 1536, 16, 64) with no mask (its encoder) and (4, 2048, 16,
     64) causal (its decoder), bf16 and f32 (bf16 alone at B = 4): relative L2
     of dq, dk and dv <= 1e-5 (f32) and <= 1e-2 (bf16), two launches
     bitwise equal; at each shape B5's lse within 1e-5 + 1e-5 rel of
     flash_attention_plain(return_lse=True) and B5's O bitwise the same
     with lse asked for and without; timed at the training shapes
     (llama's (4, 2048, 24, 128) and seamless's two) bf16 on
     events and device time (and each of the three kernels' device time)
     beside its bound (10 D flops a valid pair at 989 TFLOP/s), the plain
     version and torch's own flash backward
     (aten._scaled_dot_product_flash_attention_backward, timing only); B5's
     forward there with lse and without, beside SDPA;
  [train-w] llama3.2-3b at full width cut to 2 layers, B = 1, S = 256, one
     batch of make_dataset: the loss (1e-2 relative) and every gradient
     leaf (relative L2 1e-2, or where a leaf misses, max(1e-2, 1.5 x the
     CPU's own bf16-against-f32 GEMM witness for it)), card (B5, B5-bwd)
     against CPU (plain);
  [train] llama3.2-3b at full width and all 28 layers, remat "full", B =
     4, S = 2048: one step of each variant from the same state and batch
     (losses and the first leaf within 2e-2; 56 B5 and 28 B5-bwd launches
     a balanced step, twice that a comm-priority step), then loop.run on
     the launcher's KF scheduler for 10 steps (finite losses, the mean of
     the last two below the first, exact launch counts), the wall per
     step, tokens/s, a step alone profiled for the device's busy share,
     the peak memory; then launch.train.main(["--arch", "llama3.2-3b",
     "--size", "full", "--steps", "2"]) in-process on its defaults (the
     serving twins' CPU work runs beside all of it: its walls and idle
     share are measured with that host load);
  [train-s] the smoke config as the launcher takes it on the card
     (`launch.train.smoke_config`: heads widened to 64, which B5 takes)
     through loop.run with a checkpoint every 4 steps and a
     SimulatedFailure at step 6: the restore writes into the template's
     own tensors, the restored state bitwise the state a 4-step run holds
     (bf16 as uint16 bits, no ml_dtypes needed), the losses after the
     restore and the final state bitwise the uninterrupted run's; then
     `python -m repro_torch.launch.train` on all its defaults (the smoke
     config, 100 steps), in-process through main([]);
  [B7b] the fused scan's backward in its two forms (the walk back from
     B7's tile checkpoints, then the fixed-order sums): the per-channel
     form (mamba_fused_bwd) against fused_mamba_scan_plain_bwd at
     falcon-mamba's training shape (4, 2048, 8192, 16) bf16, zamba2's
     channels (4, 2048, 5120, 64) bf16 from a nonzero h0 and g_hlast, a
     ragged L = 517 and an f32 case at S = 8, and the mamba2 form
     (mamba_ssd_bwd) against fused_ssd_scan_plain_bwd at zamba2's shape
     (80 heads of 64) on that case's xc, B, C, A, h0 and g_hlast with a
     dt of its own, one a head (the per-channel case has one a channel):
     each of the six gradients within relative L2 1e-5 where returned in
     f32 and 1e-2 where returned in bf16, two calls bitwise equal, B7's y
     and h_last bitwise the same with the checkpoints written and without;
     timed at the training shapes (events, device; both forms at zamba2's)
     beside their bounds and the plain versions, with B7's forward with and
     without checkpoints, and the walk's registers and blocks an SM (the
     CUDA runtime's); [B7b] and [B6b] are timed with no host work beside;
  [B6b] the selective scan's backward (mamba_scan_bwd) bitwise against
     scan_ref_bwd at (2, 64, 32, 8) and (1, 2048, 8192, 16), timed there
     beside its bytes bound and the plain version;
  [train-mw] falcon-mamba-7b at full width cut to 2 layers, B = 1, S = 256,
     and [train-zw] zamba2-2.7b's one super-block (6 mamba2 layers and the
     shared block), B = 1, S = 128: the loss and every gradient leaf card
     (B7, B7-bwd; B5, B5-bwd) against CPU by [train-w]'s rule, a leaf that
     misses its own witness bound held to its kin's largest witness (the
     same parameter in the other layers); exact launch counts;
  [train-m] falcon-mamba-7b at full width cut to 16 of 64 layers and
     [train-z] zamba2-2.7b at full width and all 54 layers, remat "full",
     B = 4, S = 2048, the launcher's lr and warmup: one step of each
     variant from the same state and batch (as [train]), then loop.run
     for 4 steps from the initial state (finite losses, the last below
     the first, exact B7 / B7-bwd / B5 / B5-bwd counts), the wall per
     step, tokens/s, a step alone profiled for the busy share, the peak
     memory; then for falcon-mamba one balanced step with use_kernel=True
     at B = 1 through B6 and B6-bwd;
  [fwd-e] seamless-m4t-large-v2 whole (24 + 24 layers, 2.0 B parameters,
     random weights from the seed): encdec.encode of 1536 frames of 160 at
     B = 1 and B = 8 (exactly 24 B5 launches each, no mask) and
     encdec.forward at B = 1, S = 2048 (exactly 48: the cross-attention is
     plain, as the reference computes it), finite outputs; each one's
     wall, tokens/s and busy share;
  [serve-e] init_encdec_state for 8 utterances (24 B5 launches), max_len
     256, then 16 greedy decode steps (no B5 launch), every logit finite;
     a decode step timed alone and profiled, the cross K/V's size;
  [fwd-v] internvl2-2b whole (24 layers): lm.forward at B = 1, L = 2048
     with 256 projected patches of 1024 spliced in (exactly 24 B5
     launches, the prefix moving the logits), wall, tokens/s, busy share;
  [serve-v] prefill_caches(..., embeds=...) of 8 prompts of 256 patches +
     256 tokens (24 B5 launches), then 32 greedy decode steps (no B5);
     a prefill and a decode step timed alone and profiled;
  [serve-ew], [serve-vw] seamless at full width cut to 2 + 2 layers
     (encoder output, cross K/V, the logits and self K/V of 2 decode
     steps) and internvl2 cut to 2 layers (forward + prefill of 300
     tokens with the patches, 2 decode steps): card (B5) against CPU
     (plain), relative L2 1e-2, or where the card misses, max(1e-2, 1.5 x
     the CPU's bf16-against-f32 GEMM witness); their card sides and
     [train-ew]'s run first, right after [train-z], and their CPU sides on
     a worker thread, after the SSM twins' tail, beside [train-e] and the
     forward and serving phases above;
  [train-ew] seamless's gradients at full width, 2 + 2 layers, B = 1,
     S = 256, F = 1536, the batch's mask set to all ones (the synthetic
     mask zeroes the first 1536 decoder positions), card (B5, B5-bwd)
     against CPU by [train-mw]'s rule;
  [train-e] seamless whole, remat "full", B = 4, S = 2048 decoder tokens,
     F = 1536 frames, the launcher's lr and warmup: one balanced step
     (exactly 96 B5 and 48 B5-bwd launches), then loop.run for 3 steps
     from its state (finite losses, exact launch counts), each step's
     wall, a step alone profiled, the peak memory, and batch 0's loss on
     the trained state below its loss at init;
  6. a JSON line {"kernels": [...]}: per kernel its launches on its path,
     max abs error against the plain version, median ms per launch (B1:
     per call of arbitrate_lanes, as the "arb" engine calls it), the plain
     version's ms, the bound in ms and what bounds it, and the time of one
     PyTorch call computing the same function where there is one.

The last two lines are the nvidia-smi name/power line and
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# published H100 SXM figures (NVIDIA H100 datasheet, Hopper whitepaper):
# HBM bytes/s, and the int32 issue rate that bounds the kernels' integer
# ops: 132 SMs x 64 INT32 lanes per SM per clock x 1.98 GHz boost clock
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 132 * 64 * 1.98e9
# dense peaks (NVIDIA H100 SXM datasheet): bf16 tensor cores, f32 outside
# the tensor cores
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12
# exponentials through the special-function units: 132 SMs x 16 MUFU
# lanes per SM per clock x 1.98 GHz
PEAK_EXP_S = 132 * 16 * 1.98e9
SEED = 0
# the serving paths' depths, cut to keep the script inside its time limit:
# falcon-mamba-7b 8 of 64 layers, zamba2-2.7b 12 of 54 (2 super-blocks)
SERVE_M_LAYERS, SERVE_Z_LAYERS = 8, 12
# phase 4's epochs of 500 cycles (3, where 6 had its "arb" and "ref"
# engines take 137-218 s of a run near its time limit)
CONG_EPOCHS = 3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Median over 5 repeats of the mean ms per call of ``fn`` over ``n``
    back-to-back calls, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    reps = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        reps.append(a.elapsed_time(b) / n)
    return statistics.median(reps)


def profile_device(fn, n: int, attempts: int = 3, whole: bool = False):
    """``fn`` run n times under torch.profiler, ending in a sync: the host
    wall ms per call under the profiler, the device's busy ms per call (the
    summed durations of the kernels, copies and sets it records on the
    card), the top device ops and the top host ops by self time, each as
    (name, ms per call), and a note of the launches recorded.  The card's
    tracing has been seen to drop a whole session's device records, or
    some of them: a session that records nothing on the card is profiled
    again, up to ``attempts`` times, and so is one that records fewer
    device kernels than the host made launch calls where ``whole`` is
    asked for (a kernel's own time, where a dropped launch would read as a
    faster kernel).  If no session is good enough the device side is not
    measured: busy 0 and no top device ops, and the caller prints "not
    measured".  Otherwise the note is empty for a whole session and names
    the share recorded for a partial one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3 / n
        launches, kernels, records = launch_records(prof.events())
        complete = kernels >= launches
        good = bool(records) and (complete or not whole)
        if good:
            break
    device, host = {}, {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if good and e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) + us
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            host[e.key] = e.self_cpu_time_total

    def top(d):
        return [(k[:48], v / 1e3 / n)
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:5]]

    note = ("" if not good or complete else
            f" ({kernels} of {launches} launches recorded)")
    return wall, sum(device.values()) / 1e3 / n, top(device), top(host), note


def launch_records(events):
    """The kernel launch calls the host made in a profiled session
    (cudaLaunchKernel, cuLaunchKernelEx and the like, on the CPU side), how
    many device kernels it recorded (its copies and sets left out), and
    every device record, as (name, ms) pairs."""
    from torch.autograd import DeviceType

    launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and "LaunchKernel" in e.name)
    records = [(e.name, e.time_range.elapsed_us() / 1e3) for e in events
               if e.device_type == DeviceType.CUDA]
    kernels = sum(1 for name, _ in records
                  if not name.startswith(("Memcpy", "Memset")))
    return launches, kernels, records


def fmt_ms(ms: float) -> str:
    """A profiled device time, or "not measured" where the profiler
    recorded no device activity."""
    return f"{ms:.4f} ms" if ms > 0 else "not measured"


def fmt_top(pairs) -> str:
    return "; ".join(f"{k} {v:.4f}" for k, v in pairs)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fault_stream(topo, n_epochs: int, telem_at: int = 4):
    """A fault stream built in the port with every mask kind live: the link
    from router 14 to its east neighbour down in even epochs, router 21
    browned out in epochs 1-2, the first MC stalled in epochs 1-3, and the
    telemetry NaN in epoch ``telem_at`` and spiked in the next."""
    from repro_torch.core.noc.faults import TELEM_NAN, TELEM_SPIKE, healthy_stream
    from repro_torch.core.noc.topology import OPPOSITE, PORT_E

    f = healthy_stream(n_epochs, topo.n_routers)
    r, nb = 14, int(topo.neighbor[14, PORT_E])
    link = f.link_ok.clone()
    link[0::2, r, PORT_E] = False
    link[0::2, nb, int(OPPOSITE[PORT_E])] = False
    router = f.router_ok.clone()
    router[1:3, 21] = False
    mc = f.mc_ok.clone()
    mc[1:4, int(topo.mc_ids[0])] = False
    mode = f.telem_mode.clone()
    mode[telem_at], mode[telem_at + 1] = TELEM_NAN, TELEM_SPIKE
    mag = f.telem_mag.clone()
    mag[telem_at + 1] = 0.5
    return f._replace(link_ok=link, router_ok=router, mc_ok=mc,
                      telem_mode=mode, telem_mag=mag)


def placement_stream(topo, n_epochs: int):
    """A placement stream built in the port that moves tiles whatever the
    controller does: CPU and GPU tiles swap places in the base plan from
    the middle epoch on, and in the boosted plan before it."""
    import torch

    from repro_torch.core.noc.placement import PlacementStream

    base = torch.as_tensor(topo.node_type, dtype=torch.int32)
    swap = torch.where(base == 2, base, 1 - base)
    late = (torch.arange(n_epochs) >= n_epochs // 2)[:, None]
    return PlacementStream(cls0=torch.where(late, swap, base),
                           cls1=torch.where(late, base, swap))


def arb_inputs(d, st, xi_c, consts):
    """The 11 lane rows B1 takes at one cycle of a lane state."""
    import torch

    from repro_torch.kernels.noc_cycle import fused as F

    gm, cm, _, pol_sr, pol_r, ntype, route, exists = consts
    _, _, valid, cls_h, out_port, down = F.head_rows(
        d, st.buf_meta, st.buf_binj, st.head, st.count, route
    )
    can_accept = torch.where(
        ntype == F.NT_MC,
        st.mc[F.MC_COUNT:F.MC_COUNT + 1] <= d.Q - pol_r[F.PR_NREQ:F.PR_NREQ + 1],
        True,
    )
    accept = torch.where(pol_sr[F.PS_IS_REQ:F.PS_IS_REQ + 1] != 0,
                         can_accept[:, :F.R_PAD].repeat(1, d.S), True)
    i32 = torch.int32
    return (valid.to(i32), cls_h, out_port, st.rr, down, exists, gm, cm,
            xi_c[F.XI_SA:F.XI_SA + 1].contiguous(), accept.to(i32),
            xi_c[F.XI_ACTIVE:F.XI_ACTIVE + 1].contiguous())


def plain_arbitrate(ins, depth):
    from repro_torch.kernels.noc_cycle import fused

    v, c, o, rr, dn, ex, gm, cm, sa, acc, act = ins
    return fused.lane_arbitrate(v != 0, c, o, rr, dn, ex != 0, gm != 0,
                                cm != 0, sa, acc != 0, act != 0, depth=depth)


def dense_operands(seed, dev):
    """The 11 operands `router.router_cycle` hands its arbitration function
    for one cycle of a seeded random dense state on the card (bool and
    int32 tensors, broadcast views among them), and the depth."""
    import torch

    from repro_torch.core.noc import router as rt
    from repro_torch.core.noc.topology import make_topology

    g = torch.Generator(device=dev).manual_seed(seed)
    S, R, P, V, B = 4, 36, 5, 4, 4

    def ri(hi, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    shape = (S, R, P, V)
    meta = ri(R, shape + (B,)) + (ri(R, shape + (B,)) << 6) \
        + (ri(2, shape + (B,)) << 12)
    state = rt.SubnetState(
        buf_meta=meta.to(torch.int16), buf_binj=ri(5000, shape + (B,)),
        head=ri(B, shape, torch.int8), count=ri(B + 1, shape, torch.int8),
        rr_ptr=ri(P * V, (S, R, P), torch.int8))
    seen = []

    def record(*args, depth):
        seen.append((args, depth))
        return rt.arbitrate(*args, depth=depth)

    rt.router_cycle(
        state, *rt.device_tables(make_topology(), dev)[:3],
        ri(2, (S, V)) != 0, ri(2, (S, V)) != 0,
        torch.tensor(seed % 3 - 1, dtype=torch.int32, device=dev),
        ri(5, (S, R)) != 0,
        torch.tensor([True, True, seed % 2 == 0, True], device=dev),
        arbitrate_fn=record, link_ok=ri(10, (R, P)) != 0,
        router_ok=ri(10, (R,)) != 0)
    (args, depth), = seen
    return args, depth


def recast(args):
    """The same operand values as other element types and strides the
    kernel reads in place: uint8 / int8 / int64 elements, a transposed
    down_count, an expanded mask, sa_pref as a 0-d tensor."""
    import torch

    va, cl, op, rr, dn, ex, gm, cm, sa, acc, act = args
    S, R = va.shape[:2]
    return (va.to(torch.uint8), cl.to(torch.int8), op.to(torch.int64),
            rr.to(torch.int8),
            dn.to(torch.int8).transpose(0, 1).contiguous().transpose(0, 1),
            ex.to(torch.int8), gm.expand(S, R, gm.shape[-1]), cm, sa[0, 0],
            acc.to(torch.uint8), act)


def device_launches(fn, n: int, attempts: int = 3):
    """``n`` calls of ``fn`` under torch.profiler, ending in a sync: the
    kernel launches the host made and the device records (kernels, copies,
    sets) it recorded, as (name, ms) pairs (`launch_records`).  The card's
    tracing can drop device records (seen in long runs; the host's launch
    calls are all there): a session that records fewer kernels than
    launches is run again, up to ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        launches, kernels, records = launch_records(prof.events())
        if kernels >= launches:
            break
    return launches, records


def one_kernel_each(fn, n: int, kernel: str, what: str) -> float:
    """Fail unless ``n`` calls of ``fn`` make exactly ``n`` kernel launches
    and every device kernel recorded is ``kernel``; returns the mean device
    ms of the recorded launches, or 0 (not measured) where the tracing
    dropped every device record of every session: the launch count, taken
    on the host, is then the whole check, and a line says so."""
    launches, kernels = device_launches(fn, n)
    names = sorted({k for k, _ in kernels})
    check(launches == n and all(kernel in k for k in names),
          f"{what}: {n} calls launched {launches} kernels (recorded "
          f"{len(kernels)}: {names}), expected one {kernel} each")
    if not kernels:
        print(f"[profiler] {what}: {n} calls made {n} launches; the tracing "
              f"recorded no device kernel, so their names and device time "
              f"are not measured")
        return 0.0
    return statistics.mean(ms for _, ms in kernels)


def max_diff(a, b) -> int:
    """Max abs difference over the paired tensors of two NamedTuples."""
    import torch

    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in zip(a, b))


def b1_ops(lanes, V=4):
    """An op count of the arbitration body over ``lanes`` lanes (per lane:
    per output a PV-wide masked packed-min of ~8 ops per requester plus a
    V-wide credit pick of ~6 ops per VC; the grant filter ~3*P*P; the
    dequeue one-hot 2*PV*P)."""
    P, PV = 5, 5 * V
    return lanes * (P * (8 * PV + 6 * V + 10) + 3 * P * P + 2 * PV * P)


def b1_bound(ins, outs):
    """Least time of one B1 launch on these operands: each distinct input
    element read once (a broadcast view's repeats are one element), each
    output written once, at their element sizes; and `b1_ops`."""
    def distinct(x):
        n = 1
        for size, st in zip(x.shape, x.stride()):
            n *= size if st != 0 else 1
        return n

    nbytes = (sum(distinct(x) * x.element_size() for x in ins)
              + sum(x.numel() * x.element_size() for x in outs))
    lanes = ins[0].numel() // ins[0].shape[-1]
    return bound_ms(nbytes, b1_ops(lanes))


def b2_bound(d, n_cycles):
    """Least time of one B2 launch of n_cycles: the lane state read and
    written once, the cycles' xs and the epoch rows read once, and per lane
    per cycle the arbitration body plus the peek / pull / inject / MC /
    counter stages (~8*PV + 6*P*V + 6*V + 60 ops)."""
    L, LR, P, V, PV = d.lanes_sr, 128, 5, d.V, d.PV
    state = (2 * PV * d.B + 2 * PV + P) * L * 4 + (d.Q + 6 + 3 + 1) * LR * 4
    xs = n_cycles * (6 * L + 2 * LR) * 4
    consts = (2 * V + 4 + P + d.R) * L * 4 + (5 + 2 + 1) * LR * 4
    nbytes = 2 * state + xs + consts
    ops = n_cycles * (b1_ops(L, V) + L * (8 * PV + 6 * P * V + 6 * V + 60))
    return nbytes, ops


def b3_bound(d, n_cycles):
    """B2's bound plus the flight-recorder carry: the three probe arrays
    read and written once, and per lane per cycle PV occupancy adds, ~3*P
    ops for the grant/refusal sums and 2 for the MC-queue sum and max."""
    nbytes, ops = b2_bound(d, n_cycles)
    probe = (d.PV * d.lanes_sr + 2 * d.lanes_sr + 2 * 128) * 4
    return (nbytes + 2 * probe,
            ops + n_cycles * d.lanes_sr * (d.PV + 3 * 5 + 2))


def ptxas_usage(log: str) -> dict:
    """Registers, stack and spill bytes per kernel from ptxas -v output."""
    labels = (("noc_arbitrate_kernel", "B1"),
              ("noc_fused_cycles_kernelILi4ELi4ELi4ELb0ELb0E", "B2"),
              ("noc_fused_cycles_kernelILi4ELi4ELi4ELb1ELb0E", "B3"),
              ("noc_fused_cycles_kernelILi4ELi4ELi4ELb0ELb1E", "B2 clocked"),
              ("kf_bank_kernel", "B4"),
              ("mamba_scan_kernel", "B6"),
              ("mamba_scan_bwd_kernel", "B6b"),
              *((f"mamba_fused_bwd_kernelI{t}Li{n}ELb{m}ELb{w}E",
                 f"B7b {tn} S{n}{mn}{wn}")
                for t, tn in (("f", "f32"), ("13__nv_bfloat16", "bf16"))
                for n in (8, 16, 64) for m, mn in ((0, ""), (1, " ssd"))
                for w, wn in ((1, ""), (0, " narrow"))),
              ("ssd_heads_kernel", "B7b heads"),
              *((f"reduce_parts_kernelI{t}E", f"B7b sums {tn}")
                for t, tn in (("f", "f32"), ("13__nv_bfloat16", "bf16"))),
              *((f"mamba_fused_kernelI{t}Li{n}ELb{w}E", f"B7 {tn} S{n}{wn}")
                for t, tn in (("f", "f32"), ("13__nv_bfloat16", "bf16"))
                for n in (8, 16, 64) for w, wn in ((1, ""), (0, " narrow"))),
              *((f"flash_fwd_{k}kernelILi{d}E", f"B5 {n} D{d}")
                for d in (64, 80, 128)
                for k, n in (("sm90_", "bf16"), ("", "f32"))),
              *((f"bwd_{part}_kernelIfLi{d}E", f"B5b {part} f32 D{d}")
                for part in ("dkdv", "dq") for d in (64, 80, 128)),
              *((f"bwd_{part}_sm90_kernelILi{d}E", f"B5b {part} bf16 D{d}")
                for part in ("dkdv", "dq") for d in (64, 80, 128)),
              *((f"bwd_delta_kernelI{t}E", f"B5b delta {tn}")
                for t, tn in (("f", "f32"), ("13__nv_bfloat16", "bf16"))))
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$.]+)", line)
        if m:
            cur = next((b for a, b in labels if a in m.group(1)), None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def same(a, b) -> bool:
    """Bitwise equality that counts NaN == NaN (the KF channels of a NaN-
    telemetry epoch)."""
    import torch

    if a.dtype.is_floating_point:
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])
    return torch.equal(a, b)


def results_equal(a, b) -> str | None:
    """The first SimResult field (or counter) where a and b differ."""
    from repro_torch.core.noc import sim

    for f in ("gpu_ipc", "cpu_ipc", "avg_latency", "kf_signal",
              "applied_config", "gpu_inj_rate", "gpu_vc_quota"):
        if not same(getattr(a, f), getattr(b, f)):
            return f
    for f, x, y in zip(sim.EpochCounters._fields, a.counters, b.counters):
        if not same(x, y):
            return f"counter {f}"
    return None


def random_probe(d, gen):
    """A non-zero ProbeLanes carry on the card: random counts on the real
    router lanes, 0 on the padded ones (which never accumulate)."""
    import torch

    from repro_torch.kernels.noc_cycle import fused

    dev = gen.device
    lane = torch.arange(d.lanes_sr, device=dev) % fused.R_PAD < d.R
    node = torch.arange(fused.LANES_R, device=dev) < d.R

    def ri(hi, rows, mask):
        x = torch.randint(0, hi, (rows, mask.numel()), generator=gen,
                          device=dev, dtype=torch.int32)
        return x * mask.to(torch.int32)

    return fused.ProbeLanes(occ=ri(2000, d.PV, lane), arb=ri(1000, 2, lane),
                            mcq=ri(16, 2, node))


def bound_ms(nbytes, ops, ops_per_s=PEAK_INT32_OPS_S):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kf_bank_bound(n, m):
    """Least time of one B4 launch: x, p and z read once, x and p written
    once (float32); per filter 2 + 4M + 6 flops at the f32 rate."""
    return bound_ms((2 + m + 2) * 4 * n, (4 * m + 8) * n, PEAK_F32_FLOP_S)


def flash_bound(b, h, kv, sq, sk, d, causal, window, kv_len, dtype):
    """Least time of one B5 launch on these inputs: q, k and v read once
    and o written once; 4*D flops (QK^T and PV) per (q, k) pair that this
    call's masks leave valid, at the peak rate of the input type (bf16
    tensor cores; f32 outside them)."""
    import numpy as np
    import torch

    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    valid = np.broadcast_to(kp < min(sk if kv_len is None else kv_len, sk),
                            (sq, sk))
    if causal:
        valid = valid & (qp >= kp)
    if window is not None:
        valid = valid & (qp - kp < window)
    pairs = int(valid.sum())
    elem = 2 if dtype == torch.bfloat16 else 4
    nbytes = (2 * b * sq * h * d + 2 * b * sk * kv * d) * elem
    rate = PEAK_BF16_FLOP_S if dtype == torch.bfloat16 else PEAK_F32_FLOP_S
    return bound_ms(nbytes, 4 * d * h * b * pairs, rate), pairs


def rel_l2(a, b) -> float:
    import torch

    a, b = a.to(torch.float64).cpu(), b.to(torch.float64).cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


# the JAX package's committed predictor-ablation row (read-only) and the
# kf cell of its gate scenario under jax 0.9.0's default threefry setting
# (the JAX package's sweep on the CPU reads it); both within ABL_TOL
ABLATION_BENCH = "noc_ablation"
ABL_KF_PARTITIONABLE = 0.735548
ABL_TOL = 2e-6
# cycles of B2 at batch 60 held against its plain version in [sweep] (d)
# (100, where 200 had the plain side take 93-135 s of a run near its time
# limit; the 1-cycle checks from zero and from 500 cycles in stay)
B60_PLAIN_CYCLES = 100


def phase_sweep(dev) -> dict:
    """[sweep] the paper sweep through simulate_batch / sweep on B2: (a) 8
    rows {baseline, fair, kf, 4subnet} x seeds {0, 1} at the full grid in
    one simulate_batch, exactly 120 B2 launches, each row bitwise its
    standalone simulate; (b) the 60-row predictor ablation (4 scenarios x 5
    predictors x 3 seeds, 120 epochs) in one sweep with threefry's original
    scheme, its 20 gpu_ipc cells against BENCH_noc.json's committed row and
    its gate; (c) the gate scenario under the default (partitionable)
    scheme, its kf cell against the reference's reading; (d) B2 per launch
    at batch 60 beside batch 1 (turns 1, 60, 60, 1) and the time to draw
    one paper run's streams; and B2 at batch 60 held bitwise against its
    plain version.  Returns B2's launches on these paths, its max abs error
    at batch 60 and the timings."""
    import torch

    from benchmarks import torch_fig_ablation as abl
    from repro_torch._util import tree_map
    from repro_torch.core import threefry
    from repro_torch.core.noc import sim
    from repro_torch.kernels.noc_cycle import fused, kernel, ops

    out = {}
    # (a) batch == standalone, bitwise, one launch an epoch for 8 rows
    rows = [(m, s) for m in ("baseline", "fair", "kf", "4subnet")
            for s in (0, 1)]
    cfgs = [sim.NoCConfig(mode=m, seed=s) for m, s in rows]
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    batch = sim.simulate_batch(cfgs, "SHIFT_PATH_BFS")
    torch.cuda.synchronize()
    wall_a = time.time() - t0
    n_a = ops.LAUNCHES["noc_fused_cycles"]
    check(n_a == cfgs[0].n_epochs and ops.LAUNCHES["noc_arbitrate"] == 0
          and ops.LAUNCHES["noc_fused_cycles_probed"] == 0,
          f"simulate_batch of 8 rows launched {ops.LAUNCHES}, expected "
          f"{cfgs[0].n_epochs} of B2")
    t0 = time.time()
    for b, cfg in enumerate(cfgs):
        alone = sim.simulate(cfg, "SHIFT_PATH_BFS")
        diff = results_equal(tree_map(lambda x: x[b], batch), alone)
        check(diff is None, f"simulate_batch row {rows[b]} differs from its "
                            f"standalone simulate at {diff}")
    wall_alone = time.time() - t0
    print(f"[sweep] (a) simulate_batch of {len(cfgs)} rows {rows} on "
          f"SHIFT_PATH_BFS, 120x500: {n_a} B2 launches, wall {wall_a:.2f} s; "
          f"every row bitwise its standalone simulate in every SimResult "
          f"field (8 standalone runs {wall_alone:.2f} s)")
    sys.stdout.flush()

    # (b) the ablation grid, original scheme, against the committed row
    with open(os.path.join(HERE, "BENCH_noc.json")) as f:
        bench = [r for r in json.load(f) if r.get("bench") == ABLATION_BENCH]
    check(len(bench) == 1, f"BENCH_noc.json holds {len(bench)} "
                           f"{ABLATION_BENCH} rows, expected 1")
    want = bench[0]["gpu_ipc"]
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    with threefry.threefry_partitionable(False):
        res = abl.run()
    torch.cuda.synchronize()
    wall_b = time.time() - t0
    n_b = ops.LAUNCHES["noc_fused_cycles"]
    check(n_b == 120 and res["rows"] == 60,
          f"the ablation sweep launched B2 {n_b} times for {res['rows']} rows,"
          f" expected 120 for 60")
    worst = 0.0
    for sc, cells in want.items():
        for p, v in cells.items():
            got = res["table"][sc][p]["gpu_ipc"]
            worst = max(worst, abs(got - v))
            check(abs(got - v) <= ABL_TOL,
                  f"ablation {sc}/{p}: gpu_ipc {got:.7f}, BENCH_noc.json "
                  f"{v} (|diff| {abs(got - v):.2e} > {ABL_TOL})")
    verdict = abl.kf_verdict(res["table"])
    check(verdict["kf_beats_all"], f"ablation gate failed: {verdict}")
    cycles_b = res["rows"] * 120 * 500
    print(f"[sweep] (b) ablation {res['rows']} rows (4 scenarios x 5 "
          f"predictors x 3 seeds) x 120x500 in one sweep, threefry original "
          f"scheme: {n_b} B2 launches, wall {wall_b:.3f} s, "
          f"{cycles_b / wall_b:.0f} simulated cycles/s in aggregate; 20 of "
          f"20 gpu_ipc cells within {ABL_TOL} of BENCH_noc.json (max |diff| "
          f"{worst:.2e}); gate holds: {verdict}")
    sys.stdout.flush()

    # (c) the gate scenario under the default scheme
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    res_c = abl.run(scenarios=(abl.GATE_SCENARIO,))
    torch.cuda.synchronize()
    wall_c = time.time() - t0
    n_c = ops.LAUNCHES["noc_fused_cycles"]
    check(n_c == 120, f"the gate-scenario sweep launched B2 {n_c} times")
    kf_c = res_c["table"][abl.GATE_SCENARIO]["kf"]["gpu_ipc"]
    check(abs(kf_c - ABL_KF_PARTITIONABLE) <= ABL_TOL,
          f"{abl.GATE_SCENARIO}/kf under the partitionable scheme: gpu_ipc "
          f"{kf_c:.7f}, expected {ABL_KF_PARTITIONABLE} +- {ABL_TOL}")
    print(f"[sweep] (c) {abl.GATE_SCENARIO}/kf under the default "
          f"(partitionable) scheme: gpu_ipc {kf_c:.7f} (reference "
          f"{ABL_KF_PARTITIONABLE}); {res_c['rows']} rows, {n_c} B2 "
          f"launches, wall {wall_c:.3f} s")

    # (d) B2 at batch 60 beside batch 1, on the ablation's epoch-0 inputs
    # run 500 cycles in from zero state (turns 1, 60, 60, 1)
    specs = [(sc, p, s) for sc in abl.SCENARIO_SET for p in abl.PREDICTORS
             for s in abl.SEEDS]
    run = sim.batch_inputs(
        [sim.NoCConfig(mode="kf", seed=s, predictor=p, kf_q=abl.KF_Q_ABLATION)
         for _, p, s in specs], [sc for sc, _, _ in specs], device=dev)
    tables = sim.lane_tables(run)
    d = tables[0]
    ep = sim.epoch_inputs(run, 0, torch.zeros(len(specs), dtype=torch.int32),
                          0)
    xi, xf, consts = sim.lane_inputs(run, tables, ep)
    subs, mc, outst, backlog = sim.init_sim_state(run.stc, dev,
                                                  n_rows=len(specs))
    st60 = fused.pack_state(d, subs, mc, outst, backlog,
                            torch.zeros(len(specs), dtype=torch.int32,
                                        device=dev))

    # B2 against its plain version at batch 60, bitwise on every LaneState
    # field: 1 cycle from the zero state, then 1 and B60_PLAIN_CYCLES
    # cycles from the state 500 cycles in (the plain version walks the 60
    # rows one by one; these launches are not counted on the main path)
    out["b2_err"] = 0

    def b2_vs_plain(st, n, plain_from=None, first=0):
        k = ops.fused_cycle_step(d, st, xi[:, :n], xf[:, :n], *consts)
        p = fused.cycle_steps_lanes(
            d, st if plain_from is None else plain_from, xi[:, first:n],
            xf[:, first:n], *consts)
        err = max_diff(k, p)
        check(err == 0, f"B2 at batch {len(specs)} disagrees with {n} plain "
                        f"cycles (max abs err {err})")
        out["b2_err"] = max(out["b2_err"], err)
        return p

    t0 = time.time()
    b2_vs_plain(st60, 1)
    kernel.noc_fused_cycles(d, st60, xi, xf, *consts)      # fill
    p1 = b2_vs_plain(st60, 1)
    b2_vs_plain(st60, B60_PLAIN_CYCLES, plain_from=p1, first=1)
    print(f"[sweep] (d) B2 at batch {len(specs)} (the ablation's epoch-0 "
          f"inputs) bitwise equal to its plain version on every LaneState "
          f"field of every row: 1 cycle from the zero state, 1 and "
          f"{B60_PLAIN_CYCLES} cycles from the state 500 cycles in "
          f"({time.time() - t0:.1f} s)")
    sys.stdout.flush()
    x1, f1, c1 = sim.lane_row(xi, xf, consts, 0)
    st1 = type(st60)(*(x[0].clone() for x in st60))

    def t1():
        return cuda_ms(lambda: kernel.noc_fused_cycles(d, st1, x1, f1, *c1),
                       10)

    def t60():
        return cuda_ms(lambda: kernel.noc_fused_cycles(d, st60, xi, xf,
                                                       *consts), 10)

    turns = [t1(), t60(), t60(), t1()]
    out["b2_ms_b1"] = (turns[0] + turns[3]) / 2
    out["b2_ms_b60"] = (turns[1] + turns[2]) / 2
    # where a 60-row epoch goes: each step of sim's epoch loop timed alone
    # on these inputs (host wall per call, ending in a sync)
    from repro_torch.core import kalman, predictor
    from repro_torch.core.allocator import (apply_policy_gated,
                                            degrade_policy, init_policy_state)
    from repro_torch.core.noc import router as rt

    n60 = len(specs)
    dense = fused.unpack_state(d, st60, sim.MCState)
    ar = torch.arange(run.topo.n_routers, dtype=torch.int32, device=dev)
    want = torch.ones((n60, d.S, d.R), dtype=torch.bool, device=dev)
    pred0 = tree_map(lambda x: x.expand(n60, *x.shape).clone(),
                     predictor.init_state())
    pol0 = tree_map(lambda x: x.expand(n60).clone(), init_policy_state())
    kfp = kalman.paper_params(q=abl.KF_Q_ABLATION, r=run.stc.kf_r)
    z60 = torch.linspace(-1, 1, n60 * 3).reshape(n60, 3)

    def boundary():
        st60.cnt[:, 0, :fused.N_COUNTERS].cpu()
        ps, sig, _ = predictor.step_probed(run.mp.predictor, kfp, pred0, z60)
        pol = apply_policy_gated(run.stc.policy, run.mp, pol0, sig,
                                 torch.tensor(0, dtype=torch.int32))
        return degrade_policy(pol, ps.healthy)

    split = {
        "epoch_inputs": wall_ms(lambda: sim.epoch_inputs(
            run, 0, torch.zeros(n60, dtype=torch.int32), 0), 20),
        "prologue inject": wall_ms(lambda: rt.inject_all(
            dense[0], want, dense[1].stage_dst[:, None, :], ar,
            dense[1].stage_cls[:, None, :], ep.cycles[0], ep.gpu_masks,
            ep.cpu_masks), 20),
        "lane_inputs": wall_ms(lambda: sim.lane_inputs(run, tables, ep), 20),
        "pack_state": wall_ms(lambda: fused.pack_state(d, *dense), 20),
        "B2": out["b2_ms_b60"],
        "unpack_state": wall_ms(
            lambda: fused.unpack_state(d, st60, sim.MCState), 20),
        "counters to host + KF + policy": wall_ms(boundary, 20),
    }
    out["split_ms"] = split
    print(f"[sweep] (d) a 60-row epoch, each step alone (host wall ms per "
          f"call): " + "; ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; sum {sum(split.values()):.3f} against the sweep's "
          f"{wall_b * 1e3 / 120:.3f} per epoch")
    # the streams of one paper run (one seed, 120 epochs): one vectorized
    # draw on the card, and of the ablation's 3 seeds
    draws = {}
    for seeds in ((0,), abl.SEEDS):
        torch.cuda.synchronize()
        t0 = time.time()
        streams = sim.threefry_epoch_streams(seeds, 120, 500, 36, 8, dev)
        streams(0)
        torch.cuda.synchronize()
        draws[len(seeds)] = time.time() - t0
    out["draw_s"] = draws[1]
    print(f"[sweep] (d) B2 ms per 500-cycle launch in turns batch 1/60/60/1 "
          f"{' / '.join(f'{t:.4f}' for t in turns)}: batch 1 "
          f"{out['b2_ms_b1']:.4f}, batch 60 {out['b2_ms_b60']:.4f} "
          f"({out['b2_ms_b60'] / out['b2_ms_b1']:.3f}x for 60x the rows); "
          f"threefry stream draw of one paper run (120x500 cycles, 1 seed) "
          f"{draws[1] * 1e3:.1f} ms, of the ablation's 3 seeds "
          f"{draws[3] * 1e3:.1f} ms; ablation sweep wall {wall_b:.3f} s "
          f"({cycles_b / wall_b:.0f} simulated cycles/s)")
    sys.stdout.flush()
    out.update(launches=n_a + n_b + n_c, wall_b=wall_b)
    return out


# the JAX package's committed fault and placement rows (read-only), and
# one cell of each under jax 0.9.0's default threefry setting (the JAX
# package's sweep on the CPU reads them); all within ABL_TOL
FAULTS_BENCH, PLACEMENT_BENCH = "noc_faults", "noc_placement"
SCEN_PARTITIONABLE = {("faults", "TELEM_GLITCH", "kf_guarded"): 0.728684,
                      ("placement", "MIX_PATH_STO_BFS", "joint"): 0.735650}


def bench_row(name: str) -> dict:
    with open(os.path.join(HERE, "BENCH_noc.json")) as f:
        rows = [r for r in json.load(f) if r.get("bench") == name]
    check(len(rows) == 1, f"BENCH_noc.json holds {len(rows)} {name} rows, "
                          f"expected 1")
    return rows[0]


def check_cells(tag: str, table: dict, want: dict) -> float:
    """Every gpu_ipc cell of a committed row within ABL_TOL of ``table``;
    returns the largest |diff|."""
    worst = 0.0
    for row, cells in want.items():
        for arm, v in cells.items():
            got = table[row][arm]["gpu_ipc"]
            worst = max(worst, abs(got - v))
            check(abs(got - v) <= ABL_TOL,
                  f"{tag} {row}/{arm}: gpu_ipc {got:.7f}, BENCH_noc.json {v} "
                  f"(|diff| {abs(got - v):.2e} > {ABL_TOL})")
    return worst


def phase_scen(dev) -> dict:
    """[scen] the named fault and placement scenarios through sweep on B2:
    (a) the fault study (benchmarks/torch_fig_faults.py, 45 rows x 120
    epochs) and (b) the placement study (torch_fig_placement.py, 48 rows)
    under threefry's original scheme, each grid exactly 120 B2 launches,
    its 15 cells against BENCH_noc.json's committed row, its bitwise
    verdict, its probed runs' integer counters (B3) equal to the row's and
    its gate; (c) one cell of each under the default scheme against the
    reference's reading, and the Fig. 4 traces (torch_fig4_traffic.py).
    Returns B2's and B3's launches on these paths."""
    import numpy as np
    import torch

    from benchmarks import torch_fig4_traffic as fig4
    from benchmarks import torch_fig_faults as flt
    from benchmarks import torch_fig_placement as plc
    from repro_torch.core import threefry
    from repro_torch.kernels.noc_cycle import ops

    out = {"b2": 0, "b3": 0}

    def drive(tag, mod, rows, n_probed, **kw):
        ops.reset_launches()
        torch.cuda.synchronize()
        res = mod.run(device=dev, **kw)
        torch.cuda.synchronize()
        check(res["rows"] == rows, f"{tag}: {res['rows']} rows, expected "
                                   f"{rows}")
        check(res["b2_launches"] == 120 and res["b3_launches"] == 120 * n_probed
              and dict(ops.LAUNCHES) == {"noc_fused_cycles": 120,
                                         "noc_fused_cycles_probed":
                                         120 * n_probed, "noc_arbitrate": 0},
              f"{tag}: launches {ops.LAUNCHES}, expected 120 of B2 for the "
              f"grid and {120 * n_probed} of B3 for {n_probed} probed runs")
        out["b2"] += res["b2_launches"]
        out["b3"] += res["b3_launches"]
        return res

    def rate(res):
        return (f"sweep wall {res['sweep_s']:.3f} s, "
                f"{res['rows'] * 120 * 500 / res['sweep_s']:.0f} simulated "
                f"cycles/s in aggregate")

    # (a) the fault study against noc_faults
    row = bench_row(FAULTS_BENCH)
    with threefry.threefry_partitionable(False):
        res = drive("[scen] (a)", flt, 45, len(flt.FAULT_SET))
    worst = check_cells("[scen] (a)", res["table"], row["gpu_ipc"])
    check(res["healthy_bitwise"], "[scen] (a): healthy guard-on run differs "
                                  "from guard-off")
    check(res["probes"] == row["probes"],
          f"[scen] (a): probes {res['probes']} differ from BENCH_noc.json's "
          f"{row['probes']}")
    verdict = flt.guard_verdict(res["table"], flt.FAULT_SET)
    check(verdict["guard_beats_all"], f"[scen] (a) gate failed: {verdict}")
    print(f"[scen] (a) fault study, {res['rows']} rows (healthy + 4 scenarios "
          f"x 3 arms x 3 seeds) x 120x500 in one sweep, threefry original "
          f"scheme: 120 B2 launches, {rate(res)}; 15 of 15 gpu_ipc cells "
          f"within {ABL_TOL} of BENCH_noc.json (max |diff| {worst:.2e}); "
          f"healthy_bitwise; 4 probed guarded runs ({res['b3_launches']} B3 "
          f"launches, {res['probe_s']:.2f} s) equal to the row's probes "
          f"{res['probes']['TELEM_GLITCH']} (TELEM_GLITCH) and the rest; "
          f"guard_beats_all; margins {verdict['margins']}")
    sys.stdout.flush()

    # (b) the placement study against noc_placement
    row = bench_row(PLACEMENT_BENCH)
    with threefry.threefry_partitionable(False):
        res = drive("[scen] (b)", plc, 48, 1)
    worst = check_cells("[scen] (b)", res["table"], row["gpu_ipc"])
    check(res["identity_bitwise"], "[scen] (b): the identity pair differs")
    check(res["probes"] == row["probes"],
          f"[scen] (b): probes {res['probes']} differ from BENCH_noc.json's "
          f"{row['probes']}")
    verdict = plc.control_verdict(res["table"], plc.SCENARIOS)
    check(verdict["joint_beats_bandwidth"],
          f"[scen] (b) gate failed: {verdict}")
    print(f"[scen] (b) placement study, {res['rows']} rows (5 scenarios x 3 "
          f"controls x 3 seeds + the identity pair) x 120x500 in one sweep, "
          f"threefry original scheme: 120 B2 launches, {rate(res)}; 15 of 15 "
          f"gpu_ipc cells within {ABL_TOL} of BENCH_noc.json (max |diff| "
          f"{worst:.2e}); identity_bitwise; probed joint run "
          f"({res['b3_launches']} B3 launches, {res['probe_s']:.2f} s) "
          f"{res['probes']['joint']}; joint_beats_bandwidth; margins "
          f"{verdict['margins']}")
    sys.stdout.flush()

    # (c) one cell of each under the default scheme, and Fig. 4
    got = {}
    for (study, sc, arm), want in SCEN_PARTITIONABLE.items():
        if study == "faults":
            res = drive(f"[scen] (c) {sc}", flt, 18, 0, fault_set=(sc,),
                        probe=False)
        else:
            res = drive(f"[scen] (c) {sc}", plc, 12, 0, scenarios=(sc,),
                        probe=False)
        v = res["table"][sc][arm]["gpu_ipc"]
        check(abs(v - want) <= ABL_TOL,
              f"[scen] (c) {sc}/{arm} under the default scheme: gpu_ipc "
              f"{v:.7f}, expected {want} +- {ABL_TOL}")
        got[f"{sc}/{arm}"] = (v, res["rows"], res["sweep_s"])
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    tr = fig4.run(device=dev)
    wall4 = time.time() - t0
    check(ops.LAUNCHES["noc_fused_cycles"] == 120,
          f"[scen] (c) Fig. 4 launches {ops.LAUNCHES}")
    out["b2"] += 120
    check(all(v.shape == (120,) and np.isfinite(v).all() for v in tr.values()),
          "[scen] (c) Fig. 4: misshapen or non-finite traces")
    gpu_cov, cpu_cov, holds = fig4.cov_claim(tr)
    print(f"[scen] (c) default (partitionable) scheme: "
          + "; ".join(f"{k} gpu_ipc {v:.7f} ({n} rows, sweep {s:.3f} s)"
                      for k, (v, n, s) in got.items())
          + f", reference {list(SCEN_PARTITIONABLE.values())}; Fig. 4 PATH "
          f"baseline 120x500 (120 B2 launches, wall {wall4:.2f} s): gpu_inj "
          f"CoV {gpu_cov:.3f}, cpu_push CoV {cpu_cov:.3f} (claim gpu > 2x "
          f"cpu: {holds})")
    sys.stdout.flush()
    return out


# [replay]: the committed noc_trace_replay row of BENCH_noc.json (read-only)
# was drawn, as the noc_ablation row, under threefry's original scheme
REPLAY_PARTITIONABLE = False


def phase_replay(dev) -> dict:
    """[replay] the predictor grid (5 predictors x seeds 0-2, 120 epochs,
    kf_q 2e-2) on replayed serving traces, in one sweep on B2
    (benchmarks/torch_fig_trace_replay.py): (a) the JAX package's trace,
    rebuilt from the committed row's hlo_phases costs (each phase's rate
    the row's to the last bit), every predictor's mean GPU IPC within
    ABL_TOL of the row and kf_beats_all equal to the row's; (b) the trace
    of the port's own steps (launch.op_cost on meta), its costs and rates
    beside the row's, verdict and margins printed, not gated; (c) the
    record->replay check, bitwise.  Returns B2's launches."""
    import torch

    from benchmarks import torch_fig_ablation as abl
    from benchmarks import torch_fig_trace_replay as rep
    from repro_torch.core import threefry
    from repro_torch.core.noc import trace_adapters, traffic
    from repro_torch.kernels.noc_cycle import ops

    out = {"b2": 0}
    row = bench_row(rep.REPLAY_BENCH)
    source = rep.HLO_WORKLOAD

    def grid(tag, trace):
        traffic.register_workload(source, trace, overwrite=True)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        with threefry.threefry_partitionable(REPLAY_PARTITIONABLE):
            res = rep.run(source, device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        check(res["rows"] == 15 and res["b2_launches"] == 120
              and dict(ops.LAUNCHES) == {"noc_fused_cycles": 120,
                                         "noc_fused_cycles_probed": 0,
                                         "noc_arbitrate": 0},
              f"{tag}: {res['rows']} rows launched {ops.LAUNCHES}, expected "
              f"120 of B2 for 15")
        out["b2"] += 120
        cells = res["table"][source]
        check(all(math.isfinite(c["gpu_ipc"]) for c in cells.values()),
              f"{tag}: a non-finite cell {cells}")
        return cells, abl.kf_verdict(res["table"], source), wall

    # (a) the committed trace
    t0 = time.time()
    trace = rep.committed_trace(row)
    for p, c in row["hlo_phases"].items():
        got = trace.meta["phases"][p]
        check(got["rate"] == c["rate"] and got["intensity"] == c["intensity"],
              f"[replay] (a) {p}: rate {got['rate']!r} / intensity "
              f"{got['intensity']!r} from the row's costs, the row holds "
              f"{c['rate']!r} / {c['intensity']!r}")
    cells, verdict, wall = grid("[replay] (a)", trace)
    diffs = {p: abs(cells[p]["gpu_ipc"] - v)
             for p, v in row["gpu_ipc"].items()}
    check(max(diffs.values()) <= ABL_TOL,
          f"[replay] (a) the grid misses the committed {rep.REPLAY_BENCH} "
          f"row: "
          + ", ".join(f"{p} {cells[p]['gpu_ipc']:.7f}" for p in diffs)
          + f" against {row['gpu_ipc']} (tolerance {ABL_TOL})")
    check(verdict["kf_beats_all"] == row["kf_beats_all"],
          f"[replay] (a) kf_beats_all {verdict['kf_beats_all']}, the row "
          f"holds {row['kf_beats_all']}: {verdict}")
    print(f"[replay] (a) the JAX package's serving trace rebuilt from "
          f"BENCH_noc.json's {rep.REPLAY_BENCH} hlo_phases (rates bitwise "
          f"the row's: prefill {trace.meta['phases']['prefill']['rate']!r}, "
          f"decode {trace.meta['phases']['decode']['rate']!r}), 15 rows (5 "
          f"predictors x seeds 0-2) x 120x500 in one sweep under threefry's "
          f"original scheme: 120 B2 launches, wall {wall:.3f} s; gpu_ipc "
          + ", ".join(f"{p} {cells[p]['gpu_ipc']:.7f}" for p in cells)
          + f", each within {ABL_TOL} of the row (max |diff| "
          f"{max(diffs.values()):.2e}); kf_beats_all {verdict['kf_beats_all']}"
          f" as the row; margins {verdict['margins']}")
    sys.stdout.flush()

    # (b) the port's own trace, under the same scheme
    t1 = time.time()
    own = trace_adapters.hlo_serving_trace(name=source.lower())
    t_cost = time.time() - t1
    cells, verdict, wall = grid("[replay] (b)", own)
    cost = "; ".join(
        f"{p}: flops {c['flops']:.4e} bytes {c['bytes']:.4e} intensity "
        f"{c['intensity']:.4f} rate {c['rate']:.4f} (row {r['flops']:.4e} / "
        f"{r['bytes']:.4e} / {r['intensity']:.4f} / {r['rate']:.4f})"
        for p, c, r in ((p, own.meta["phases"][p], row["hlo_phases"][p])
                        for p in row["hlo_phases"]))
    print(f"[replay] (b) the port's own serving trace (launch.op_cost on "
          f"meta, {t_cost:.1f} s): {cost}; 15 rows x 120x500 under the "
          f"original scheme: 120 B2 launches, wall {wall:.3f} s; gpu_ipc "
          + ", ".join(f"{p} {c['gpu_ipc']:.7f}" for p, c in cells.items())
          + f"; kf_beats_all {verdict['kf_beats_all']} (not gated); margins "
          f"{verdict['margins']}")
    sys.stdout.flush()

    # (c) record -> npz -> replay, bitwise, on the card
    ops.reset_launches()
    failures = rep.replay_check(device=dev)
    check(not failures, f"[replay] (c) {failures}")
    n_c = ops.LAUNCHES["noc_fused_cycles"]
    check(n_c == 2 * rep.CHECK_EPOCHS, f"[replay] (c) launched {ops.LAUNCHES}")
    out["b2"] += n_c
    traffic.unregister_workload(source)
    print(f"[replay] (c) a {rep.CHECK_EPOCHS}-epoch {rep.CHECK_SCENARIO} "
          f"capture -> npz -> RecordedTrace.load -> simulate: bitwise the "
          f"direct run ({n_c} B2 launches); [replay] {time.time() - t0:.1f} s")
    sys.stdout.flush()
    return out


def phase_trace(dev) -> dict:
    """[trace] the flight-recorder renderer (benchmarks/torch_noc_trace.py)
    on the card: its check (a probed 4-epoch capture through B3, one launch
    an epoch and nothing else, invariants, npz round trip, both renderers)
    and its record (probes-off B2 against probes-on B3, the steady wall
    ratio, median of 5 calls).  Returns B2's and B3's launches."""
    from benchmarks import torch_noc_trace as nt
    from repro_torch.kernels.noc_cycle import ops

    t0 = time.time()
    try:
        nt.check(device=dev)
    except AssertionError as e:
        fail(f"[trace] the renderer's check failed: {e}")
    n_check = ops.LAUNCHES["noc_fused_cycles_probed"]
    rec = nt.record(device=dev)
    n = (1 + rec["repeats"]) * rec["n_epochs"]
    check(rec["launches_off"] == {"noc_fused_cycles": n,
                                  "noc_fused_cycles_probed": 0,
                                  "noc_arbitrate": 0}
          and rec["launches_on"] == {"noc_fused_cycles": 0,
                                     "noc_fused_cycles_probed": n,
                                     "noc_arbitrate": 0},
          f"[trace] record launched {rec['launches_off']} probes off, "
          f"{rec['launches_on']} on, expected {n} of B2 then of B3")
    print(f"[trace] renderer check on the card ({n_check} B3 launches, "
          f"ASCII above); "
          f"probe overhead B3/B2 steady {rec['probe_overhead_steady']}x (off "
          f"{rec['steady_off_s'] * 1e3:.2f} ms, on "
          f"{rec['steady_on_s'] * 1e3:.2f} ms per {rec['n_epochs']}x"
          f"{rec['epoch_len']} run, median of {rec['repeats']}); digest "
          f"{rec['probe_summary']}; [trace] {time.time() - t0:.1f} s")
    sys.stdout.flush()
    return {"b2": n, "b3": n + n_check}


def all_counts() -> dict:
    """Every kernel's launch count, keyed by its counter's name."""
    from repro_torch.kernels.kf_bank import ops as kf_ops
    from repro_torch.kernels.noc_cycle import ops

    return {**ops.LAUNCHES, **kf_ops.LAUNCHES, **counts()}


def reset_all_counts() -> None:
    from repro_torch.kernels.kf_bank import ops as kf_ops
    from repro_torch.kernels.noc_cycle import ops

    ops.reset_launches()
    kf_ops.reset_launches()
    reset_counts()


BENCH_ARCH = "llama3.2-3b"
BENCH_CELLS = ("decode_32k", "train_4k")
# torch_kernels_bench's entries (by name prefix) and the counter of the
# kernel each one runs
BENCH_KERNELS = (("flash_attn_512", "flash_attn"),
                 ("mamba_scan_256", "mamba_scan"), ("kf_bank", "kf_bank"),
                 ("noc_arb_lanes", "noc_arbitrate"),
                 ("noc_cycle_fused", "noc_fused_cycles"))


def phase_bench(dev) -> dict:
    """[bench] the port's benchmark drivers on the card, each against a
    ledger in a temp dir: (a) the sweep bench's smoke grid
    (torch_bench_sweep: serial arms on "ref", the batched arm on "fused"),
    its batched rows bitwise the serial rows, exactly one B2 launch an
    epoch, its row appended; (b) the fleet bench at its sizes, one B4
    launch an epoch; (c) torch_kernels_bench.main(["--record"]), every
    kernel held against its plain version inside it; (d) torch_check_bench
    --grid smoke over that ledger, exit 0; (e) the one-card dry run of
    llama3.2-3b's decode_32k and train_4k cells at its published config
    (meta tensors, nothing on the card; one process a cell, beside (a)-(d)),
    rendered by the roofline table.  Returns the launches of the phase by counter, and the kernels'
    largest errors against their plain versions in (c)."""
    from benchmarks import torch_roofline_table
    from repro_torch.launch import dryrun

    t0 = time.time()
    reset_all_counts()
    with tempfile.TemporaryDirectory() as tmp:
        # (e) first, beside the rest: the dry run touches no card (meta
        # tensors), one process a cell
        out = os.path.join(tmp, "dryrun")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(HERE, "src"), HERE]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             BENCH_ARCH, "--shape", shape, "--out", out], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for shape in BENCH_CELLS]
        try:
            errs = bench_drivers(dev, tmp)
            te = time.time()
            for shape, proc in zip(BENCH_CELLS, procs):
                log, _ = proc.communicate(timeout=300)
                check(proc.returncode == 0,
                      f"[bench] (e) dry run of {shape} exited "
                      f"{proc.returncode}: {log[-2000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for shape in BENCH_CELLS:
            with open(os.path.join(out, dryrun.record_name(BENCH_ARCH,
                                                           shape))) as f:
                r = json.load(f)
            check(r["status"] == "ok",
                  f"[bench] (e) dry run of {shape}: {r.get('error')}")
            print(f"[bench] (e) {dryrun.summary(r)} build={r['build_s']}s")
        shown = torch_roofline_table.main(["--results", out])
        check(len(shown) == len(BENCH_CELLS),
              f"[bench] (e) the roofline table rendered {len(shown)} rows")
        print(f"[bench] (e) dry run beside (a)-(d), waited "
              f"{time.time() - te:.1f} s after them")
    got = all_counts()
    print(f"[bench] launches {json.dumps(got, sort_keys=True)}; [bench] "
          f"{time.time() - t0:.1f} s")
    sys.stdout.flush()
    for name in ("noc_fused_cycles", "noc_arbitrate", "kf_bank",
                 "flash_attn", "mamba_scan"):
        check(got[name] > 0, f"[bench] launched no {name}")
    return got, errs


def bench_drivers(dev, tmp) -> dict:
    """[bench] (a)-(d) against the ledger tmp/BENCH_noc_torch.json; returns
    (c)'s largest error against the plain version, by kernel counter."""
    import torch

    from benchmarks import (torch_bench_fleet_kf, torch_bench_sweep,
                            torch_check_bench, torch_kernels_bench)
    from repro_torch.obs import ledger

    bench = os.path.join(tmp, "BENCH_noc_torch.json")
    ta = time.time()
    rec = torch_bench_sweep.run(smoke=True, device=dev)
    check(rec["batched_bitwise_serial"] is True
          and rec["batched_launches_per_epoch"] == 1,
          f"[bench] (a) sweep row {rec}: expected bitwise rows and one B2 "
          f"launch an epoch")
    rec = torch_bench_sweep.append_record(rec, bench)
    check(rec["device_kind"] == torch.cuda.get_device_name(0),
          f"[bench] (a) row stamped {rec['device_kind']!r}")
    print(f"[bench] (a) sweep smoke grid ({rec['grid']['n_points']} points "
          f"x {rec['grid']['n_epochs']} x {rec['grid']['epoch_len']}): "
          f"batched fused rows bitwise the serial ref rows, "
          f"{rec['batched_launches_per_epoch']:g} B2 launch an epoch; serial "
          f"{rec['serial_total_s']} / steady {rec['serial_steady_s']} s, "
          f"batched {rec['batched_total_s']} / {rec['batched_steady_s']} s: "
          f"{rec['speedup_end_to_end']}x end to end, "
          f"{rec['speedup_steady']}x steady; appended, stamped "
          f"{rec['device_kind']!r} ({time.time() - ta:.1f} s)")
    tb = time.time()
    points = torch_bench_fleet_kf.run(device=dev)
    check(all(p["b4_launches"] == p["iters"] for p in points),
          f"[bench] (b) fleet bench launched B4 {points}")
    print("[bench] (b) fleet: " + "; ".join(
        f"n {p['n_filters']}: {p['epoch_us']} us an epoch, "
        f"{p['b4_launches']} B4 launches" for p in points)
        + f" ({time.time() - tb:.1f} s)")
    tc = time.time()
    rows = torch_kernels_bench.main(["--record", "--bench-json", bench])
    errs = {}
    for row in rows:
        kern = next(k for p, k in BENCH_KERNELS if row["name"].startswith(p))
        errs[kern] = max(errs.get(kern, 0.0), row["max_abs_err"])
    print(f"[bench] (c) kernel micro-benches: {len(rows)} entries, each held "
          f"against its plain version ({time.time() - tc:.1f} s)")
    td = time.time()
    rc = torch_check_bench.main(["--grid", "smoke", "--bench-json", bench])
    check(rc == 0, f"[bench] (d) torch_check_bench exited {rc}")
    with open(bench) as f:
        written = json.load(f)
    check([r["bench"] for r in written]
          == ["noc_sweep_serial_vs_batched", "noc_cycle_kernels"]
          and not any(ledger.validate_row(r) for r in written),
          f"[bench] ledger holds {[r['bench'] for r in written]}")
    print(f"[bench] (d) torch_check_bench --grid smoke over the temp ledger: "
          f"exit 0 ({time.time() - td:.1f} s)")
    sys.stdout.flush()
    return errs


def phase_b4(dev):
    """B4 against its plain version, then the fleet path through B4."""
    import torch

    from repro_torch.dist.kf_scheduler import FleetKF, SchedulerConfig
    from repro_torch.kernels.kf_bank import kernel as kf_kernel
    from repro_torch.kernels.kf_bank import ops as kf_ops

    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def bank(n, m):
        u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
            shape, generator=g, device=dev)
        return (torch.randn(n, generator=g, device=dev), u(n, 0.1, 2.0),
                torch.randn((n, m), generator=g, device=dev),
                u(m, 0.5, 1.5), u(m, 0.05, 0.5))

    err, checked = 0.0, 0
    for n in (7, 1024, 65_536, 1_048_576):
        for m in (3, 5):
            ins = bank(n, m)
            for a, q in ((1.0, 1e-3), (0.9, 1e-2)):
                kx, kp = kf_kernel.kf_bank(*ins, a=a, q=q)
                px, pp = kf_ops.kf_bank_step_plain(*ins, a=a, q=q)
                err = max(err, float((kx - px).abs().max()),
                          float((kp - pp).abs().max()))
                check(torch.equal(kx, px) and torch.equal(kp, pp),
                      f"B4 differs from its plain version at n={n}, m={m}, "
                      f"a={a} (max abs err {err})")
                checked += 1
            # the fleet's epoch form: the same step with the signal fused in
            ex, ep, es = kf_kernel.Bank(n, ins[3], ins[4], a=0.9,
                                        q=1e-2).epoch(*ins[:3])
            px, pp, ps = kf_ops.kf_bank_epoch_plain(*ins, a=0.9, q=1e-2)
            check(torch.equal(ex, px) and torch.equal(ep, pp)
                  and torch.equal(es, ps),
                  f"B4's epoch form differs from kf_bank_epoch_plain at "
                  f"n={n}, m={m}")
            checked += 1
    times = {}
    for n in (65_536, 1_048_576):
        ins = bank(n, 3)
        times[n] = (cuda_ms(lambda: kf_kernel.kf_bank(*ins, a=1.0, q=1e-3),
                            200),
                    cuda_ms(lambda: kf_ops.kf_bank_step_plain(
                        *ins, a=1.0, q=1e-3), 50))
        times[n] += (one_kernel_each(
            lambda: kf_kernel.kf_bank(*ins, a=1.0, q=1e-3), 50,
            "kf_bank_kernel", "kf_bank"),)
    bm, by = kf_bank_bound(65_536, 3)
    big, big_dev = times[1_048_576][0], times[1_048_576][2]
    nbytes = 7 * 4 * 1_048_576
    print(f"[B4] kf_bank bitwise equal to its plain version in {checked} "
          f"cases (n 7 .. 1,048,576, M 3 and 5, a 1.0 and 0.9, and the epoch "
          f"form with its signal); ms per launch at n=65,536, M=3: kernel "
          f"{times[65_536][0]:.4f}, plain {times[65_536][1]:.4f}, bound "
          f"{bm:.5f} ({by}); at n=1,048,576: kernel {big:.4f} ms "
          f"({nbytes / big / 1e6:.0f} GB/s on events), plain "
          f"{times[1_048_576][1]:.4f} ms; device time per launch "
          f"(torch.profiler, one kernel a call) {fmt_ms(times[65_536][2])} "
          f"at n=65,536, {fmt_ms(big_dev)} at n=1,048,576"
          + (f" ({nbytes / big_dev / 1e6:.0f} GB/s)" if big_dev > 0 else ""))

    # the fleet path: 200 epochs of FleetKF(65,536), one B4 launch each,
    # and the same epochs through the plain version on the card
    n, epochs = 65_536, 200
    zs = 0.7 * torch.randn((epochs, n, 3), generator=g, device=dev)
    cfg = SchedulerConfig(kf_q=3e-3, kf_r=2e-1)
    fleet = FleetKF(n, cfg)
    kf_ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    sigs = [fleet.epoch(zs[t]) for t in range(epochs)]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kf_ops.LAUNCHES["kf_bank"]
    check(launches == epochs, f"FleetKF launched B4 {launches} times over "
                              f"{epochs} epochs")
    x = torch.zeros(n, device=dev)
    p = torch.ones(n, device=dev)
    for t in range(epochs):
        x, p, sig = kf_ops.kf_bank_epoch_plain(x, p, zs[t], fleet.h, fleet.r,
                                               a=1.0, q=cfg.kf_q)
        check(torch.equal(sig, sigs[t]),
              f"FleetKF signals differ from the plain path at epoch {t}")
    check(torch.equal(x, fleet.x) and torch.equal(p, fleet.p),
          "FleetKF state differs from the plain path after 200 epochs")
    boost = float(sigs[-1].float().mean())
    # one device kernel per epoch, B4's; the epoch per call on events and
    # its device time (a second bank, so the checked run stays as it was)
    probe = FleetKF(n, cfg)
    epoch_dev = one_kernel_each(lambda: probe.epoch(zs[0]), 50,
                                "kf_bank_kernel", "FleetKF.epoch")
    epoch_ms = cuda_ms(lambda: probe.epoch(zs[0]), 200)
    print(f"[B4] FleetKF({n:,}) x {epochs} epochs: {launches} B4 launches, "
          f"one device kernel an epoch; wall {wall:.3f} s "
          f"({wall / epochs * 1e3:.4f} ms per epoch); an epoch timed alone "
          f"{epoch_ms:.4f} ms per call (events), device "
          f"{fmt_ms(epoch_dev)}; x, p and every epoch's signals bitwise "
          f"equal to the plain path; last epoch boosts {boost:.3f} of the "
          f"links")
    sys.stdout.flush()
    return dict(name="kf_bank", route="cuda",
                source="src/repro_torch/kernels/kf_bank/csrc/kf_bank.cu",
                replaces="src/repro/kernels/kf_bank/kernel.py:34",
                launches=launches, max_abs_err=err, ms=times[65_536][0],
                plain_ms=times[65_536][1], bound_ms=bm, bound_by=by,
                library_ms=None)


def phase_b5(dev):
    """B5 against its plain version at the models' shapes, and its time at
    the llama3.2-3b, zamba2 and llama4-maverick shapes beside the bound and
    torch's SDPA, and at grok-1's capped shape (S = 2048) beside the
    bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    llama = ("llama3.2-3b", 24, 8, 128)
    zamba = ("zamba2-2.7b", 32, 32, 80)   # the shared attention block
    grok = ("grok-1-314b", 48, 8, 128)    # GQA groups of 6, logit cap 30
    maverick = ("llama4-maverick-400b-a17b", 40, 8, 128)  # groups of 5
    # seamless-m4t's encoder (no mask over its 1536 frames) and decoder
    # (MHA, D = 64), internvl2's decoder (groups of 2)
    s_enc = ("seamless-m4t-large-v2 encoder", 16, 16, 64)
    s_dec = ("seamless-m4t-large-v2 decoder", 16, 16, 64)
    vlm = ("internvl2-2b", 16, 8, 128)
    cases = [(llama, s, True, None, None, None) for s in (48, 512, 2048)] + [
        (("h2o-danube-1.8b", 32, 8, 80), 6144, True, 4096, None, None),
        (grok, 512, True, None, 30.0, None),
        (grok, 512, True, None, 30.0, 300),
        (grok, 2048, True, None, 30.0, None),
    ] + [(zamba, s, True, None, None, None) for s in (512, 2048)] + [
        (maverick, s, True, None, None, None) for s in (512, 2048)] + [
        (s_enc, 1536, False, None, None, None),
        (s_enc, 1536, False, None, None, 1000),
        (s_dec, 2048, True, None, None, None),
        (vlm, 2048, True, None, None, None)]
    # timed at every S without kv_len, beside SDPA; grok-1 at S = 2048
    # only, and without SDPA, which has no logit cap
    timed = (llama[0], zamba[0], maverick[0], s_enc[0], vlm[0])
    tol = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (8e-3, 2 ** -7)}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timing = []
    for (arch, h, kv, d), s, causal, window, cap, kv_len in cases:
        base = [torch.randn(shape, generator=g, device=dev)
                for shape in ((1, s, h, d), (1, s, kv, d), (1, s, kv, d))]
        kw = dict(causal=causal, window=window, logit_cap=cap, kv_len=kv_len)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in base)
            out = fa_kernel.flash_attn(q, k, v, **kw)
            want = fa_ops.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs()
            atol, rtol = tol[dtype]
            check(out.dtype == dtype and bool(torch.isfinite(out).all())
                  and bool((diff <= atol + rtol * want.float().abs()).all()),
                  f"B5 differs from its plain version: {arch} S={s} {dtype} "
                  f"(max abs err {float(diff.max())})")
            errs[dtype] = max(errs[dtype], float(diff.max()))
            lib_too = arch in timed and kv_len is None
            if dtype == torch.bfloat16 and (lib_too or (
                    arch == grok[0] and s == 2048)):
                # the kernel and SDPA each timed two ways: CUDA events over
                # back-to-back calls (host work included: the wrapper,
                # checks, three tensor-map encodes and the launch) and the
                # device time of the kernels under torch.profiler
                reps = {48: 200, 512: 50, 1536: 20, 2048: 20}[s]

                def kern():
                    return fa_kernel.flash_attn(q, k, v, **kw)

                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True)

                ms = cuda_ms(kern, reps)
                dev_ms = profile_device(kern, 20, whole=True)[1]
                lib = cuda_ms(sdpa, reps) if lib_too else None
                lib_dev = (profile_device(sdpa, 20, whole=True)[1] if lib_too
                           else None)
                plain = cuda_ms(lambda: fa_ops.flash_attention_plain(
                    q, k, v, **kw), 5)
                (bm, by), pairs = flash_bound(1, h, kv, s, s, d, causal,
                                              window, kv_len, dtype)
                # a device time the tracing dropped is "not measured" (0)
                flops = 4 * d * h * pairs
                timing.append(dict(
                    arch=arch, h=h, kv=kv, d=d, cap=cap, causal=causal,
                    s=s, ms=ms, dev_ms=dev_ms, lib=lib, lib_dev=lib_dev,
                    plain=plain, bm=bm, by=by, blocks=h * -(-s // 128),
                    tflops=flops / ms / 1e9, flops=flops,
                    bound_tflops=flops / bm / 1e9))
        del base, q, k, v, out, want
        torch.cuda.empty_cache()
    print(f"[B5] flash_attn within tolerance of its plain version at "
          f"{len(cases)} shapes x (bf16: wgmma + TMA, f32: SIMT): max abs "
          f"err bf16 {errs[torch.bfloat16]:.3g} (atol 8e-3 + 2^-7 rel), f32 "
          f"{errs[torch.float32]:.3g} (atol 2e-5 + 1e-5 rel)")
    for t in timing:
        both = t["dev_ms"] > 0 and bool(t["lib_dev"])
        lib = (f"SDPA events {t['lib']:.4f} ms, device "
               f"{fmt_ms(t['lib_dev'])}; kernel/SDPA events "
               f"{t['ms'] / t['lib']:.2f}x, device "
               + (f"{t['dev_ms'] / t['lib_dev']:.2f}x" if both
                  else "not measured") if t["lib"] is not None
               else "no SDPA time (SDPA has no logit cap)")
        dev = (f"{t['dev_ms']:.4f} ms "
               f"({t['flops'] / t['dev_ms'] / 1e9:.1f} TFLOP/s)"
               if t["dev_ms"] > 0 else "not measured")
        print(f"[B5] {t['arch']} bf16 B=1 H={t['h']} KV={t['kv']} D={t['d']} "
              f"S={t['s']} {'causal' if t['causal'] else 'no mask'}"
              + (f", logit cap {t['cap']:g}" if t["cap"] else "")
              + f" ({t['blocks']} blocks of 384 threads on "
              f"{torch.cuda.get_device_properties(0).multi_processor_count}"
              f" SMs): kernel events {t['ms']:.4f} ms per call "
              f"({t['tflops']:.1f} TFLOP/s), device {dev}; {lib}; bound "
              f"{t['bm']:.5f} ms ({t['by']}; {t['bound_tflops']:.1f} TFLOP/s "
              f"at the bound); plain {t['plain']:.4f} ms")
    sys.stdout.flush()
    t, z, mv, gk, vl = (
        next(x for x in timing if x["arch"] == a and x["s"] == 2048)
        for a in (llama[0], zamba[0], maverick[0], grok[0], vlm[0]))
    enc = next(x for x in timing if x["arch"] == s_enc[0])

    def row(x, shape):
        return dict(shape=shape, ms=x["ms"], plain_ms=x["plain"],
                    bound_ms=x["bm"], bound_by=x["by"], library_ms=x["lib"])

    # ms and library_ms at S = 2048 are CUDA-event ms per call, as in every
    # other row; the profiler's device time is in the [B5] lines above;
    # zamba2's shared block (H = KV = 32, D = 80), maverick's (H 40, KV 8),
    # grok-1's (H 48, KV 8, cap 30; no library call), seamless-m4t's
    # encoder (H = KV = 16, D = 64, no mask) and internvl2's (H 16, KV 8)
    # beside llama's
    return dict(name="flash_attn", route="cuda",
                source="src/repro_torch/kernels/flash_attn/csrc/"
                       "flash_attn_sm90.cu",
                replaces="src/repro/kernels/flash_attn/kernel.py:31",
                launches=None, max_abs_err=errs[torch.bfloat16],
                ms=t["ms"], plain_ms=t["plain"], bound_ms=t["bm"],
                bound_by=t["by"], library_ms=t["lib"],
                zamba2=row(z, "(1, 2048, 32, 80) bf16 causal"),
                maverick=row(mv, "(1, 2048, 40, 128), KV 8, bf16 causal"),
                grok=row(gk, "(1, 2048, 48, 128), KV 8, bf16 causal, "
                             "logit cap 30"),
                seamless_encoder=row(enc, "(1, 1536, 16, 64), KV 16, bf16, "
                                          "no mask"),
                internvl2=row(vl, "(1, 2048, 16, 128), KV 8, bf16 causal"))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def phase_serve_w(dev):
    """llama3.2-3b at full width, depth cut to 2 layers: the card (B5)
    against the CPU (plain) on one seeded parameter set.  The card's part
    runs now; the CPU's (with the comparison) is returned as a function,
    for `on_worker`."""
    import dataclasses

    import torch

    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get("llama3.2-3b"), n_layers=2)
    params = lm.make_lm(torch.Generator(device=dev).manual_seed(SEED), cfg)
    cpu_params = _to_cpu(params)
    g = torch.Generator().manual_seed(SEED + 6)
    toks = torch.randint(0, cfg.vocab_size, (1, 256), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (2, 1, 1), generator=g)
    fa_ops.reset_launches()
    t0 = time.time()

    def run(p, device):
        seen = {}
        st = lm.prefill_caches(p, toks.to(device), cfg, 512)
        for tag in ("prefill", "decode 0", "decode 1"):
            if tag != "prefill":
                lg, st = lm.decode_step(p, steps[int(tag[-1])].to(device), st,
                                        cfg)
                check(lg.shape == (1, 1, cfg.vocab_size)
                      and bool(torch.isfinite(lg).all()),
                      f"full-width logits misshapen or non-finite ({tag})")
                seen[f"logits {tag}"] = lg.cpu()
            seen[f"K {tag}"] = st.caches[0].k.cpu().clone()
            seen[f"V {tag}"] = st.caches[0].v.cpu().clone()
        return seen

    on_card = run(params, dev)
    check(fa_ops.LAUNCHES["flash_attn"] == cfg.n_layers,
          f"full-width prefill launched B5 {fa_ops.LAUNCHES} times")
    t_card = time.time() - t0
    del params
    torch.cuda.empty_cache()

    return functools.partial(
        twin_cpu_side, "[serve-w]",
        "llama3.2-3b full width (d_model 3072, 24/8 heads, d_ff 8192, vocab "
        "128,256), 2 layers: prefill 256 tokens + 2 decode steps, card (B5, "
        "bf16 cuBLAS)", run, cpu_params, on_card, t_card, witness=False)


def on_worker(fn):
    """Start ``fn`` (a CPU twin's comparison) on a daemon thread beside the
    card's next phases; return a join that waits for it and re-raises its
    failure on the calling thread."""
    import threading

    errors = []

    def run():
        try:
            fn()
        except BaseException as e:   # re-raised by join
            errors.append(e)

    worker = threading.Thread(target=run, daemon=True)
    worker.start()

    def join():
        worker.join()
        if errors:
            raise errors[0]

    return join


def stamp(what: str, t_start: float) -> None:
    print(f"[time] {what} done at {time.time() - t_start:.1f} s")
    sys.stdout.flush()


def wall_ms(fn, n: int) -> float:
    """Host wall ms per call of ``fn`` over ``n`` back-to-back calls that
    end in one sync (after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3 / n


# the serving workloads: the first keeps the KF at config 0 throughout;
# on the second (mean gen 32, max_len 768) it boosts and switches
SERVE_RUNS = (
    (dict(max_slots=8, max_len=2048, budget_tokens=1024),
     dict(n_requests=32, mean_prompt=512, mean_gen=16, seed=0)),
    (dict(max_slots=8, max_len=768, budget_tokens=1024),
     dict(n_requests=32, mean_prompt=512, mean_gen=32, seed=0)),
)


def switches(configs) -> int:
    return sum(a != b for a, b in zip(configs, configs[1:]))


def serve_main(dev, tag, cfg, params, t_init, kernels):
    """The serving main path at full width: Engine(mode="kf") on the card
    with ``params`` over each of SERVE_RUNS' workloads (32 requests);
    ``kernels`` lists (counter module, key, name, launches per prefill):
    each kernel launched exactly that many times per prefill (counted in
    ``counter.LAUNCHES``) and no other launch of those counters; and
    EngineStats equal to the same Engine run at smoke size on the CPU; on
    the second workload the KF must boost and switch.  After the first run
    a decode step and a 512-token prefill are timed alone and profiled.
    Returns each kernel's launches over both runs, by name."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.models import lm
    from repro_torch.serve import batching
    from repro_torch.serve.engine import Engine, EngineConfig

    smoke = configs.smoke(cfg.name)
    cpu_params = lm.make_lm(torch.Generator().manual_seed(SEED), smoke)

    def trace(st):
        return (st.configs, st.kf_signals, st.iters, st.clock,
                [(r.rid, r.t_first_token, r.t_done, r.tokens_out)
                 for r in st.finished], st.summary())

    total = {name: 0 for _, _, name, _ in kernels}
    counters = {c for c, _, _, _ in kernels}
    for i, (ekw, wkw) in enumerate(SERVE_RUNS):
        ecfg = EngineConfig(mode="kf", **ekw)
        wl = batching.WorkloadConfig(**wkw)
        # the run as a user makes it: no sync is added inside it
        engine = Engine(params, cfg, ecfg)
        for c in counters:
            c.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        stats = engine.run(batching.generate(wl))
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {k: v for c in counters for k, v in c.LAUNCHES.items()}
        want = {k: 0 for k in counts}
        for _, key, name, per in kernels:
            want[key] = per * wl.n_requests
            total[name] += counts[key]
        # the engine prefills each request once, in one prefill_caches call
        check(len(stats.finished) == wl.n_requests,
              f"{tag} {len(stats.finished)} of {wl.n_requests} requests "
              f"finished")
        check(counts == want,
              f"{tag} serving path: launches {counts}, expected {want} ("
              + ", ".join(f"{per} {name}" for _, _, name, per in kernels)
              + f" per prefill x {wl.n_requests} prefills) and no other")
        logits, _ = lm.decode_step(params, engine._tokens, engine.state, cfg)
        caches = list(engine.state.caches) + (
            [] if engine.state.shared_kv is None else [engine.state.shared_kv])
        check(logits.shape == (ecfg.max_slots, 1, cfg.vocab_size)
              and bool(torch.isfinite(logits).all())
              and all(bool(torch.isfinite(leaf.float()).all())
                      for c in caches for leaf in c),
              f"{tag} serving path: non-finite logits or caches")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prompt_toks = sum(r.prompt_len for r in stats.finished)
        gen_toks = sum(r.tokens_out for r in stats.finished)

        prof_lines = []
        if i == 0:
            # each model call alone, after the run: host wall per call over
            # back-to-back calls, and the device's busy time under
            # torch.profiler
            def decode():
                return lm.decode_step(params, engine._tokens, engine.state,
                                      cfg)

            toks = torch.zeros((1, 512), dtype=torch.int64, device=dev)

            def prefill():
                return lm.prefill_caches(params, toks, cfg, ecfg.max_len)

            d_wall = wall_ms(decode, 10)
            p_wall = wall_ms(prefill, 5)
            _, d_busy, d_dev, d_host, d_note = profile_device(decode, 3)
            _, p_busy, p_dev, _, p_note = profile_device(prefill, 1)
            prof_lines = [
                f"{tag} decode step alone: wall {d_wall:.2f} ms "
                f"({1e3 / d_wall:.1f} steps/s, 10 back-to-back steps), "
                f"device busy {fmt_ms(d_busy)}{d_note} (torch.profiler), idle "
                f"share "
                + (f"{1 - d_busy / d_wall:.3f}" if d_busy > 0
                   else "not measured")
                + f"; top device ops (ms per step): {fmt_top(d_dev)}; top "
                f"host ops by self time: {fmt_top(d_host)}",
                f"{tag} prefill of 512 tokens alone: wall {p_wall:.2f} ms "
                f"({512e3 / p_wall:.0f} tokens/s, 5 back-to-back prefills), "
                f"device busy {fmt_ms(p_busy)}{p_note}; top device ops: "
                f"{fmt_top(p_dev)}",
            ]

        t1 = time.time()
        ref = Engine(cpu_params, smoke, ecfg, device="cpu").run(
            batching.generate(wl))
        t_ref = time.time() - t1
        check(trace(stats) == trace(ref),
              f"{tag} EngineStats on the card differ from the CPU smoke run "
              f"(workload {i + 1})")
        boosted, n_sw = sum(stats.configs), switches(stats.configs)
        if i == 1:
            check(boosted > 0 and n_sw >= 1,
                  f"{tag} the switching workload boosted {boosted} of "
                  f"{stats.iters} iterations with {n_sw} switches")
        summ = {k: round(v, 6) for k, v in stats.summary().items()}
        print(f"{tag} workload {i + 1}: {cfg.name} full width, "
              f"{cfg.n_layers} layers, Engine(kf, {ecfg.max_slots} slots, "
              f"max_len {ecfg.max_len}, budget {ecfg.budget_tokens}), "
              f"{wl.n_requests} requests (mean prompt {wl.mean_prompt}, mean "
              f"gen {wl.mean_gen}): "
              + ", ".join(f"{counts[key]} {name} launches = {per} x "
                          f"{wl.n_requests} prefills"
                          for _, key, name, per in kernels)
              + "; all finished; "
              f"logits finite; EngineStats equal to the CPU smoke run "
              f"({t_ref:.1f} s); init {t_init:.1f} s; wall {wall:.2f} s for "
              f"{prompt_toks} prompt and {gen_toks} generated tokens "
              f"({(prompt_toks + gen_toks) / wall:.0f} tokens/s over the "
              f"run); peak device memory {peak_gb:.1f} GB")
        print(f"{tag} workload {i + 1}: wall {wall:.2f} s, {stats.iters} "
              f"iterations, KF boosted {boosted}, {n_sw} switches")
        print(f"{tag} summary() on the virtual clock (not wall time): {summ}")
        if prof_lines:
            print("\n".join(prof_lines))
        sys.stdout.flush()
        del engine
        torch.cuda.empty_cache()
    return total


def phase_serve(dev):
    """The serving main path on llama3.2-3b through B5."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.models import lm

    cfg = configs.get("llama3.2-3b")
    t0 = time.time()
    params = lm.make_lm(torch.Generator(device=dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    launches = serve_main(dev, "[serve]", cfg, params, t_init,
                          [(fa_ops, "flash_attn", "B5", cfg.n_layers)])
    del params
    torch.cuda.empty_cache()
    return launches["B5"]


def scan_inputs(g, b, L, d, s):
    """B6's inputs as the JAX kernel test draws them: a in [0.5, 0.999),
    b ~ 0.1 N(0, 1), h0 ~ N(0, 1), float32 on ``g``'s device."""
    import torch

    dev = g.device
    a = 0.5 + 0.499 * torch.rand((b, L, d, s), generator=g, device=dev)
    bb = 0.1 * torch.randn((b, L, d, s), generator=g, device=dev)
    return a, bb, torch.randn((b, d, s), generator=g, device=dev)


def b6_bound(b, L, d, s):
    """Least time of one B6 launch: a and b read and hs written once
    (B*L*D*S floats each), h0 read and h_last written once; 2 flops per
    element at the f32 rate."""
    n = b * L * d * s
    return bound_ms((3 * n + 2 * b * d * s) * 4, 2 * n, PEAK_F32_FLOP_S)


def phase_b6(dev):
    """B6 against its plain version (`scan_ref`), bitwise, at the JAX kernel
    test's shapes and at the forward shape; timed at the forward shape."""
    import torch

    from repro_torch.kernels.mamba_scan import kernel as ms_kernel
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan.ref import scan_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    shapes = [(2, 64, 32, 8, 16, 16), (1, 128, 64, 16, 32, 32),
              (2, 32, 16, 4, 32, 16), (1, 64, 128, 8, 64, 64),
              (1, 2048, 8192, 16, 256, 256)]
    err = 0.0
    for b, L, d, s, chunk, bd in shapes:
        a, bb, h0 = scan_inputs(g, b, L, d, s)
        hs, hl = ms_ops.mamba_chunk_scan(a, bb, h0, chunk=chunk, block_d=bd)
        hs_p, hl_p = scan_ref(a, bb, h0)
        err = max(err, float((hs - hs_p).abs().max()),
                  float((hl - hl_p).abs().max()))
        check(torch.equal(hs, hs_p) and torch.equal(hl, hl_p),
              f"B6 differs from its plain version at {(b, L, d, s)} (max "
              f"abs err {err})")
        del hs, hl, hs_p, hl_p
    b, L, d, s = shapes[-1][:4]
    ms = cuda_ms(lambda: ms_kernel.mamba_scan(a, bb, h0), 10)
    plain = cuda_ms(lambda: scan_ref(a, bb, h0), 1, warmup=1)
    bm, by = b6_bound(b, L, d, s)
    gbs = (3 * b * L * d * s + 2 * b * d * s) * 4 / ms / 1e6
    print(f"[B6] mamba_scan bitwise equal to its plain version at "
          f"{len(shapes)} shapes (the JAX test's four and {(b, L, d, s)}); "
          f"at (1, 2048, 8192, 16): kernel {ms:.4f} ms ({gbs:.0f} GB/s), "
          f"plain {plain:.2f} ms, bound "
          f"{bm:.4f} ms ({by})")
    sys.stdout.flush()
    del a, bb, h0
    torch.cuda.empty_cache()
    return dict(name="mamba_scan", route="cuda",
                source="src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
                replaces="src/repro/kernels/mamba_scan/kernel.py:30",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bm, bound_by=by, library_ms=None)


def b7_bound(b, L, d, s, elem, h0=True):
    """Least time of one B7 launch: dt, xc, B, C, A (and h0) read once, y
    and h_last written once; against ~6 f32 flops per (t, d, s) at the f32
    rate and one exponential per (t, d, s) at the MUFU rate."""
    n = b * L * d * s
    nbytes = (b * L * d * (4 + elem + 4) + 2 * b * L * s * elem + d * s * 4
              + (2 if h0 else 1) * b * d * s * 4)
    t = {"bytes": nbytes / PEAK_BYTES_S * 1e3,
         "operations": max(6 * n / PEAK_F32_FLOP_S, n / PEAK_EXP_S) * 1e3}
    by = max(t, key=t.get)
    return t[by], by


def m2_bound(b, L, nh, hd, s, elem):
    """Least time of the mamba2 scan itself (fused_chunked_scan_m2's
    function): dt (B, L, nh) f32, x (B, L, nh*hd), B and C read once, h0
    read and y, h_last (f32) written once; ~6 f32 flops per (t, d, s) at
    the f32 rate and one exponential per (t, head), not per (t, d, s)."""
    d = nh * hd
    n = b * L * d * s
    nbytes = (b * L * nh * 4 + b * L * d * (elem + 4) + 2 * b * L * s * elem
              + nh * 4 + 2 * b * d * s * 4)
    t = {"bytes": nbytes / PEAK_BYTES_S * 1e3,
         "operations": max(6 * n / PEAK_F32_FLOP_S,
                           b * L * nh / PEAK_EXP_S) * 1e3}
    by = max(t, key=t.get)
    return t[by], by


Z_HD = 64   # zamba2's ssm head dim: A is one value a head


def b7_inputs(g, b, L, d, s, dtype, kind, h0):
    """B7's inputs on ``g``'s device: dt in [0.001, 0.1), xc, B, C ~ N(0, 1)
    in ``dtype``, A as falcon-mamba's (S4D-real), zamba2's (-(1 .. nh) a
    head, over its channels) or the JAX test's, and h0 ~ N(0, 1) or None."""
    import torch

    dev = g.device
    u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        shape, generator=g, device=dev)
    dt = u((b, L, d), 0.001, 0.1)
    xc, bm, cm = (torch.randn(shape, generator=g, device=dev).to(dtype)
                  for shape in ((b, L, d), (b, L, s), (b, L, s)))
    if kind == "falcon":    # S4D-real A
        a_mat = -torch.arange(1, s + 1, dtype=torch.float32,
                              device=dev).repeat(d, 1)
    elif kind == "zamba2":  # -(1 .. nh) a head, over its channels
        a_mat = -(torch.arange(d, device=dev) // Z_HD + 1).to(
            torch.float32)[:, None].expand(d, s).contiguous()
    else:                   # the JAX test's A
        a_mat = -torch.exp(0.3 * torch.randn((d, s), generator=g,
                                             device=dev))
    h = torch.randn((b, d, s), generator=g, device=dev) if h0 else None
    return dt, xc, bm, cm, a_mat, h


def phase_b7(dev):
    """B7 against its plain version within 1e-5 at the JAX kernel test's
    shapes (f32), falcon-mamba's (S = 16: bf16 xc/B/C, nonzero h0) and
    zamba2's (S = 64: bf16 and f32, from zero and from h0, a ragged D and
    an unaligned base through the element copies); timed at the models'
    shapes."""
    import torch

    from repro_torch.kernels.mamba_scan import fused as ms_fused
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel
    from repro_torch.kernels.mamba_scan import sweep_b7

    g = torch.Generator(device=dev).manual_seed(SEED + 11)

    def unaligned(t):
        """t's values in a view one element into its storage."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    f32, bf16 = torch.float32, torch.bfloat16
    # (b, L, d, s, dtype, kind, h0, unaligned base, timed)
    cases = [(2, 64, 32, 8, f32, "jax", False, False, False),
             (1, 128, 64, 16, f32, "jax", False, False, False)] + [
        (1, L, 8192, 16, bf16, "falcon", True, False, True)
        for L in (48, 517, 2048)] + [
        (1, 517, 5120, 64, dt_, "zamba2", h0, False, dt_ == bf16 and h0)
        for dt_ in (bf16, f32) for h0 in (True, False)] + [
        (1, 2048, 5120, 64, bf16, "zamba2", True, False, True),
        (1, 517, 5001, 64, bf16, "zamba2", True, False, False),
        (1, 517, 5120, 64, f32, "zamba2", True, True, False)]
    inst = ms_kernel.fused_config()
    k16, k8, k64 = (min(inst["K"], n) for n in (16, 8, 64))
    channels = inst["threads"] * k16 // 16
    print(f"[B7] instantiation: {k16} states per thread at S = 16 ({k8} at "
          f"S = 8, {k64} at S = 64), {inst['U']} steps in flight, "
          f"{inst['threads']} threads per block ({channels} channels at S = "
          f"16, {inst['threads'] * k64 // 64} at S = 64), {inst['tile']} "
          f"steps per tile")
    err, err64, timing, bitwise = 0.0, 0.0, {}, 0
    for b, L, d, s, dtype, kind, with_h0, shift, timed in cases:
        dt, xc, bm, cm, a_mat, h0 = b7_inputs(g, b, L, d, s, dtype, kind,
                                              with_h0)
        if shift:
            dt, xc, bm, cm = (unaligned(t) for t in (dt, xc, bm, cm))
        y, hl = ms_fused.fused_mamba_scan(dt, xc, bm, cm, a_mat, h0=h0)
        y_p, hl_p = ms_fused.fused_mamba_scan_plain(dt, xc, bm, cm, a_mat, h0)
        bitwise += torch.equal(y, y_p) and torch.equal(hl, hl_p)
        for got, want in ((y, y_p), (hl, hl_p)):
            diff = (got - want).abs()
            err = max(err, float(diff.max()))
            if s == 64:
                err64 = max(err64, float(diff.max()))
            check(bool(torch.isfinite(got).all()) and bool(
                (diff <= 1e-5 + 1e-5 * want.abs()).all()),
                f"B7 differs from its plain version at {(b, L, d, s)} "
                f"{dtype} h0={with_h0} unaligned={shift} (max abs err "
                f"{float(diff.max())})")
        if timed:
            # CUDA events over back-to-back calls (the wrapper's host work
            # included) and the kernel's device time under torch.profiler
            def kern():
                return ms_kernel.mamba_fused(dt, xc, bm, cm, a_mat, h0)

            ms = cuda_ms(kern, 20)
            dev_ms, dev_n = sweep_b7.device_ms(kern, 20)
            plain = (cuda_ms(lambda: ms_fused.fused_mamba_scan_plain(
                dt, xc, bm, cm, a_mat, h0), 1, warmup=0)
                if L == 517 or s == 64 else None)
            timing[(L, d, s)] = (ms, dev_ms, dev_n, plain,
                                 *b7_bound(b, L, d, s, 2))
        del dt, xc, bm, cm, a_mat, h0, y, hl, y_p, hl_p
    print(f"[B7] mamba_fused within 1e-5 (abs + rel) of its plain version at "
          f"{len(cases)} shapes (the JAX test's two in f32 from zero; (1, L, "
          f"8192, 16) bf16 from a nonzero h0 at L = 48, 517, 2048; zamba2's "
          f"(1, 517, 5120, 64) in bf16 and f32, from h0 and from zero, (1, "
          f"2048, 5120, 64) bf16, a ragged D = 5001 and an unaligned f32 "
          f"base through the element copies), bitwise at {bitwise} of them: "
          f"max abs err {err:.3g} (S = 64: {err64:.3g})")
    def per_bound(dev_ms, bound):
        return f"{dev_ms / bound:.2f}x" if dev_ms > 0 else "not measured"

    for (L, d, s), (ms, dev_ms, dev_n, plain, bm, by) in timing.items():
        extra = ""
        if s == 64:
            m2, m2_by = m2_bound(1, L, d // Z_HD, Z_HD, s, 2)
            extra = (f"; the mamba2 scan's own bound (one exponential a "
                     f"head) {m2:.4f} ms ({m2_by}; device/that bound "
                     f"{per_bound(dev_ms, m2)})")
        print(f"[B7] (1, {L}, {d}, {s}) bf16: kernel events {ms:.4f} ms per "
              f"call, device {fmt_ms(dev_ms)} per launch (torch.profiler, "
              f"mean of {dev_n} recorded of 20), bound {bm:.4f} ms ({by}; "
              f"device/bound {per_bound(dev_ms, bm)})"
              + ("" if plain is None else f", plain {plain:.1f} ms") + extra)
    sys.stdout.flush()
    torch.cuda.empty_cache()
    ms, _, _, plain, bm, by = timing[(517, 8192, 16)]
    zms, _, _, zplain, zbm, zby = timing[(2048, 5120, 64)]
    return dict(name="mamba_fused", route="cuda",
                source="src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
                replaces="src/repro/kernels/mamba_scan/fused.py:28",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bm, bound_by=by, library_ms=None,
                zamba2=dict(shape="(1, 2048, 5120, 64) bf16 from h0",
                            ms=zms, plain_ms=zplain, bound_ms=zbm,
                            bound_by=zby, library_ms=None))


def phase_fwd_m(dev, params, cfg):
    """falcon-mamba-7b at full width through `lm.forward`, B = 1,
    L = 2048: use_kernel=True through B6, use_kernel=False through B7, one
    launch per layer each, logits agreeing.  Returns B6's launches."""
    import torch

    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import lm

    g = torch.Generator().manual_seed(SEED + 12)
    toks = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g).to(dev)
    outs, counts = {}, {}
    for use_kernel in (True, False):
        ms_ops.reset_launches()
        outs[use_kernel] = lm.forward(params, toks, cfg,
                                      use_kernel=use_kernel).logits
        counts[use_kernel] = dict(ms_ops.LAUNCHES)
    bwd0 = {"mamba_scan_bwd": 0, "mamba_fused_bwd": 0, "mamba_ssd_bwd": 0}
    check(counts[True] == {"mamba_scan": cfg.n_layers, "mamba_fused": 0,
                           **bwd0}
          and counts[False] == {"mamba_scan": 0, "mamba_fused": cfg.n_layers,
                                **bwd0},
          f"forward launched {counts}, expected {cfg.n_layers} of B6 with "
          f"use_kernel and {cfg.n_layers} of B7 without")
    for lg in outs.values():
        check(lg.shape == (1, 2048, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()),
              "forward logits misshapen or non-finite")
    err = rel_l2(outs[True], outs[False])
    check(err <= 1e-2, f"forward through B6 and through B7 differ: relative "
                       f"L2 {err:.3e}")
    del outs
    walls = {uk: wall_ms(lambda: lm.forward(params, toks, cfg,
                                            use_kernel=uk), 2)
             for uk in (True, False)}
    print(f"[fwd-m] {cfg.name} full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, d_inner {cfg.d_inner}, vocab "
          f"{cfg.vocab_size:,}), B=1, L=2048: forward(use_kernel=True) "
          f"{counts[True]['mamba_scan']} B6 launches, wall "
          f"{walls[True]:.1f} ms; forward(use_kernel=False) "
          f"{counts[False]['mamba_fused']} B7 launches, wall "
          f"{walls[False]:.1f} ms ({2048e3 / walls[False]:.0f} tokens/s); "
          f"logits relative L2 {err:.3e} (bound 1e-2)")
    sys.stdout.flush()
    torch.cuda.empty_cache()
    return counts[True]["mamba_scan"]


def phase_serve_mw(dev):
    """falcon-mamba-7b at full width, depth cut to 2 layers: the card (B7)
    against the CPU (plain) on one seeded parameter set.  The card's part
    runs now; the CPU's (with the comparison) is returned as a function,
    for `on_worker`."""
    import dataclasses

    import torch

    import repro_torch.configs as configs
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get("falcon-mamba-7b"), n_layers=2)
    params = lm.make_lm(torch.Generator(device=dev).manual_seed(SEED), cfg)
    cpu_params = _to_cpu(params)
    g = torch.Generator().manual_seed(SEED + 13)
    toks = torch.randint(0, cfg.vocab_size, (1, 300), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (2, 1, 1), generator=g)
    t0 = time.time()

    def run(p, device):
        out = lm.forward(p, toks.to(device), cfg, return_caches=True,
                         cache_len=512)
        seen, st = {"logits prefill": out.logits.cpu()}, out.caches
        for tag in ("prefill", "decode 0", "decode 1"):
            if tag != "prefill":
                lg, st = lm.decode_step(p, steps[int(tag[-1])].to(device), st,
                                        cfg)
                check(lg.shape == (1, 1, cfg.vocab_size)
                      and bool(torch.isfinite(lg).all()),
                      f"full-width logits misshapen or non-finite ({tag})")
                seen[f"logits {tag}"] = lg.cpu()
            seen[f"ssm {tag}"] = st.caches[0].ssm.cpu().clone()
            seen[f"conv {tag}"] = st.caches[0].conv.cpu().clone()
        return seen

    ms_ops.reset_launches()
    on_card = run(params, dev)
    check(ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": 2 * cfg.n_layers,
                              "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                              "mamba_ssd_bwd": 0},
          f"full-width forward + prefill launched {ms_ops.LAUNCHES}")
    t_card = time.time() - t0
    del params
    torch.cuda.empty_cache()

    return functools.partial(
        twin_cpu_side, "[serve-mw]",
        "falcon-mamba-7b full width (d_model 4096, d_inner 8192, state 16, "
        "vocab 65,024), 2 layers: forward + prefill of a 300-token prompt "
        "and 2 decode steps, card (B7, bf16 cuBLAS)", run, cpu_params,
        on_card, t_card, witness=False)


def phase_fwd_z(dev, params, cfg):
    """zamba2-2.7b at full width through `lm.forward`, B = 1,
    L = 2048: one B7 launch a mamba2 layer, one B5 launch an application
    of the shared block, and no B6; the wall, tokens/s and the device's
    busy share.  Returns the launch counts."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import lm

    g = torch.Generator().manual_seed(SEED + 14)
    toks = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g).to(dev)
    n_super = cfg.n_layers // cfg.shared_attn_period
    ms_ops.reset_launches()
    fa_ops.reset_launches()
    logits = lm.forward(params, toks, cfg).logits
    counts = {**ms_ops.LAUNCHES, **fa_ops.LAUNCHES}
    want = launches(mamba_fused=cfg.n_layers, flash_attn=n_super)
    check(counts == want, f"[fwd-z] forward launched {counts}, expected "
                          f"{want}")
    check(logits.shape == (1, 2048, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "[fwd-z] forward logits misshapen or non-finite")
    del logits

    def fwd():
        return lm.forward(params, toks, cfg)

    wall = wall_ms(fwd, 2)
    _, busy, top_dev, _, note = profile_device(fwd, 1)
    print(f"[fwd-z] {cfg.name} full width, {cfg.n_layers} of its "
          f"{configs.get(cfg.name).n_layers} layers ({cfg.n_layers} mamba2 "
          f"layers in {n_super} super-blocks of {cfg.shared_attn_period}, "
          f"the shared block after each; d_model {cfg.d_model}, d_inner "
          f"{cfg.d_inner}, {cfg.d_inner // cfg.ssm_head_dim} ssm heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, attention "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size:,}), B=1, L=2048: {counts['mamba_fused']} B7 and "
          f"{counts['flash_attn']} B5 launches; wall {wall:.1f} ms "
          f"({2048e3 / wall:.0f} tokens/s), device busy {fmt_ms(busy)}{note} "
          f"(torch.profiler), idle share "
          + (f"{1 - busy / wall:.3f}" if busy > 0 else "not measured")
          + f"; top device ops (ms): {fmt_top(top_dev)}")
    sys.stdout.flush()
    torch.cuda.empty_cache()
    return counts


class card_gemms:
    """On the CPU, the card's GEMM forms: `layers.matmul` and
    `layers.unembed` as bf16 products (the CPU's bf16 GEMM, f32 sums in
    its own order, one rounding), in place of the f32 product rounded
    once."""

    def __enter__(self):
        import threading

        import torch

        from repro_torch.models import layers

        # only the entering thread's calls change: a CPU twin runs this on
        # a worker thread while the main thread drives the card
        owner = threading.get_ident()
        self.saved = matmul, unembed = layers.matmul, layers.unembed

        def bf16_matmul(x, w):
            if threading.get_ident() != owner:
                return matmul(x, w)
            return torch.matmul(x, w.to(x.dtype))

        def bf16_unembed(p, x):
            if threading.get_ident() != owner:
                return unembed(p, x)
            return torch.matmul(x, p["table"].to(x.dtype).T).to(torch.float32)

        layers.matmul, layers.unembed = bf16_matmul, bf16_unembed

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.matmul, layers.unembed = self.saved


def hybrid_run(params, toks, steps, cfg, dev) -> tuple[dict, list]:
    """forward + prefill (cache_len 512) and len(steps) decode steps: the
    logits of each and every state field after each, on the CPU; and the
    forward's x after each of its blocks (each mamba2 layer, then the
    shared block, per super-block)."""
    import threading

    from repro_torch.models import lm

    trace, apply_block = [], lm._apply_block
    owner = threading.get_ident()

    def traced(*args, **kwargs):
        x, aux = apply_block(*args, **kwargs)
        if threading.get_ident() == owner:   # not the other thread's blocks
            trace.append(x.float().cpu())
        return x, aux

    lm._apply_block = traced
    try:
        out = lm.forward(params, toks.to(dev), cfg, return_caches=True,
                         cache_len=512)
    finally:
        lm._apply_block = apply_block
    seen = {"logits prefill": out.logits.cpu()}
    st = out.caches

    def fields(tag):
        for j, c in enumerate(st.caches):
            seen[f"ssm{j} {tag}"] = c.ssm.cpu().clone()
            seen[f"conv{j} {tag}"] = c.conv.cpu().clone()
        seen[f"shared k {tag}"] = st.shared_kv.k.cpu().clone()
        seen[f"shared v {tag}"] = st.shared_kv.v.cpu().clone()

    fields("prefill")
    for t, tok in enumerate(steps):
        lg, st = lm.decode_step(params, tok.to(dev), st, cfg)
        seen[f"logits decode {t}"] = lg.cpu()
        fields(f"decode {t}")
    return seen, trace


def phase_serve_zw(dev):
    """zamba2-2.7b at full width, depth cut to one super-block (6 mamba2
    layers, `shared_attn_period` kept at 6, so the shared block runs once):
    the card (B7, B5) against the CPU (plain) on one seeded parameter set.
    Where the card misses 1e-2, each block's distance is printed beside the
    witness, the CPU's own drift between its bf16 GEMMs and its f32 ones,
    and the bound is max(1e-2, 1.5 x that witness).  The card's part runs
    now; the CPU's (with the comparison) is returned as a function, for
    `on_worker`."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get("zamba2-2.7b"), n_layers=6)
    params = lm.make_lm(torch.Generator(device=dev).manual_seed(SEED), cfg)
    cpu_params = _to_cpu(params)
    g = torch.Generator().manual_seed(SEED + 15)
    toks = torch.randint(0, cfg.vocab_size, (1, 300), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (2, 1, 1), generator=g)
    t0 = time.time()
    ms_ops.reset_launches()
    fa_ops.reset_launches()
    on_card, tr_card = hybrid_run(params, toks, steps, cfg, dev)
    # forward and prefill: one B7 a layer and one B5 each; decode neither
    counts = {**ms_ops.LAUNCHES, **fa_ops.LAUNCHES}
    want = launches(mamba_fused=2 * cfg.n_layers, flash_attn=2)
    check(counts == want, f"[serve-zw] forward + prefill + decode launched "
                          f"{counts}, expected {want}")
    for k, v in on_card.items():
        check(bool(torch.isfinite(v.float()).all()),
              f"[serve-zw] non-finite {k} on the card")
    t_card = time.time() - t0
    del params
    torch.cuda.empty_cache()
    traces = []   # the CPU runs' block traces: the plain run, the witness

    def run(p, device):
        seen, trace = hybrid_run(p, toks, steps, cfg, device)
        traces.append(trace)
        return seen

    def per_block(on_cpu, witness):
        # where the card and the CPU part ways, beside the CPU's own drift
        # between its bf16 GEMMs (the card's form) and its f32 ones
        names = [f"mamba2 {i}" for i in range(cfg.n_layers)] + [
            "shared", "logits"]
        logits = "logits prefill"
        for n, c, p, w in zip(names, tr_card + [on_card[logits]],
                              traces[0] + [on_cpu[logits]],
                              traces[1] + [witness[logits]]):
            print(f"[serve-zw] after {n}: card vs CPU {rel_l2(c, p):.3e}, "
                  f"witness (CPU bf16 GEMMs vs f32) {rel_l2(w, p):.3e}")

    return functools.partial(
        twin_cpu_side, "[serve-zw]",
        f"zamba2-2.7b full width (d_model 2560, d_inner 5120, 80 ssm heads "
        f"of 64, state 64, shared block 32/32 heads of 80, d_ff 10240, vocab "
        f"32,000), 6 mamba2 layers + the shared block: forward + prefill of "
        f"a 300-token prompt (chunks 256 + 44) and 2 decode steps, card (B7, "
        f"B5, bf16 cuBLAS; {counts['mamba_fused']} B7 and "
        f"{counts['flash_attn']} B5 launches in forward + prefill)",
        run, cpu_params, on_card, t_card, on_witness=per_block)


def moe_desc(cfg) -> str:
    """A MoE decoder's widths, for the phase lines."""
    shared = (f", a shared expert of {cfg.d_ff * cfg.n_shared_experts}"
              if cfg.n_shared_experts else "")
    every = ("every layer" if cfg.moe_layer_period == 1
             else f"every {cfg.moe_layer_period}nd layer")
    cap = (f", logit cap {cfg.attn_logit_softcap:g}"
           if cfg.attn_logit_softcap else "")
    return (f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
            f"{cfg.head_dim}{cap}, {cfg.n_experts} experts of d_ff "
            f"{cfg.d_ff}, top-{cfg.n_experts_active}{shared}, MoE {every}, "
            f"vocab {cfg.vocab_size:,}")


def param_gb(params) -> float:
    def walk(t):
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        if isinstance(t, list):
            return sum(walk(v) for v in t)
        return t.numel() * t.element_size()
    return walk(params) / 1e9


def phase_fwd_moe(dev, tag, params, cfg):
    """A MoE decoder at full width through `lm.forward`, B = 1, L = 2048:
    one B5 launch a layer (every layer has attention); finite logits;
    each super-block's expert load summing to k (so their mean does); lb
    and zl finite; the router's f32 product with TF32 off; the wall,
    tokens/s and the device's busy share.  Returns the B5 launches."""
    import torch

    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.models import lm, moe

    check(not torch.backends.cuda.matmul.allow_tf32,
          f"{tag} TF32 is on: the MoE router's f32 product would round its "
          f"inputs")
    g = torch.Generator().manual_seed(SEED + 16)
    toks = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g).to(dev)
    groups = moe.n_groups(2048, cfg)
    fa_ops.reset_launches()
    out = lm.forward(params, toks, cfg)
    counts = dict(fa_ops.LAUNCHES)
    check(counts == {"flash_attn": cfg.n_layers, "flash_attn_bwd": 0},
          f"{tag} forward launched {counts}, expected {cfg.n_layers} B5")
    aux = out.aux
    load = float(aux.expert_load.sum())
    check(out.logits.shape == (1, 2048, cfg.vocab_size)
          and bool(torch.isfinite(out.logits).all()),
          f"{tag} forward logits misshapen or non-finite")
    check(aux.expert_load.shape == (cfg.n_experts,)
          and abs(load - cfg.n_experts_active) < 1e-5
          and bool(torch.isfinite(aux.load_balance_loss))
          and bool(torch.isfinite(aux.router_z_loss)),
          f"{tag} aux: expert load sums to {load} (k = "
          f"{cfg.n_experts_active}), lb {float(aux.load_balance_loss)}, zl "
          f"{float(aux.router_z_loss)}")
    del out

    def fwd():
        return lm.forward(params, toks, cfg)

    wall = wall_ms(fwd, 2)
    _, busy, top_dev, _, note = profile_device(fwd, 1)
    print(f"{tag} {cfg.name} full width ({moe_desc(cfg)}), depth cut to "
          f"{cfg.n_layers} layers ({param_gb(params):.1f} GB of bf16 "
          f"weights), B=1, L=2048 ({groups} dispatch group, capacity "
          f"{moe._capacity(2048 // groups, cfg)}): {counts['flash_attn']} B5 "
          f"launches; TF32 off; expert load sums to {load:.6f}, lb "
          f"{float(aux.load_balance_loss):.4f}, zl "
          f"{float(aux.router_z_loss):.4f}; wall {wall:.1f} ms "
          f"({2048e3 / wall:.0f} tokens/s), device busy {fmt_ms(busy)}{note} "
          f"(torch.profiler), idle share "
          + (f"{1 - busy / wall:.3f}" if busy > 0 else "not measured")
          + f"; top device ops (ms): {fmt_top(top_dev)}")
    sys.stdout.flush()
    torch.cuda.empty_cache()
    return counts["flash_attn"]


def moe_run(params, toks, steps, cfg, dev) -> tuple[dict, list]:
    """forward + prefill (cache_len 512) and len(steps) decode steps: the
    logits of each and every K/V cache after each, on the CPU; and the
    routes of every MoE call in order (`moe.Routes` on the CPU)."""
    from repro_torch.models import lm, moe

    routes, route = [], moe._route

    def traced(*args, **kwargs):
        out = route(*args, **kwargs)
        routes.append(moe.Routes(*(x.cpu() for x in out[0])))
        return out

    moe._route = traced
    try:
        out = lm.forward(params, toks.to(dev), cfg, return_caches=True,
                         cache_len=512)
        seen = {"logits prefill": out.logits.cpu()}
        st = out.caches

        def fields(tag):
            for j, c in enumerate(st.caches):
                seen[f"k{j} {tag}"] = c.k.cpu().clone()
                seen[f"v{j} {tag}"] = c.v.cpu().clone()

        fields("prefill")
        for t, tok in enumerate(steps):
            lg, st = lm.decode_step(params, tok.to(dev), st, cfg)
            seen[f"logits decode {t}"] = lg.cpu()
            fields(f"decode {t}")
    finally:
        moe._route = route
    return seen, routes


def route_check(card, cpu, drift):
    """The card's routes against the CPU's, call by call: the expert
    choices that differ, each with the CPU's probability margin between
    the expert it chose and the one the card chose; and the positions,
    equal wherever the choice is equal and no earlier (slot-major) route
    that differs touches that expert.  ``drift`` per call: the witness's
    largest router-probability drift, or None where it was not run.
    Returns (routes, differing choices, positions moved by them, worst
    margin / drift) and fails on a position that differs otherwise or on a
    differing choice whose margin exceeds twice the drift (the gap that
    two probabilities, each moved by the drift, can close)."""
    n = flips = moved = 0
    worst = 0.0
    for i, (c, p) in enumerate(zip(card, cpu)):
        g, t, _ = p.probs.shape
        n += c.expert.numel()
        for gi in range(g):
            ce, pe = c.expert[gi].tolist(), p.expert[gi].tolist()
            cpos, ppos = c.pos[gi].tolist(), p.pos[gi].tolist()
            touched = set()
            for r, (a, b) in enumerate(zip(ce, pe)):
                if a != b:
                    flips += 1
                    touched |= {a, b}
                    tok = r % t
                    margin = float(p.probs[gi, tok, b] - p.probs[gi, tok, a])
                    check(drift[i] is not None and margin <= 2 * drift[i],
                          f"a route differs on the card where the CPU's "
                          f"margin {margin:.3e} is not a near-tie (call {i}, "
                          f"token {tok}; witness drift {drift[i]})")
                    if drift[i] > 0:
                        worst = max(worst, margin / drift[i])
                elif a in touched:
                    moved += cpos[r] != ppos[r]
                else:
                    # keep is pos < cap on both sides
                    check(cpos[r] == ppos[r],
                          f"a capacity position differs on the card with "
                          f"the same choices (call {i}, route {r})")
    return n, flips, moved, worst


def routed_apart(a, b) -> list:
    """The tokens (of group 0) whose routes differ between two runs of one
    MoE call: an expert choice or a keep mask not equal."""
    t = a.probs.shape[1]
    apart = (a.expert[0] != b.expert[0]) | (a.keep[0] != b.keep[0])
    return sorted({r % t for r in apart.nonzero().flatten().tolist()})


def logits_apart(seen, ref, routes, ref_routes):
    """Relative L2 of every field of ``seen`` against ``ref``, the logits
    over the tokens whose routes agree: the model's one MoE layer is its
    last, so a token's logits depend on its own routes alone.  MoE call 0
    is the forward's, call 2 + t decode step t's.  Returns (errs, the
    tokens left out per logits field)."""
    errs, out = {}, {}
    calls = {"logits prefill": 0}
    calls.update({k: 2 + int(k.split()[-1]) for k in ref
                  if k.startswith("logits decode")})
    for k in ref:
        a, b = seen[k], ref[k]
        if k in calls:
            apart = routed_apart(routes[calls[k]], ref_routes[calls[k]])
            keep = [i for i in range(b.shape[1]) if i not in apart]
            out[k] = apart
            if not keep:
                continue
            a, b = a[:, keep], b[:, keep]
        errs[k] = rel_l2(a, b)
    return errs, out


def phase_serve_moe_w(dev, tag, params, cfg):
    """A MoE decoder at full width, cut to one super-block whose MoE layer
    is its last: forward + prefill of a 300-token prompt and 2 decode steps
    on the card (B5) against the same parameters on the CPU (plain).  The
    routes of every MoE call are compared (`route_check`): a differing
    expert choice must be a near-tie.  The logits are held to relative L2
    <= 1e-2 over the tokens whose routes agree (a token that routes apart
    takes other experts' outputs, which no rounding bound covers; the
    route check accounts for it), and every K/V cache over all tokens.
    Where a route differs or the card misses 1e-2, the witness runs: the
    CPU with the card's GEMM forms (bf16 products) against its own f32
    ones; its router drift bounds the differing choices' margins, and on a
    miss the bound becomes max(1e-2, 1.5 x its worst field, measured the
    same way).  The free host memory is printed before the CPU copy."""
    import torch

    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.models import lm

    pattern, n_super = lm.layer_pattern(cfg)
    check(pattern[-1] == "moe" and n_super == 1
          and pattern.count("moe") == 1,
          f"{tag} the comparison needs one super-block ending in its one MoE "
          f"layer, not {pattern} x {n_super}")
    with open("/proc/meminfo") as f:
        mem = {line.split(":")[0]: int(line.split()[1]) / 1e6 for line in f}
    gb = param_gb(params)
    check(mem["MemAvailable"] > 1.2 * gb + 8,
          f"{tag} the host has {mem['MemAvailable']:.1f} GB free, too little "
          f"for a CPU copy of {gb:.1f} GB")
    t0 = time.time()
    cpu_params = _to_cpu(params)
    t_copy = time.time() - t0
    g = torch.Generator().manual_seed(SEED + 17)
    toks = torch.randint(0, cfg.vocab_size, (1, 300), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (2, 1, 1), generator=g)
    t0 = time.time()
    fa_ops.reset_launches()
    on_card, r_card = moe_run(params, toks, steps, cfg, dev)
    # forward and prefill: one B5 a layer each; decode none
    check(fa_ops.LAUNCHES == {"flash_attn": 2 * cfg.n_layers,
                              "flash_attn_bwd": 0},
          f"{tag} forward + prefill + decode launched {fa_ops.LAUNCHES}, "
          f"expected {2 * cfg.n_layers} B5")
    for k, v in on_card.items():
        check(bool(torch.isfinite(v.float()).all()),
              f"{tag} non-finite {k} on the card")
    t_card = time.time() - t0
    n_moe = fa_ops.LAUNCHES["flash_attn"]

    def run(p, device):
        return moe_run(p, toks, steps, cfg, device)

    seen_apart = []   # the tokens left out: card vs CPU, then the witness

    def distance(a, b):   # the logits over the tokens whose routes agree
        errs, apart = logits_apart(a[0], b[0], a[1], b[1])
        seen_apart.append(apart)
        return errs

    def routes_differ(cpu):   # a differing choice calls the witness
        return any(bool((c.expert != p.expert).any())
                   for c, p in zip(r_card, cpu[1]))

    drift = []

    def on_witness(cpu, witness):
        drift.extend(float((w.probs - p.probs).abs().max())
                     for w, p in zip(witness[1], cpu[1]))
        print(f"{tag} witness: tokens routed apart: "
              + ", ".join(f"{k} {v}" for k, v in seen_apart[1].items())
              + "; router probability drift per MoE call: "
              + ", ".join(f"{d:.2e}" for d in drift))

    (on_cpu, r_cpu), _ = twin_cpu_side(
        tag, f"{cfg.name} full width ({moe_desc(cfg)}), {cfg.n_layers} "
        f"layers ({gb:.1f} GB): forward + prefill of a 300-token prompt and "
        f"2 decode steps, card (B5, bf16 cuBLAS; {n_moe} B5 launches), the "
        f"logits over the tokens whose routes agree", run, cpu_params,
        (on_card, r_card), t_card, distance=distance,
        want_witness=routes_differ, on_witness=on_witness)
    apart = seen_apart[0]
    all_rows = {k: rel_l2(on_card[k], on_cpu[k]) for k in apart}
    n, flips, moved, ratio = route_check(r_card, r_cpu,
                                         drift or [None] * len(r_cpu))
    print(f"{tag} tokens routed apart, left out of the logits: "
          + ", ".join(f"{k} {v}" for k, v in apart.items())
          + " (over all tokens: "
          + ", ".join(f"{k} {v:.2e}" for k, v in all_rows.items())
          + f"); routes: {n} over {len(r_cpu)} MoE calls, {flips} expert "
          f"choices differ on the card"
          + (f" (each a near-tie: the CPU's margin at most {ratio:.2f} x the "
             f"witness's drift), {moved} positions moved by them"
             if flips else "")
          + f", every other position and keep mask equal; host free "
          f"{mem['MemAvailable']:.1f} of {mem['MemTotal']:.1f} GB before the "
          f"CPU copy ({t_copy:.1f} s)")
    sys.stdout.flush()
    del cpu_params, on_card, on_cpu
    torch.cuda.empty_cache()

def moe_paths(dev, t_start) -> int:
    """The MoE decoders at full width, depth cut to fit one card: grok-1
    at 4 of its 64 layers, llama4-maverick at one super-block (2 of its 48
    layers); attention through B5, the experts through bf16 cuBLAS; each
    model freed before the next is built.  Returns the B5 launches of the
    forward and serving paths."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.models import lm

    launches = 0
    for arch, n_layers, fwd_tag, w_tag, s_tag in (
            ("grok-1-314b", 4, "[fwd-g]", "[serve-gw]", "[serve-g]"),
            ("llama4-maverick-400b-a17b", 2, "[fwd-l]", "[serve-lw]",
             "[serve-l]")):
        cfg = dataclasses.replace(configs.get(arch), n_layers=n_layers)
        t0 = time.time()
        params = lm.make_lm(torch.Generator(device=dev).manual_seed(SEED),
                            cfg)
        torch.cuda.synchronize()
        t_init = time.time() - t0
        launches += phase_fwd_moe(dev, fwd_tag, params, cfg)
        # card against CPU on the model's first super-block (grok-1: its
        # first layer, 13.1 GB; maverick: the whole 2-layer model)
        period = len(lm.layer_pattern(cfg)[0])
        phase_serve_moe_w(
            dev, w_tag, {**params, "blocks": [[pos[0]] for pos in
                                              params["blocks"]]},
            dataclasses.replace(cfg, n_layers=period))
        launches += serve_main(
            dev, s_tag, cfg, params, t_init,
            [(fa_ops, "flash_attn", "B5", cfg.n_layers)])["B5"]
        del params
        torch.cuda.empty_cache()
        stamp(cfg.name, t_start)
    return launches


# --------------------------------------------------------------------------
# The training path: B5-bwd, llama3.2-3b through lm_loss, AdamW, the two
# step variants, the KF-scheduled loop and checkpoint restart
# --------------------------------------------------------------------------

def flash_bwd_bound(b, h, kv, s, d, causal, window, dtype):
    """Least time of one B5-bwd call: q, k, v, o and dO read once, dq, dk
    and dv written once; 10 * D flops per valid (q, k) pair and query head
    (QK^T, dO V^T, P^T dO, dS^T Q, dS K) at the peak rate of the input
    type (bf16 tensor cores; f32 outside them)."""
    import numpy as np
    import torch

    qp = np.arange(s)[:, None]
    kp = np.arange(s)[None, :]
    valid = np.ones((s, s), bool)
    if causal:
        valid &= qp >= kp
    if window is not None:
        valid &= qp - kp < window
    flops = 10 * d * h * b * int(valid.sum())
    elem = 2 if dtype == torch.bfloat16 else 4
    nbytes = (4 * b * s * h * d + 4 * b * s * kv * d) * elem
    rate = PEAK_BF16_FLOP_S if dtype == torch.bfloat16 else PEAK_F32_FLOP_S
    return bound_ms(nbytes, flops, rate), flops


def library_flash_bwd(q, k, v, do, causal=True):
    """torch's own flash-attention backward (timing only; the port never
    calls it) on the same problem, in its (B, H, S, D) layout with
    K/V repeated to the query heads: a closure running the backward, or
    None (with the reason printed) where this torch build lacks it."""
    import torch

    try:
        rep = q.shape[2] // k.shape[2]
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(rep, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        dot = do.transpose(1, 2).contiguous()
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False)
        out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]

        def run():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, causal, seed,
                offset)

        run()
        torch.cuda.synchronize()
        return run
    except Exception as e:   # timing only: the yardstick may be missing
        print(f"[B5b] no library time: {type(e).__name__}: {e}")
        return None


# B5's log-sum-exp against its plain version: abs + rel (the kernel's
# online max and sum, ex2 / expf, against a dense f32 logsumexp)
LSE_ATOL = 1e-5
LSE_RTOL = 1e-5


def phase_b5b(dev):
    """B5-bwd against its plain version at the models' shapes in bf16 and
    f32 (relative L2 of dq, dk and dv <= 1e-5 in f32, <= 1e-2 in bf16),
    two launches bitwise equal, B5's lse against its plain version and its
    O bitwise the same without lse, and B5-bwd's time at llama3.2-3b's
    training shape (B = 4, S = 2048, bf16) beside the bound, the plain
    version and torch's flash backward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    llama = ("llama3.2-3b", 24, 8, 128)
    cases = [(llama, 1, s, None, None, True) for s in (48, 512, 2048)] + [
        (("h2o-danube-1.8b", 32, 8, 80), 1, 6144, 4096, None, True),
        (("grok-1-314b", 48, 8, 128), 1, 512, None, 30.0, True),
        (("zamba2-2.7b", 32, 32, 80), 1, 512, None, None, True),
        (("llama4-maverick-400b-a17b", 40, 8, 128), 1, 512, None, None,
         True),
        # the training shapes, timed: llama's, and seamless-m4t's encoder
        # (1536 frames, no mask) and decoder (MHA at D = 64)
        (llama, 4, 2048, None, None, True),
        (("seamless-m4t-large-v2 encoder", 16, 16, 64), 4, 1536, None, None,
         False),
        (("seamless-m4t-large-v2 decoder", 16, 16, 64), 4, 2048, None, None,
         True),
    ]
    bounds = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    max_abs = lse_worst = 0.0
    rows = {}
    t0 = time.time()
    for (arch, h, kv, d), b, s, window, cap, causal in cases:
        kw = dict(causal=causal, window=window, logit_cap=cap)
        base = [torch.randn(shape, generator=g, device=dev) for shape in (
            (b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d))]
        for dtype in (torch.bfloat16, torch.float32):
            if b > 1 and dtype == torch.float32:
                continue
            q, k, v, do = (t.to(dtype) for t in base)
            o, lse = fa_kernel.flash_attn(q, k, v, kv_len=None,
                                          with_lse=True, **kw)
            # B5's lse against its plain version, and O bitwise the O of
            # the launch that writes no lse (serving's)
            check(torch.equal(o, fa_kernel.flash_attn(q, k, v, kv_len=None,
                                                      **kw)),
                  f"[B5b] {arch} S={s} {dtype}: B5's O differs with lse "
                  f"asked for")
            _, lse_want = fa_ops.flash_attention_plain(q, k, v,
                                                       return_lse=True, **kw)
            lse_err = (lse - lse_want).abs()
            check(lse.shape == lse_want.shape and bool(
                      (lse_err <= LSE_ATOL + LSE_RTOL * lse_want.abs()).all()),
                  f"[B5b] {arch} S={s} {dtype}: B5's lse off its plain "
                  f"version by {float(lse_err.max()):.3e}")
            lse_worst = max(lse_worst, float(lse_err.max()))
            del lse_want, lse_err
            got = fa_kernel.flash_attn_bwd(q, k, v, o, do, lse, **kw)
            again = fa_kernel.flash_attn_bwd(q, k, v, o, do, lse, **kw)
            want = fa_ops.flash_attention_plain_bwd(q, k, v, o, do, **kw)
            torch.cuda.synchronize()
            for name, x, y, z in zip(("dq", "dk", "dv"), got, again, want):
                check(x.dtype == dtype and x.shape == z.shape
                      and torch.equal(x, y),
                      f"[B5b] {arch} S={s} {dtype} {name}: misshapen, or "
                      f"two launches differ")
                err = rel_l2(x, z)
                check(err <= bounds[dtype],
                      f"[B5b] {arch} S={s} {dtype} {name}: relative L2 "
                      f"{err:.3e} > {bounds[dtype]:g}")
                worst[dtype] = max(worst[dtype], err)
                if dtype == torch.bfloat16:
                    max_abs = max(max_abs,
                                  float((x.float() - z.float()).abs().max()))
            if b == 4:
                reps = 5

                def kern():
                    return fa_kernel.flash_attn_bwd(q, k, v, o, do, lse,
                                                    **kw)

                ms = cuda_ms(kern, reps)
                _, dev_ms, top_dev, _, _ = profile_device(kern, 5, whole=True)
                # each of the call's three kernels, by name
                parts = {part: sum(t for n, t in top_dev if f"bwd_{part}" in n)
                         for part in ("delta", "dkdv", "dq")}
                plain = cuda_ms(lambda: fa_ops.flash_attention_plain_bwd(
                    q, k, v, o, do, **kw), 2, warmup=1)
                lib = library_flash_bwd(q, k, v, do, causal)
                lib_ms = cuda_ms(lib, reps) if lib is not None else None
                del lib
                (bm, by), flops = flash_bwd_bound(b, h, kv, s, d, causal,
                                                  window, dtype)
                row = rows[arch] = dict(
                    ms=ms, dev_ms=dev_ms, plain=plain, lib=lib_ms, bm=bm,
                    by=by, tflops=flops / ms / 1e9, parts=parts,
                    shape=f"({b}, {s}, {h}, {d}), KV {kv}, bf16 "
                          + ("causal" if causal else "no mask"))
                if arch != llama[0]:
                    continue

                # B5's forward at the same shape (a training step's
                # forward and remat recompute, which ask for lse), beside
                # the same call without lse (serving's) and SDPA
                def fwd():
                    return fa_kernel.flash_attn(q, k, v, kv_len=None,
                                                with_lse=True, **kw)

                def fwd_no_lse():
                    return fa_kernel.flash_attn(q, k, v, kv_len=None, **kw)

                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                (fbm, fby), _ = flash_bound(b, h, kv, s, s, d, causal,
                                            window, None, dtype)
                row["fwd"] = dict(
                    ms=cuda_ms(fwd, reps),
                    dev_ms=profile_device(fwd, 3, whole=True)[1],
                    no_lse=cuda_ms(fwd_no_lse, reps),
                    sdpa=cuda_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), reps),
                    bm=fbm, by=fby)
                del qt, kt, vt
            del q, k, v, do, o, lse, got, again, want
        del base
        torch.cuda.empty_cache()
    print(f"[B5b] flash_attn_bwd (delta, then dK/dV and dQ: bf16 on wgmma "
          f"fed by TMA, f32 SIMT; lse from B5's forward) against "
          f"flash_attention_plain_bwd at {len(cases)} shapes "
          f"(llama3.2-3b S = 48, 512, 2048 and B = 4 x S = 2048, "
          f"h2o-danube's 4096 window at S = 6144, grok-1's cap at S = 512, "
          f"zamba2's D = 80, maverick's groups of 5, seamless-m4t's encoder "
          f"(B = 4 x 1536 frames, no mask) and decoder (B = 4 x S = 2048) "
          f"at D = 64): relative L2 worst "
          f"f32 {worst[torch.float32]:.3e} (bound 1e-5), bf16 "
          f"{worst[torch.bfloat16]:.3e} (bound 1e-2); two launches bitwise "
          f"equal at every shape; B5's lse within {LSE_ATOL:g} + "
          f"{LSE_RTOL:g} rel of flash_attention_plain(return_lse=True) "
          f"(max abs err {lse_worst:.3e}) and its O bitwise the same with "
          f"lse and without at every shape; {time.time() - t0:.1f} s")
    for arch, r in rows.items():
        lib = (f"torch flash backward {r['lib']:.3f} ms "
               f"(kernel/library {r['ms'] / r['lib']:.2f}x)"
               if r["lib"] is not None else "no library time")
        parts = "; ".join(f"{k} {fmt_ms(v)}" for k, v in r["parts"].items())
        print(f"[B5b] {arch} training shape {r['shape']}: kernel events "
              f"{r['ms']:.4f} ms per call ({r['tflops']:.1f} TFLOP/s at 10 D "
              f"flops a valid pair), device {fmt_ms(r['dev_ms'])} ({parts}); "
              f"bound {r['bm']:.4f} ms ({r['by']}, 10 D flops a valid pair "
              f"at 989 TFLOP/s; the kernels do 14 D); plain "
              f"{r['plain']:.3f} ms; {lib}")
    row = rows[llama[0]]
    fw = row["fwd"]
    print(f"[B5b] B5's forward at that shape (each layer's forward and its "
          f"remat recompute, lse asked for): events {fw['ms']:.4f} ms per "
          f"call, device {fmt_ms(fw['dev_ms'])}; without lse (serving's "
          f"call) {fw['no_lse']:.4f} ms; bound {fw['bm']:.4f} ms "
          f"({fw['by']}); SDPA {fw['sdpa']:.4f} ms")
    sys.stdout.flush()
    return dict(name="flash_attn_bwd", route="cuda",
                source="src/repro_torch/kernels/flash_attn/csrc/"
                       "flash_attn_bwd_sm90.cu",
                replaces="none: the gradient of src/repro/kernels/"
                         "flash_attn/kernel.py:31's function (the JAX "
                         "package differentiates attend_ref, "
                         "src/repro/models/attention.py:113, with XLA)",
                launches=None, max_abs_err=max_abs, ms=row["ms"],
                plain_ms=row["plain"], bound_ms=row["bm"],
                bound_by=row["by"], library_ms=row["lib"],
                shape=row["shape"], device_ms=row["dev_ms"],
                parts_device_ms=row["parts"],
                **{("seamless_encoder" if "encoder" in arch
                    else "seamless_decoder"): dict(
                    shape=r["shape"], ms=r["ms"], plain_ms=r["plain"],
                    bound_ms=r["bm"], bound_by=r["by"], library_ms=r["lib"],
                    device_ms=r["dev_ms"])
                   for arch, r in rows.items() if arch != llama[0]})


def grad_leaves(params, batch, cfg) -> tuple[float, dict]:
    """The loss and every gradient leaf ({path: tensor on the CPU})."""
    from repro_torch._util import tree_leaves
    from repro_torch.train import step as step_lib

    m, g = step_lib.value_and_grad(step_lib.make_loss_fn(cfg), params,
                                   batch)
    return float(m["loss"]), {p: t.cpu() for p, t in tree_leaves(g)}


def kin(p) -> tuple:
    """A leaf's path with its layer indices blanked: the same parameter of
    every layer."""
    return tuple("*" if isinstance(x, int) else x for x in p)


def train_card_vs_cpu(dev, tag, cfg, seq, want, desc, pool_kin=False,
                      defer=False, mask_ones=False):
    """The loss and every gradient leaf of ``cfg`` at B = 1, S = ``seq``
    (one batch of make_dataset; with ``mask_ones`` its mask set to all
    ones, so that every position counts) on the card (hand-written
    kernels, bf16 cuBLAS, remat "full"), launching exactly ``want``,
    against the same
    parameters on the CPU (plain): loss within 1e-2 relative, each leaf
    within relative L2 1e-2, or where a leaf misses, max(1e-2, 1.5 x the
    CPU's own bf16-against-f32 GEMM witness for that leaf).  With
    ``pool_kin``, a leaf that misses its own witness bound is held to
    max(1e-2, 1.5 x the largest witness of its kin, the same parameter in
    the other layers): a small leaf's relative L2 (zamba2's a_log, 80
    cancelling sums) is one noisy draw of the same drift, which swings
    0.6-1.7x from layer to layer (PERF.md §6).  With ``defer`` the
    card's part runs now and the CPU's part (with the comparison) is
    returned as a function to run later."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.models import encdec, lm

    make = encdec.make_encdec if cfg.is_encoder_decoder else lm.make_lm
    params = make(torch.Generator(device=dev).manual_seed(SEED), cfg)
    cpu_params = _to_cpu(params)
    batch = synthetic.make_dataset(cfg, seq, 1, seed=SEED,
                                   device=dev).batch(0)
    if mask_ones:
        batch["mask"] = torch.ones_like(batch["mask"])
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    t0 = time.time()
    reset_counts()
    loss, grads = grad_leaves(params, batch, cfg)
    check(counts() == want, f"{tag} gradient launched {counts()}, "
                            f"expected {want}")
    t_card = time.time() - t0
    del params, batch
    torch.cuda.empty_cache()
    cpu_side = functools.partial(_train_cpu_side, tag, cfg, seq, want,
                                 desc, pool_kin, cpu_params, cpu_batch, loss,
                                 grads, t_card)
    if defer:
        return cpu_side
    cpu_side()


def _train_cpu_side(tag, cfg, seq, want, desc, pool_kin, cpu_params,
                    cpu_batch, loss, grads, t_card):
    """`train_card_vs_cpu`'s CPU gradient, its witness where a leaf
    misses 1e-2, and the comparison with the card's."""
    t0 = time.time()
    cpu_loss, cpu_grads = grad_leaves(cpu_params, cpu_batch, cfg)
    t_cpu = time.time() - t0
    check(abs(loss - cpu_loss) <= 1e-2 * abs(cpu_loss),
          f"{tag} loss card {loss} vs CPU {cpu_loss}")
    errs = {p: rel_l2(grads[p], cpu_grads[p]) for p in cpu_grads}
    bounds = {p: 1e-2 for p in errs}
    missed = [p for p in errs if errs[p] > 1e-2]
    if missed:
        with card_gemms():
            _, w_grads = grad_leaves(cpu_params, cpu_batch, cfg)
        wit = {p: rel_l2(w_grads[p], cpu_grads[p]) for p in cpu_grads}
        for p in missed:
            bounds[p] = max(1e-2, 1.5 * wit[p])
            pooled = ""
            if pool_kin and errs[p] > bounds[p]:
                w_kin = max(wit[q] for q in wit if kin(q) == kin(p))
                bounds[p] = max(1e-2, 1.5 * w_kin)
                pooled = f", its kin's largest {w_kin:.3e}"
            print(f"{tag} {'/'.join(map(str, p))}: card vs CPU "
                  f"{errs[p]:.3e}, witness (CPU bf16 GEMMs vs f32) "
                  f"{wit[p]:.3e}{pooled}, bound {bounds[p]:.3e}")
    worst = max(errs, key=errs.get)
    bad = {p: errs[p] for p in errs if errs[p] > bounds[p]}
    check(not bad, f"{tag} gradient leaves beyond their bound: {bad}")
    launched = ", ".join(f"{n} {k}" for k, n in want.items() if n)
    print(f"{tag} {desc}, B=1 S={seq} from make_dataset: loss card "
          f"{loss:.6f} vs CPU {cpu_loss:.6f} (rel "
          f"{abs(loss - cpu_loss) / abs(cpu_loss):.2e}, bound 1e-2); "
          f"{len(errs)} gradient leaves, relative L2 worst "
          f"{errs[worst]:.3e} ({'/'.join(map(str, worst))}), "
          f"{len(missed)} beyond 1e-2 held to their witness; card "
          f"{t_card:.1f} s ({launched}), CPU {t_cpu:.1f} s")
    sys.stdout.flush()


def phase_train_w(dev):
    """llama3.2-3b at full width cut to 2 layers, B = 1, S = 256: card (B5,
    B5-bwd) against CPU by `train_card_vs_cpu`'s rule."""
    import repro_torch.configs as configs

    cfg = dataclasses.replace(configs.get("llama3.2-3b"), n_layers=2)
    train_card_vs_cpu(
        dev, "[train-w]", cfg, 256,
        launches(flash_attn=2 * cfg.n_layers, flash_attn_bwd=cfg.n_layers),
        "llama3.2-3b full width (d_model 3072, 24/8 heads, d_ff 8192, vocab "
        "128,256), 2 layers")


def reset_counts() -> None:
    """Every attention and scan kernel's launch count to 0."""
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops

    fa_ops.reset_launches()
    ms_ops.reset_launches()


def counts() -> dict:
    """The attention and scan kernels' launch counts."""
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops

    return {**fa_ops.LAUNCHES, **ms_ops.LAUNCHES}


def launches(**kw) -> dict:
    """A full launch-count dict: the counts named, every other one 0."""
    full = dict.fromkeys(counts(), 0)
    check(set(kw) <= set(full), f"unknown kernel counts {sorted(kw)}")
    return {**full, **kw}


def step_launches(fn, *args):
    """``fn(*args)`` with the attention and scan counters reset before it;
    returns its result, the launch counts and the wall seconds (ending in
    a sync)."""
    import torch

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, counts(), time.time() - t0


TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 10
# falcon-mamba-7b's depth in [train-m] (of 64: 7.27 B parameters at 12
# bytes each are ~87 GB of state), and [train-zw]'s sequence, half of
# [train-w]'s: the CPU's reference scan keeps each doubling step's
# (L, 80, 64, 64) f32 state for autograd (~2 GB a layer at 128 tokens),
# and [serve-zw]'s CPU side alone took 44 s at 300 tokens
TRAIN_M_LAYERS = 16
ZW_SEQ = 128


def phase_train(dev) -> int:
    """llama3.2-3b at full width and all 28 layers (remat "full"), B = 4,
    S = 2048: one step of each variant from the same state and batch
    (losses within 2e-2, the first leaf's parameters within 2e-2, exact
    launch counts), then loop.run with the launcher's KF scheduler for
    TRAIN_STEPS steps (finite losses, the mean of the last two below the
    first, exact launch counts), its wall per step, tokens/s, the device's
    busy share and the peak memory; then the launcher's main on its
    defaults (--size full --steps 2).  Returns the B5 and B5-bwd launches
    of the main path (the loop's run)."""
    import torch

    import repro_torch.configs as configs
    from repro_torch._util import map_tree, tree_leaves
    from repro_torch.data import synthetic
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib

    cfg = configs.get("llama3.2-3b")
    L = cfg.n_layers
    opt_cfg = opt_lib.OptimizerConfig(lr=3e-4, warmup_steps=2,
                                      total_steps=100,
                                      moment_dtype=cfg.optimizer_dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state = step_lib.init_train_state(
        torch.Generator(device=dev).manual_seed(SEED), cfg, opt_cfg)
    params0 = map_tree(torch.clone, state.params)
    ds = synthetic.make_dataset(cfg, TRAIN_S, TRAIN_B, seed=SEED,
                                device=dev)
    batch, _, t_data = step_launches(ds.batch, 0)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    steps = {v: step_lib.make_train_step(cfg, opt_cfg, variant=v)
             for v in (step_lib.BALANCED, step_lib.COMM_PRIORITY)}
    want = {0: launches(flash_attn=2 * L, flash_attn_bwd=L),
            1: launches(flash_attn=4 * L, flash_attn_bwd=2 * L)}
    first = {}
    for v in (step_lib.BALANCED, step_lib.COMM_PRIORITY):
        if v == step_lib.COMM_PRIORITY:   # the same state: step 0's again
            del state
            torch.cuda.empty_cache()
            state = step_lib.TrainState(params0,
                                        opt_lib.init(opt_cfg, params0))
        (state, m), counts, wall = step_launches(steps[v], state, batch)
        check(counts == want[v], f"[train] variant {v} step launched "
                                 f"{counts}, expected {want[v]}")
        leaf = next(tree_leaves(state.params))
        first[v] = (float(m["loss"]), leaf[1].float().cpu(), leaf[0], wall)
    (l0, p0, path, w0), (l1, p1, _, w1) = first[0], first[1]
    check(abs(l0 - l1) <= 2e-2 * abs(l0) and bool(torch.isfinite(
        torch.tensor([l0, l1])).all()),
          f"[train] variant losses {l0} vs {l1}")
    check(bool(((p0 - p1).abs() <= 2e-2 + 2e-2 * p1.abs()).all()),
          f"[train] the variants' first leaf {path} apart: max "
          f"{float((p0 - p1).abs().max())}")
    print(f"[train] llama3.2-3b full width, {L} layers, remat full, "
          f"B={TRAIN_B} S={TRAIN_S}: init {t_init:.1f} s (one batch of "
          f"make_dataset {t_data:.2f} s); one step of each variant from the "
          f"same state: balanced loss {l0:.5f} ({w0:.2f} s, {2 * L} B5 + "
          f"{L} B5-bwd), comm-priority loss {l1:.5f} ({w1:.2f} s, {4 * L} "
          f"B5 + {2 * L} B5-bwd), first leaf {'/'.join(map(str, path))} "
          f"within 2e-2 (max |diff| {float((p0 - p1).abs().max()):.2e})")
    sys.stdout.flush()

    # the loop on the launcher's KF scheduler, from the comm-priority
    # step's state
    sched = launch_train.make_scheduler()
    walls = []
    timed = {v: (lambda f: lambda s, b: _timed(f, s, b, walls))(f)
             for v, f in steps.items()}
    res, counts, wall = step_launches(
        lambda: loop_lib.run(loop_lib.LoopConfig(
            total_steps=TRAIN_STEPS, log_every=0), state, timed, ds.batch,
            sched, log=lambda s: None))
    del state
    n = len(res.losses)
    per_v = {v: res.variants.count(v) for v in (0, 1)}
    want_counts = {k: per_v[0] * want[0][k] + per_v[1] * want[1][k]
                   for k in want[0]}
    check(n == TRAIN_STEPS and all(map(math.isfinite, res.losses)),
          f"[train] loop losses {res.losses}")
    check(sum(res.losses[-2:]) / 2 < res.losses[0],
          f"[train] loss did not fall: {res.losses}")
    check(counts == want_counts, f"[train] loop launched {counts}, "
                                 f"expected {want_counts}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = res.state
    step_s = statistics.median(walls[1:])
    toks = TRAIN_B * TRAIN_S

    extra = ds.batch(TRAIN_STEPS)

    def one():
        return steps[0](state, extra)

    p_wall, busy, top_dev, _, note = profile_device(one, 1)
    print(f"[train] loop.run {n} steps (KF scheduler, launcher settings; "
          f"variants {res.variants}): losses "
          + ", ".join(f"{x:.4f}" for x in res.losses)
          + f"; {counts['flash_attn']} B5 and {counts['flash_attn_bwd']} "
          f"B5-bwd launches ({2 * L} + {L} a balanced step); wall "
          f"{wall:.1f} s, step wall median {step_s:.3f} s ({toks / step_s:.0f}"
          f" tokens/s; the prefetcher draws the next batch on its own "
          f"stream meanwhile); one more step alone, profiled: wall "
          f"{p_wall:.1f} ms ({toks / p_wall * 1e3:.0f} tokens/s), device "
          f"busy {fmt_ms(busy)}{note}, idle share "
          + (f"{max(0.0, 1 - busy / p_wall):.3f}" if busy > 0
             else "not measured")
          + f"; top device ops (ms a step): {fmt_top(top_dev)}; peak device "
          f"memory {peak:.1f} GB (torch.cuda.max_memory_allocated)")
    sys.stdout.flush()
    del state, res, params0, batch, extra
    torch.cuda.empty_cache()

    # the launcher as a user runs it, in-process, on its defaults
    t0 = time.time()
    out = launch_train.main(["--arch", "llama3.2-3b", "--size", "full",
                             "--steps", "2"])
    check(len(out.losses) == 2 and all(map(math.isfinite, out.losses)),
          f"[train] launcher losses {out.losses}")
    print(f"[train] python -m repro_torch.launch.train --arch llama3.2-3b "
          f"--size full --steps 2 (B=8 S=128 defaults), in-process: losses "
          f"{out.losses}, {time.time() - t0:.1f} s")
    del out
    torch.cuda.empty_cache()
    sys.stdout.flush()
    return counts


def _timed(fn, state, batch, walls):
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    out = fn(state, batch)
    torch.cuda.synchronize()
    walls.append(time.time() - t0)
    return out


def phase_train_s(dev):
    """The smoke config as the launcher takes it on the card (heads
    widened to 64, which B5 takes) through loop.run with a checkpoint
    every 4 steps: an uninterrupted run of 10 steps; a run that fails at
    step 6 (SimulatedFailure); the checkpoint restored into a template's
    own tensors, bitwise equal to the state a run of 4 steps holds (bf16
    through its uint16 bits, no ml_dtypes); a run restored from it to
    step 10 whose losses and final state equal the uninterrupted run's
    bit for bit.  Then the launcher on all its defaults."""
    import importlib.util

    import torch

    from repro_torch._util import tree_leaves
    from repro_torch.ckpt import io as ckpt_io
    from repro_torch.data import synthetic
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib

    cfg = launch_train.smoke_config("llama3.2-3b", dev)
    opt_cfg = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                      total_steps=10)

    def fresh():
        return (step_lib.init_train_state(
            torch.Generator(device=dev).manual_seed(SEED), cfg, opt_cfg),
            {0: step_lib.make_train_step(cfg, opt_cfg)},
            synthetic.make_dataset(cfg, 64, 4, seed=SEED, device=dev).batch)

    def run(total, **kw):
        state, steps, make = fresh()
        fail_at = kw.pop("fail_at", None)
        return loop_lib.run(loop_lib.LoopConfig(total_steps=total,
                                                log_every=0, **kw),
                            state, steps, make, fail_at=fail_at,
                            log=lambda s: None)

    t0 = time.time()
    full = run(10)
    four = run(4)
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(ckpt_dir=tmp, ckpt_every=4)
        try:
            run(10, fail_at=6, **kw)
            fail("[train-s] the injected failure did not raise")
        except loop_lib.SimulatedFailure:
            pass
        template = fresh()[0]
        ptrs = [t.data_ptr() for _, t in tree_leaves(template)]
        step, restored = ckpt_io.restore_latest(tmp, template)
        check(restored is template and ptrs == [
            t.data_ptr() for _, t in tree_leaves(restored)],
              "[train-s] the restore did not write into the template")
        with open(os.path.join(tmp, f"step_{step:08d}",
                               "manifest.json")) as f:
            dtypes = {m["dtype"] for m in json.load(f)["arrays"].values()}
        resumed = run(10, **kw)
    check(step == 4 and resumed.restored_from == 4,
          f"[train-s] restored step {step}, resumed from "
          f"{resumed.restored_from}")
    diff = [p for (p, a), (_, b) in zip(tree_leaves(restored),
                                        tree_leaves(four.state))
            if not (a.dtype == b.dtype and a.device == b.device
                    and torch.equal(a, b))]
    check(not diff, f"[train-s] restored state differs from the saved one "
                    f"at {diff[:3]}")
    check("bfloat16" in dtypes, f"[train-s] no bf16 leaf in {dtypes}")
    check(resumed.losses == full.losses[4:],
          f"[train-s] losses after the restore {resumed.losses} differ "
          f"from the uninterrupted run's {full.losses[4:]}")
    diff = [p for (p, a), (_, b) in zip(tree_leaves(resumed.state),
                                        tree_leaves(full.state))
            if not torch.equal(a, b)]
    check(not diff, f"[train-s] final state differs at {diff[:3]}")
    print(f"[train-s] llama3.2-3b smoke ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}) on the card, B=4 S=64: "
          f"checkpoint every 4 steps, SimulatedFailure at step 6, restored "
          f"step 4 into the template's own tensors, bitwise equal to a "
          f"4-step run's state (bf16 stored as uint16 "
          f"bits, manifest dtypes {sorted(dtypes)}, ml_dtypes "
          f"{'present' if importlib.util.find_spec('ml_dtypes') else 'absent'}"
          f"); losses 4..9 after the restore bitwise the uninterrupted "
          f"run's ({', '.join(f'{x:.5f}' for x in resumed.losses)}); final "
          f"state bitwise equal; {time.time() - t0:.1f} s")
    sys.stdout.flush()

    # python -m repro_torch.launch.train, as README gives it for the card
    t0 = time.time()
    out = launch_train.main([])
    check(len(out.losses) == 100 and all(map(math.isfinite, out.losses))
          and out.losses[-1] < out.losses[0],
          f"[train-s] launcher defaults: losses {out.losses[:3]} .. "
          f"{out.losses[-3:]}")
    print(f"[train-s] python -m repro_torch.launch.train on its defaults "
          f"(the smoke config, 100 steps, B=8 S=128), in-process: loss "
          f"{out.losses[0]:.4f} -> {out.losses[-1]:.4f}, "
          f"{time.time() - t0:.1f} s")
    sys.stdout.flush()


def train_paths(dev, t_start, twins=()) -> tuple[dict, int]:
    """[B5b], [train-w], [train], [train-s]; returns B5-bwd's kernels row
    with its launches on the main path ([train]'s loop) and that loop's B5
    launches.  ``twins`` (the serving phases' CPU sides) run one after
    another on a worker thread beside the phases after [B5b], whose steps
    keep the card busy (beside the host-bound serving loops they slowed
    those); [B5b]'s kernel times are taken before, without that host load."""
    b5b = phase_b5b(dev)
    join_twins = on_worker(lambda: [twin() for twin in twins])
    phase_train_w(dev)
    counts = phase_train(dev)
    b5b["launches"] = counts["flash_attn_bwd"]
    phase_train_s(dev)
    stamp("the training path's card work", t_start)
    join_twins()
    stamp("the training path and the serving twins", t_start)
    return b5b, counts["flash_attn"]


# --------------------------------------------------------------------------
# the scans' backward kernels (B6-bwd, B7-bwd) and the SSM training paths
# --------------------------------------------------------------------------

def b7b_bound(b, L, d, s, elem, ghl):
    """Least time of one B7-bwd call: dt, xc, gy (B, L, D), B, C, A, the
    tile checkpoints (and g_hlast) read once, ddt, dxc, dB, dC, dA and dh0
    written once; one exponential per (t, d, s) at the MUFU rate."""
    n = b * L * d * s
    ckpt = b * -(-L // 64) * d * s * 4
    nbytes = (b * L * d * (4 + elem + 4) + 2 * b * L * s * elem + d * s * 4
              + ckpt + (b * d * s * 4 if ghl else 0)
              + b * L * d * (4 + elem) + 2 * b * L * s * elem + d * s * 4
              + b * d * s * 4)
    return bound_ms(nbytes, n, PEAK_EXP_S)


def b6b_bound(b, L, d, s):
    """Least time of one B6-bwd launch: g_hs, a and hs read and da, db
    written once (B*L*D*S floats each), h0 and g_hlast read and dh0 written
    once; 3 flops per element at the f32 rate."""
    n = b * L * d * s
    return bound_ms((5 * n + 3 * b * d * s) * 4, 3 * n, PEAK_F32_FLOP_S)


def m2b_bound(b, L, nh, hd, s, elem, ghl):
    """Least time of one call of B7-bwd's mamba2 form: dt (B, L, nh), xh,
    gy (B, L, nh hd), B, C, a_h, the tile checkpoints (and g_hlast) read
    once, ddt, dxh, dB, dC, da_h and dh0 written once; against ~12 f32
    operations per (t, d, s) (the recurrence recomputed, 3, and walked
    back, ~9) at the f32 rate; its exponentials are one a (t, head)."""
    d = nh * hd
    n = b * L * d * s
    ckpt = b * -(-L // 64) * d * s * 4
    nbytes = (b * L * nh * 4 + b * L * d * (elem + 4) + 2 * b * L * s * elem
              + nh * 4 + ckpt + (b * d * s * 4 if ghl else 0)
              + b * L * nh * 4 + b * L * d * elem + 2 * b * L * s * elem
              + nh * 4 + b * d * s * 4)
    return bound_ms(nbytes, 12 * n, PEAK_F32_FLOP_S)


def phase_b7b(dev):
    """B7-bwd's two forms against their plain versions.  The per-channel
    form (`mamba_fused_bwd` against `fused_mamba_scan_plain_bwd`) at
    falcon-mamba's training shape (4, 2048, 8192, 16) bf16, zamba2's
    channels (4, 2048, 5120, 64) bf16 from a nonzero h0 and g_hlast, a
    ragged L = 517 and an f32 case at S = 8; the mamba2 form
    (`mamba_ssd_bwd` against `fused_ssd_scan_plain_bwd`) at zamba2's shape,
    80 heads of 64 channels, on xc, B, C, A, h0, gy and g_hlast of the
    per-channel case with its own dt, one a head (the per-channel case keeps
    a dt for each channel), and its own checkpoints.  Each gradient
    within relative L2 1e-5 where returned in f32 and 1e-2 in bf16, two
    calls bitwise equal, and B7's y and h_last bitwise the same with the
    tile checkpoints written and without; timed at the training shapes
    (both forms at zamba2's) beside their bounds and the plain versions,
    with B7's forward with and without checkpoints, and the walk's
    registers and blocks an SM.  Returns the per-channel form's kernels row
    and the mamba2 form's."""
    import torch

    from repro_torch.kernels.mamba_scan import fused as ms_fused
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel

    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    f32, bf16 = torch.float32, torch.bfloat16
    occ = {(s, m2): ms_kernel.fused_bwd_occupancy(bf16, s, m2)
           for s, m2 in ((16, False), (64, False), (64, True))}
    cfg = ms_kernel.fused_bwd_config()
    # (label, b, L, d, s, dtype, A's kind, h0 and g_hlast, timed)
    cases = [("falcon-mamba-7b", 4, 2048, 8192, 16, bf16, "falcon", False,
              True),
             ("zamba2-2.7b", 4, 2048, 5120, 64, bf16, "zamba2", True, True),
             ("ragged L", 1, 517, 8192, 16, bf16, "falcon", True, False),
             ("f32 S = 8", 2, 300, 1000, 8, f32, "jax", True, False)]
    names = ("ddt", "dxc", "dB", "dC", "dA", "dh0")
    worst = {f32: 0.0, bf16: 0.0}
    max_abs = {"per-channel": 0.0, "mamba2": 0.0}
    rows, t0 = {}, time.time()

    def held(label, got, again, want, names):
        """checks each gradient; returns the largest abs error"""
        most = 0.0
        for name, x, y, w in zip(names, got, again, want):
            check(x.dtype == w.dtype and x.shape == w.shape
                  and torch.equal(x, y),
                  f"[B7b] {label} {name}: misshapen, or two calls differ")
            err = rel_l2(x, w)
            bound = 1e-2 if x.dtype == bf16 else 1e-5
            check(err <= bound, f"[B7b] {label} {name}: relative L2 "
                                f"{err:.3e} > {bound:g}")
            worst[x.dtype] = max(worst[x.dtype], err)
            most = max(most, float((x.float() - w.float()).abs().max()))
        return most

    def timed(fn, name):
        """events ms a call; device ms a call and the walk's part"""
        ms = cuda_ms(fn, 3)
        _, dev_ms, top_dev, _, _ = profile_device(fn, 3, whole=True)
        walk = sum(t for n, t in top_dev if name in n)
        return ms, dev_ms, walk

    def plain_ms(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1])

    for label, b, L, d, s, dtype, kind, state, timed_case in cases:
        dt, xc, bm, cm, a_mat, h0 = b7_inputs(g, b, L, d, s, dtype, kind,
                                              state)
        gy = torch.randn((b, L, d), generator=g, device=dev)
        ghl = torch.randn((b, d, s), generator=g, device=dev) if state \
            else None
        y0, hl0 = ms_kernel.mamba_fused(dt, xc, bm, cm, a_mat, h0)
        y1, hl1, ckpt = ms_kernel.mamba_fused(dt, xc, bm, cm, a_mat, h0,
                                              checkpoints=True)
        check(torch.equal(y0, y1) and torch.equal(hl0, hl1),
              f"[B7b] {label}: B7's y or h_last differ with checkpoints")
        del y0, hl0, y1, hl1
        got = ms_kernel.mamba_fused_bwd(dt, xc, bm, cm, a_mat, ckpt, gy, ghl)
        again = ms_kernel.mamba_fused_bwd(dt, xc, bm, cm, a_mat, ckpt, gy,
                                          ghl)
        want, p_ms = plain_ms(lambda: ms_fused.fused_mamba_scan_plain_bwd(
            dt, xc, bm, cm, a_mat, h0, gy, ghl))
        max_abs["per-channel"] = max(max_abs["per-channel"],
                                     held(label, got, again, want, names))
        del got, again, want
        row = {}
        if timed_case:
            ms, dev_ms, walk = timed(lambda: ms_kernel.mamba_fused_bwd(
                dt, xc, bm, cm, a_mat, ckpt, gy, ghl), "mamba_fused_bwd")
            fwd = {ck: cuda_ms(lambda: ms_kernel.mamba_fused(
                dt, xc, bm, cm, a_mat, h0, checkpoints=ck), 5)
                for ck in (False, True)}
            bm_, by = b7b_bound(b, L, d, s, 2, state)
            row = dict(shape=(b, L, d, s), ms=ms, dev_ms=dev_ms, walk=walk,
                       plain=p_ms, bm=bm_, by=by, fwd=fwd,
                       ckpt_mb=ckpt.numel() * 4 / 1e6)
        if kind == "zamba2":
            # the mamba2 form: one dt a head, as the SSD scan has it, and the
            # checkpoints of B7's forward on that dt over the head's channels
            del ckpt
            nh = d // Z_HD
            dth = 0.001 + 0.099 * torch.rand((b, L, nh), generator=g,
                                             device=dev)
            a_h = a_mat[::Z_HD, 0].contiguous()
            dtr = dth.repeat_interleave(Z_HD, dim=-1)
            y0, hl0 = ms_kernel.mamba_fused(dtr, xc, bm, cm, a_mat, h0)
            y1, hl1, ckpt = ms_kernel.mamba_fused(dtr, xc, bm, cm, a_mat, h0,
                                                  checkpoints=True)
            check(torch.equal(y0, y1) and torch.equal(hl0, hl1),
                  f"[B7b] {label} mamba2 form: B7's y or h_last differ with "
                  f"checkpoints")
            del y0, hl0, y1, hl1, dtr
            xh, gyh = xc.view(b, L, nh, Z_HD), gy.view(b, L, nh, Z_HD)
            h0h, ghh = (t.view(b, nh, Z_HD, s) for t in (h0, ghl))

            def ssd():
                return ms_kernel.mamba_ssd_bwd(dth, xh, bm, cm, a_h, ckpt,
                                               gyh, ghh)

            got, again = ssd(), ssd()
            want, p2_ms = plain_ms(lambda: ms_fused.fused_ssd_scan_plain_bwd(
                dth, xh, bm, cm, a_h, h0h, gyh, ghh))
            max_abs["mamba2"] = held(f"{label} mamba2 form", got, again, want,
                                     ("ddt", "dxh", "dB", "dC", "da_h", "dh0"))
            del got, again, want
            ms2, dev2, walk2 = timed(ssd, "mamba_fused_bwd")
            bm2, by2 = m2b_bound(b, L, nh, Z_HD, s, 2, state)
            row["ssd"] = dict(ms=ms2, dev_ms=dev2, walk=walk2, plain=p2_ms,
                              bm=bm2, by=by2)
        if row:
            rows[label] = row
        del dt, xc, bm, cm, a_mat, h0, gy, ghl, ckpt
        torch.cuda.empty_cache()
    print(f"[B7b] B7-bwd's per-channel form (mamba_fused_bwd) and mamba2 form"
          f" (mamba_ssd_bwd): the walk back from B7's tile checkpoints, then "
          f"the fixed-order sums of dB, dC and dA (heads: ddt, da_h), against"
          f" their plain versions at {len(cases)} shapes "
          f"({', '.join(c[0] for c in cases)}; the mamba2 form at "
          f"zamba2-2.7b's): relative L2 worst of the gradients f32 "
          f"{worst[f32]:.3e} (bound 1e-5), bf16 {worst[bf16]:.3e} (bound "
          f"1e-2), max abs err {max_abs['per-channel']:.3e} per channel, "
          f"{max_abs['mamba2']:.3e} in the mamba2 form; two calls bitwise "
          f"equal and B7's y and h_last bitwise the same with checkpoints "
          f"and without at every shape; {time.time() - t0:.1f} s")
    print(f"[B7b] instantiation {json.dumps(cfg)}; the walk (bf16, 16-byte "
          f"copies): " + "; ".join(
              f"S = {s}{' mamba2' if m2 else ''}: {o['registers']} registers,"
              f" {o['blocks_per_sm']} blocks an SM, {o['smem_bytes']} bytes "
              f"of shared memory, {o['local_bytes']} local bytes"
              for (s, m2), o in occ.items()))
    for label, r in rows.items():
        print(f"[B7b] {label} {r['shape']} bf16, per-channel form: kernel "
              f"events {r['ms']:.4f} ms per call, device {fmt_ms(r['dev_ms'])}"
              f" (the walk {fmt_ms(r['walk'])}, the sums the rest); bound "
              f"{r['bm']:.4f} ms ({r['by']}); plain {r['plain']:.1f} ms; "
              f"B7's forward {r['fwd'][False]:.4f} ms, with checkpoints "
              f"({r['ckpt_mb']:.0f} MB) {r['fwd'][True]:.4f} ms")
        if "ssd" in r:
            q = r["ssd"]
            print(f"[B7b] {label} {r['shape']} bf16, mamba2 form (80 heads "
                  f"of 64): kernel events {q['ms']:.4f} ms per call, device "
                  f"{fmt_ms(q['dev_ms'])} (the walk {fmt_ms(q['walk'])}); "
                  f"bound {q['bm']:.4f} ms ({q['by']}; the per-channel "
                  f"form's {r['bm']:.4f}); plain {q['plain']:.1f} ms")
    sys.stdout.flush()
    r, z = rows["falcon-mamba-7b"], rows["zamba2-2.7b"]
    src = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan_bwd.cu"
    regs = {f"S{s}{' mamba2' if m2 else ''}": o["registers"]
            for (s, m2), o in occ.items()}
    b7b = dict(name="mamba_fused_bwd", route="cuda", source=src,
               replaces="none: the gradient of src/repro/kernels/"
                        "mamba_scan/fused.py:28's function (the JAX package"
                        " differentiates fused_chunked_scan_m1, src/"
                        "repro/models/mamba.py:89, with XLA)",
               launches=None, max_abs_err=max_abs["per-channel"],
               ms=r["ms"],
               plain_ms=r["plain"], bound_ms=r["bm"], bound_by=r["by"],
               library_ms=None, shape="(4, 2048, 8192, 16) bf16",
               device_ms=r["dev_ms"], registers=regs,
               zamba2=dict(shape="(4, 2048, 5120, 64) bf16 from h0",
                           ms=z["ms"], device_ms=z["dev_ms"],
                           plain_ms=z["plain"], bound_ms=z["bm"],
                           bound_by=z["by"], library_ms=None))
    q = z["ssd"]
    ssd_row = dict(name="mamba_ssd_bwd", route="cuda", source=src,
                   replaces="none: the gradient of the SSD scan (the JAX "
                            "package differentiates fused_chunked_scan_m2, "
                            "src/repro/models/mamba.py:128, with XLA)",
                   launches=None, max_abs_err=max_abs["mamba2"], ms=q["ms"],
                   plain_ms=q["plain"], bound_ms=q["bm"], bound_by=q["by"],
                   library_ms=None,
                   shape="(4, 2048, 80 heads x 64, 64) bf16 from h0",
                   device_ms=q["dev_ms"])
    return b7b, ssd_row


def phase_b6b(dev):
    """B6-bwd bitwise against `scan_ref_bwd` at a small shape and at the
    forward shape (1, 2048, 8192, 16), from a nonzero h0 and g_hlast, two
    launches bitwise equal; timed there beside its bound and the plain
    version.  Returns B6-bwd's kernels row."""
    import torch

    from repro_torch.kernels.mamba_scan import kernel as ms_kernel
    from repro_torch.kernels.mamba_scan.ref import scan_ref_bwd

    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    shapes = [(2, 64, 32, 8), (1, 2048, 8192, 16)]
    for b, L, d, s in shapes:
        a, bb, h0 = scan_inputs(g, b, L, d, s)
        hs, _ = ms_kernel.mamba_scan(a, bb, h0)
        del bb
        g_hs = torch.randn((b, L, d, s), generator=g, device=dev)
        ghl = torch.randn((b, d, s), generator=g, device=dev)
        got = ms_kernel.mamba_scan_bwd(a, hs, h0, g_hs, ghl)
        again = ms_kernel.mamba_scan_bwd(a, hs, h0, g_hs, ghl)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want = scan_ref_bwd(a, hs, h0, g_hs, ghl)
        ev[1].record()
        torch.cuda.synchronize()
        plain = ev[0].elapsed_time(ev[1])
        for name, x, y, w in zip(("da", "db", "dh0"), got, again, want):
            check(torch.equal(x, w) and torch.equal(x, y),
                  f"[B6b] {(b, L, d, s)} {name} differs from its plain "
                  f"version or between two launches")
        del got, again, want
    ms = cuda_ms(lambda: ms_kernel.mamba_scan_bwd(a, hs, h0, g_hs, ghl), 5)
    bm, by = b6b_bound(b, L, d, s)
    gbs = (5 * b * L * d * s + 3 * b * d * s) * 4 / ms / 1e6
    print(f"[B6b] mamba_scan_bwd bitwise equal to scan_ref_bwd at "
          f"{shapes} (nonzero h0 and g_hlast), two launches bitwise equal; "
          f"at {(b, L, d, s)}: kernel {ms:.4f} ms ({gbs:.0f} GB/s), plain "
          f"{plain:.1f} ms, bound {bm:.4f} ms ({by})")
    sys.stdout.flush()
    del a, hs, h0, g_hs, ghl
    torch.cuda.empty_cache()
    return dict(name="mamba_scan_bwd", route="cuda",
                source="src/repro_torch/kernels/mamba_scan/csrc/"
                       "mamba_scan_bwd.cu",
                replaces="none: the gradient of src/repro/kernels/"
                         "mamba_scan/kernel.py:30's function (the JAX package"
                         " differentiates chunked_scan, src/repro/models/"
                         "mamba.py:61, with XLA; its Pallas kernel has no "
                         "VJP)",
                launches=None, max_abs_err=0.0, ms=ms, plain_ms=plain,
                bound_ms=bm, bound_by=by, library_ms=None,
                shape="(1, 2048, 8192, 16)")


SSM_TRAIN_STEPS = 4


def phase_train_ssm(dev, tag, cfg, want0, note, kernel_want=None) -> dict:
    """``cfg`` at full width, remat "full", B = 4, S = 2048, on the
    launcher's optimizer settings: one step of
    each variant from the same state and batch (losses within 2e-2 of each
    other and finite, the first leaf's parameters within 2e-2, exactly
    ``want0`` launches a balanced step and twice that a comm-priority
    step), then loop.run on the launcher's KF scheduler for
    SSM_TRAIN_STEPS steps from the initial state again (made anew from the
    seed: each loss is then on a batch the state has not been trained on;
    finite losses, the last below the first, exact launch counts), its
    wall per step, tokens/s, the device's busy share and the peak memory;
    with ``kernel_want``, then one balanced step with use_kernel=True at
    B = 1 launching exactly that.  Returns the launches of every step it
    took."""
    import torch

    from repro_torch._util import map_tree, tree_leaves
    from repro_torch.data import synthetic
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib

    total = launches()

    def add(c):
        for k, v in c.items():
            total[k] += v

    # the launcher's lr (3e-4) and warmup (100 steps): with [train]'s
    # 2-step warmup a random-init falcon-mamba's loss rose 9.93 -> 13.38
    # within 4 steps (10.72 -> 12.13 at lr 1e-4), zamba2's 9.90 -> 15.71
    opt_cfg = opt_lib.OptimizerConfig(total_steps=100,
                                      moment_dtype=cfg.optimizer_dtype)

    def init():
        return step_lib.init_train_state(
            torch.Generator(device=dev).manual_seed(SEED), cfg, opt_cfg)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state = init()
    n_params = sum(t.numel() for _, t in tree_leaves(state.params))
    params0 = map_tree(torch.clone, state.params)
    ds = synthetic.make_dataset(cfg, TRAIN_S, TRAIN_B, seed=SEED, device=dev)
    batch = ds.batch(0)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    steps = {v: step_lib.make_train_step(cfg, opt_cfg, variant=v)
             for v in (step_lib.BALANCED, step_lib.COMM_PRIORITY)}
    want = {0: want0, 1: {k: 2 * v for k, v in want0.items()}}
    first = {}
    for v in (step_lib.BALANCED, step_lib.COMM_PRIORITY):
        if v == step_lib.COMM_PRIORITY:   # the same state: step 0's again
            del state
            torch.cuda.empty_cache()
            state = step_lib.TrainState(params0,
                                        opt_lib.init(opt_cfg, params0))
        (state, m), c, wall = step_launches(steps[v], state, batch)
        check(c == want[v], f"{tag} variant {v} step launched {c}, "
                            f"expected {want[v]}")
        add(c)
        leaf = next(tree_leaves(state.params))
        first[v] = (float(m["loss"]), leaf[1].float().cpu(), leaf[0], wall)
    (l0, p0, path, w0), (l1, p1, _, w1) = first[0], first[1]
    check(abs(l0 - l1) <= 2e-2 * abs(l0) and all(map(math.isfinite,
                                                      (l0, l1))),
          f"{tag} variant losses {l0} vs {l1}")
    check(bool(((p0 - p1).abs() <= 2e-2 + 2e-2 * p1.abs()).all()),
          f"{tag} the variants' first leaf {path} apart: max "
          f"{float((p0 - p1).abs().max())}")
    per_step = ", ".join(f"{n} {k}" for k, n in want0.items() if n)
    print(f"{tag} {cfg.name} full width, {note}, {n_params / 1e9:.2f} B "
          f"parameters, remat full, B={TRAIN_B} S={TRAIN_S}: init "
          f"{t_init:.1f} s; one step of each variant from the same state: "
          f"balanced loss {l0:.5f} ({w0:.2f} s; {per_step}), comm-priority "
          f"loss {l1:.5f} ({w1:.2f} s, twice the launches), first leaf "
          f"{'/'.join(map(str, path))} within 2e-2 (max |diff| "
          f"{float((p0 - p1).abs().max()):.2e})")
    sys.stdout.flush()

    del state, params0
    torch.cuda.empty_cache()
    state = init()
    sched = launch_train.make_scheduler()
    walls = []
    timed = {v: (lambda f: lambda s, b: _timed(f, s, b, walls))(f)
             for v, f in steps.items()}
    res, c, wall = step_launches(
        lambda: loop_lib.run(loop_lib.LoopConfig(
            total_steps=SSM_TRAIN_STEPS, log_every=0), state, timed,
            ds.batch, sched, log=lambda s: None))
    del state
    n = len(res.losses)
    per_v = {v: res.variants.count(v) for v in (0, 1)}
    want_c = {k: per_v[0] * want[0][k] + per_v[1] * want[1][k]
              for k in want0}
    check(n == SSM_TRAIN_STEPS and all(map(math.isfinite, res.losses)),
          f"{tag} loop losses {res.losses}")
    check(res.losses[-1] < res.losses[0],
          f"{tag} loss did not fall: {res.losses}")
    check(c == want_c, f"{tag} loop launched {c}, expected {want_c}")
    add(c)
    state = res.state
    step_s = statistics.median(walls[1:])
    toks = TRAIN_B * TRAIN_S
    extra = ds.batch(SSM_TRAIN_STEPS)
    reset_counts()
    p_wall, busy, top_dev, _, p_note = profile_device(
        lambda: steps[0](state, extra), 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag} loop.run {n} steps from the initial state (KF "
          f"scheduler; variants "
          f"{res.variants}): losses "
          + ", ".join(f"{x:.4f}" for x in res.losses)
          + f"; launches {c}; wall {wall:.1f} s, step wall median "
          f"{step_s:.3f} s ({toks / step_s:.0f} tokens/s); one more step "
          f"alone, profiled: wall {p_wall:.1f} ms ({toks / p_wall * 1e3:.0f}"
          f" tokens/s), device busy {fmt_ms(busy)}{p_note}, idle share "
          + (f"{max(0.0, 1 - busy / p_wall):.3f}" if busy > 0
             else "not measured")
          + f"; top device ops (ms a step): {fmt_top(top_dev)}; peak device "
          f"memory {peak:.1f} GB (torch.cuda.max_memory_allocated)")
    sys.stdout.flush()
    del res, batch, extra

    if kernel_want is not None:
        one = synthetic.make_dataset(cfg, TRAIN_S, 1, seed=SEED,
                                     device=dev).batch(0)
        step_k = step_lib.make_train_step(cfg, opt_cfg, use_kernel=True)
        (state, m), c, wall = step_launches(step_k, state, one)
        check(c == kernel_want and math.isfinite(float(m["loss"])),
              f"{tag} use_kernel step launched {c} (expected "
              f"{kernel_want}), loss {float(m['loss'])}")
        add(c)
        print(f"{tag} one balanced step with use_kernel=True at B=1 "
              f"S={TRAIN_S}: loss {float(m['loss']):.5f}, "
              + ", ".join(f"{n} {k}" for k, n in kernel_want.items() if n)
              + f", {wall:.2f} s")
        sys.stdout.flush()
    del state
    torch.cuda.empty_cache()
    return total


def ssm_train_paths(dev, t_start) -> tuple:
    """[B7b], [B6b], [train-mw], [train-zw], [train-m], [train-z]; returns
    the kernels rows of B7-bwd's per-channel form, its mamba2 form and
    B6-bwd, their launches counted on the training paths, every launch
    of the [train-m] / [train-z] steps, and the join of the twins' worker
    (their CPU sides outlast [train-z]: the encoder-decoder's phases run
    beside their tail).
    [B7b] and [B6b] run first, with no host work beside their times; then
    [train-mw]'s and [train-zw]'s card sides; their CPU sides (their CPU
    gradients and witnesses, ~60-100 s of host work) then run on a worker
    thread while the card takes [train-m] and [train-z]'s steps; a failure
    on either side fails the script (the thread is a daemon, so a failing
    main thread does not wait for it)."""
    import repro_torch.configs as configs

    b7b, ssd = phase_b7b(dev)
    b6b = phase_b6b(dev)
    fm, zb = configs.get("falcon-mamba-7b"), configs.get("zamba2-2.7b")
    cfg = dataclasses.replace(fm, n_layers=2)
    cpu_sides = [train_card_vs_cpu(
        dev, "[train-mw]", cfg, 256,
        launches(mamba_fused=2 * cfg.n_layers, mamba_fused_bwd=cfg.n_layers),
        "falcon-mamba-7b full width (d_model 4096, d_inner 8192, state 16, "
        "vocab 65,024), 2 layers", pool_kin=True, defer=True)]
    p = zb.shared_attn_period
    cfg = dataclasses.replace(zb, n_layers=p)
    cpu_sides.append(train_card_vs_cpu(
        dev, "[train-zw]", cfg, ZW_SEQ,
        launches(mamba_fused=2 * p, mamba_ssd_bwd=p, flash_attn=2,
                 flash_attn_bwd=1),
        f"zamba2-2.7b full width (d_model 2560, d_inner 5120, state 64, "
        f"32/32 heads of 80, vocab 32,000), one super-block ({p} mamba2 "
        f"layers and the shared block)", pool_kin=True, defer=True))
    join_twins = on_worker(lambda: [side() for side in cpu_sides])
    stamp("the SSM kernels and the card sides of [train-mw] / [train-zw]",
          t_start)
    cfg = dataclasses.replace(fm, n_layers=TRAIN_M_LAYERS)
    total = phase_train_ssm(
        dev, "[train-m]", cfg,
        launches(mamba_fused=2 * TRAIN_M_LAYERS,
                 mamba_fused_bwd=TRAIN_M_LAYERS),
        f"{TRAIN_M_LAYERS} of its {fm.n_layers} layers (all 64: ~87 GB of "
        f"state, more than one card holds)",
        kernel_want=launches(mamba_scan=2 * TRAIN_M_LAYERS,
                             mamba_scan_bwd=TRAIN_M_LAYERS))
    n_super = zb.n_layers // p
    z = phase_train_ssm(
        dev, "[train-z]", zb,
        launches(mamba_fused=2 * zb.n_layers, mamba_ssd_bwd=zb.n_layers,
                 flash_attn=2 * n_super, flash_attn_bwd=n_super),
        f"all {zb.n_layers} layers ({n_super} super-blocks of {p} mamba2 "
        f"layers and the shared block)")
    for k, v in z.items():
        total[k] += v
    stamp("[train-m] and [train-z]", t_start)
    b7b["launches"] = total["mamba_fused_bwd"]
    ssd["launches"] = total["mamba_ssd_bwd"]
    b6b["launches"] = total["mamba_scan_bwd"]
    return b7b, ssd, b6b, total, join_twins


# --------------------------------------------------------------------------
# the encoder-decoder (seamless-m4t-large-v2) and the vision prefix
# (internvl2-2b): B5 with no mask in the encoder, cross-attention plain
# --------------------------------------------------------------------------

# [serve-e]'s batch of utterances, its cache and its greedy steps (16:
# a step is host-bound, ~125 ms, and 64 took 8.0 s of the script's time);
# [serve-v]'s prompts (256 image patches + 256 text tokens) and steps
SERVE_E_B, SERVE_E_LEN, SERVE_E_STEPS = 8, 256, 16
SERVE_V_B, SERVE_V_TEXT, SERVE_V_STEPS = 8, 256, 32
# [train-e]'s loop steps (a batch at vocab 256,206 takes ~2x llama's to
# draw, and paces the loop at ~5.5-6.7 s a step)
TRAIN_E_STEPS = 3


def n_params(params) -> int:
    from repro_torch._util import tree_leaves

    return sum(t.numel() for _, t in tree_leaves(params))


def twin_cpu_side(tag, desc, run, cpu_params, on_card, t_card, *,
                  witness=True, distance=None, want_witness=None,
                  on_witness=None):
    """A serving twin's CPU run (``run(cpu_params, "cpu")``: {field:
    tensor on the CPU}) against the card's output ``on_card``: relative L2
    per field within 1e-2 (``distance(on_card, on_cpu)`` gives the
    {field: distance} when the run's output is not such a dict).  With
    ``witness``, where the card misses (or where ``want_witness(on_cpu)``
    asks), the witness runs: the same run under the card's GEMM forms (the
    CPU's bf16 products against its f32 ones), measured the same way over
    the same fields; on a miss the bound becomes max(1e-2, 1.5 x its worst
    field), and ``on_witness(on_cpu, witness_out)`` prints more about it.
    Without ``witness`` the bound stays a flat 1e-2.  Returns (on_cpu,
    witness_out or None)."""
    import threading

    def rel(a, b):
        return {k: rel_l2(a[k], b[k]) for k in b}

    distance = distance or rel
    t1 = time.time()
    on_cpu = run(cpu_params, "cpu")
    t_cpu = time.time() - t1
    errs = distance(on_card, on_cpu)
    worst = max(errs, key=errs.get)
    bound = 1e-2
    missed = errs[worst] > bound
    w_out = None
    if witness and (missed or (want_witness and want_witness(on_cpu))):
        t1 = time.time()
        with card_gemms():
            w_out = run(cpu_params, "cpu")
        w_errs = distance(w_out, on_cpu)
        w_worst = max(w_errs, key=w_errs.get)
        if missed:
            bound = max(bound, 1.5 * w_errs[w_worst])
        print(f"{tag} witness (CPU bf16 GEMMs vs f32, {time.time() - t1:.1f} "
              f"s) over the same fields: worst {w_errs[w_worst]:.3e} "
              f"({w_worst}); bound max(1e-2, 1.5 x witness) on a miss, now "
              f"{bound:.3e}; all: "
              + ", ".join(f"{k} {v:.2e}" for k, v in w_errs.items()))
        if on_witness:
            on_witness(on_cpu, w_out)
    check(errs[worst] <= bound, f"{tag} card and CPU differ: worst "
                                f"{errs[worst]:.3e} ({worst}) > {bound:.3e}")
    where = ("" if threading.current_thread() is threading.main_thread()
             else " (on the worker thread)")
    print(f"{tag} {desc}: card vs CPU (plain) relative L2 worst "
          f"{errs[worst]:.3e} ({worst}; bound {bound:.3e}), all: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; card {t_card:.1f} s, CPU {t_cpu:.1f} s{where}")
    sys.stdout.flush()
    return on_cpu, w_out


def profiled(fn, what: str, tokens: int) -> str:
    """``fn`` timed alone (wall over 2 calls ending in a sync) and profiled
    once: its wall, tokens/s, device busy time and idle share, top device
    ops, as a phrase."""
    wall = wall_ms(fn, 2)
    _, busy, top_dev, _, note = profile_device(fn, 1)
    return (f"{what}: wall {wall:.1f} ms ({tokens * 1e3 / wall:.0f} "
            f"tokens/s), device busy {fmt_ms(busy)}{note}, idle share "
            + (f"{max(0.0, 1 - busy / wall):.3f}" if busy > 0
               else "not measured")
            + f"; top device ops (ms): {fmt_top(top_dev)}")


def phase_fwd_e(dev, params, cfg) -> int:
    """seamless-m4t-large-v2 whole: `encdec.encode` of 1536 frames at B = 1
    and B = 8 (exactly 24 B5 launches each, no mask) and `encdec.forward`
    at B = 1, S = 2048 (48: the encoder's 24 and the decoder's 24 causal;
    cross-attention is plain), finite outputs of the right shape; each
    one's wall, tokens/s and busy share.  Returns the B5 launches."""
    import torch

    from repro_torch.models import encdec

    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    f, fd = cfg.frontend_len, cfg.frontend_dim
    total = 0
    lines = []
    for b in (1, 8):
        emb = torch.randn((b, f, fd), generator=g, device=dev)
        out, c, _ = step_launches(encdec.encode, params, emb, cfg)
        check(c == launches(flash_attn=cfg.n_encoder_layers),
              f"[fwd-e] encode B={b} launched {c}")
        check(out.shape == (b, f, cfg.d_model)
              and bool(torch.isfinite(out).all()),
              f"[fwd-e] encode B={b} output misshapen or non-finite")
        total += c["flash_attn"]
        lines.append(profiled(lambda: encdec.encode(params, emb, cfg),
                              f"encode B={b} x {f} frames", b * f))
    toks = torch.randint(0, cfg.vocab_size, (1, TRAIN_S), generator=g,
                         device=dev)
    emb = torch.randn((1, f, fd), generator=g, device=dev)
    logits, c, _ = step_launches(encdec.forward, params, toks, emb, cfg)
    want = launches(flash_attn=cfg.n_encoder_layers + cfg.n_layers)
    check(c == want, f"[fwd-e] forward launched {c}, expected {want}")
    check(logits.shape == (1, TRAIN_S, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "[fwd-e] forward logits misshapen or non-finite")
    total += c["flash_attn"]
    del logits
    lines.append(profiled(lambda: encdec.forward(params, toks, emb, cfg),
                          f"forward B=1 S={TRAIN_S} (+ {f} frames)",
                          TRAIN_S))
    print(f"[fwd-e] {cfg.name} full width, {cfg.n_encoder_layers} + "
          f"{cfg.n_layers} layers (d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size:,}, frames of {fd}), "
          f"{n_params(params) / 1e9:.3f} B parameters: "
          f"{cfg.n_encoder_layers} B5 launches an encode (no mask), "
          f"{want['flash_attn']} a forward; " + "; ".join(lines))
    sys.stdout.flush()
    torch.cuda.empty_cache()
    return total


def phase_serve_e(dev, params, cfg) -> int:
    """seamless's serving path: `init_encdec_state` for SERVE_E_B
    utterances of 1536 frames (exactly 24 B5 launches: the encoder), then
    SERVE_E_STEPS greedy `decode_step`s (no B5 launch: the self-attention
    cache and the cross-attention are plain), every logit finite; the
    walls, a decode step timed alone and profiled.  Returns the B5
    launches."""
    import torch

    from repro_torch.models import encdec

    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    emb = torch.randn((SERVE_E_B, cfg.frontend_len, cfg.frontend_dim),
                      generator=g, device=dev)
    st, c, t_init = step_launches(encdec.init_encdec_state, params, emb, cfg,
                                  SERVE_E_LEN)
    check(c == launches(flash_attn=cfg.n_encoder_layers),
          f"[serve-e] init_encdec_state launched {c}")
    cross_gb = 2 * st.cross_k.numel() * st.cross_k.element_size() / 1e9
    tok = torch.zeros((SERVE_E_B, 1), dtype=torch.int32, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def greedy():
        nonlocal st, tok, finite
        for _ in range(SERVE_E_STEPS):
            lg, st = encdec.decode_step(params, tok, st, cfg)
            finite = finite & torch.isfinite(lg).all()
            tok = lg[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)

    _, c, t_dec = step_launches(greedy)
    check(c == launches(), f"[serve-e] decode steps launched {c}")
    check(bool(finite) and st.self_kv.length.eq(SERVE_E_STEPS).all().item()
          and st.length.eq(SERVE_E_STEPS).all().item(),
          "[serve-e] non-finite logits or wrong lengths")
    step = profiled(lambda: encdec.decode_step(params, tok, st, cfg),
                    f"one decode step alone (B={SERVE_E_B})", SERVE_E_B)
    print(f"[serve-e] {cfg.name}: init_encdec_state of {SERVE_E_B} "
          f"utterances x {cfg.frontend_len} frames (the encoder through B5, "
          f"{cfg.n_encoder_layers} launches; cross K/V "
          f"{tuple(st.cross_k.shape)} x 2 in bf16, {cross_gb:.2f} GB) "
          f"{t_init:.2f} s, then {SERVE_E_STEPS} greedy decode steps (max_len "
          f"{SERVE_E_LEN}; no B5 launch; every logit finite) {t_dec:.2f} s "
          f"({t_dec / SERVE_E_STEPS * 1e3:.1f} ms a step, "
          f"{SERVE_E_B * SERVE_E_STEPS / t_dec:.0f} tokens/s); {step}")
    sys.stdout.flush()
    del st
    torch.cuda.empty_cache()
    return cfg.n_encoder_layers


def phase_serve_ew(dev, cfg_full):
    """seamless at full width cut to 2 + 2 layers: the encoder output,
    init_encdec_state's cross K/V, and the logits and self K/V of 2
    decode steps, card (B5) against CPU (plain) on one seeded parameter
    set, by `twin_cpu_side`'s rule.  The card's part runs now; the CPU's
    is returned, for `on_worker`."""
    import torch

    from repro_torch.models import encdec

    cfg = dataclasses.replace(cfg_full, n_layers=2, n_encoder_layers=2)
    params = encdec.make_encdec(torch.Generator(device=dev).manual_seed(SEED),
                                cfg)
    cpu_params = _to_cpu(params)
    g = torch.Generator().manual_seed(SEED + 32)
    emb = torch.randn((1, cfg.frontend_len, cfg.frontend_dim), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (2, 1, 1), generator=g)

    def run(p, device):
        seen = {"encoder out": encdec.encode(p, emb.to(device), cfg).cpu()}
        st = encdec.init_encdec_state(p, emb.to(device), cfg, 16)
        seen["cross K"], seen["cross V"] = st.cross_k.cpu(), st.cross_v.cpu()
        for t in range(2):
            lg, st = encdec.decode_step(p, steps[t].to(device), st, cfg)
            seen[f"logits decode {t}"] = lg.cpu()
            seen[f"self K decode {t}"] = st.self_kv.k.cpu().clone()
            seen[f"self V decode {t}"] = st.self_kv.v.cpu().clone()
        return seen

    t0 = time.time()
    on_card, c, _ = step_launches(run, params, dev)
    check(c == launches(flash_attn=2 * cfg.n_encoder_layers),
          f"[serve-ew] launched {c}")
    for k, v in on_card.items():
        check(bool(torch.isfinite(v.float()).all()),
              f"[serve-ew] non-finite {k} on the card")
    t_card = time.time() - t0
    del params
    torch.cuda.empty_cache()
    return functools.partial(
        twin_cpu_side, "[serve-ew]",
        f"{cfg.name} full width (d_model {cfg.d_model}, 16/16 heads of 64, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size:,}), 2 + 2 layers: encode "
        f"{cfg.frontend_len} frames, init_encdec_state and 2 decode steps",
        run, cpu_params, on_card, t_card)


def phase_fwd_v(dev, params, cfg) -> int:
    """internvl2-2b whole through `lm.forward` at B = 1, L = 2048 with 256
    projected patches of width 1024 spliced over the first positions:
    exactly 24 B5 launches, finite logits, the prefix moving them; the
    wall, tokens/s and busy share.  Returns the B5 launches."""
    import torch

    from repro_torch.models import lm

    g = torch.Generator(device=dev).manual_seed(SEED + 33)
    toks = torch.randint(0, cfg.vocab_size, (1, TRAIN_S), generator=g,
                         device=dev)
    emb = torch.randn((1, cfg.frontend_len, cfg.frontend_dim), generator=g,
                      device=dev)
    out, c, _ = step_launches(lambda: lm.forward(params, toks, cfg,
                                                 embeds=emb))
    check(c == launches(flash_attn=cfg.n_layers),
          f"[fwd-v] forward launched {c}")
    check(out.logits.shape == (1, TRAIN_S, cfg.vocab_size)
          and bool(torch.isfinite(out.logits).all()),
          "[fwd-v] logits misshapen or non-finite")
    moved = rel_l2(out.logits, lm.forward(params, toks, cfg).logits)
    check(moved > 1e-2, f"[fwd-v] the image prefix moved the logits by "
                        f"only {moved:.2e}")
    del out
    line = profiled(lambda: lm.forward(params, toks, cfg, embeds=emb),
                    f"forward B=1 L={TRAIN_S}", TRAIN_S)
    print(f"[fwd-v] {cfg.name} full width, {cfg.n_layers} layers (d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size:,}; "
          f"projector layernorm + 2-layer GELU MLP from {cfg.frontend_dim}), "
          f"{n_params(params) / 1e9:.3f} B parameters: {cfg.frontend_len} "
          f"projected patches spliced in (the logits move by {moved:.2f} "
          f"relative L2 against the bare tokens); {c['flash_attn']} B5 "
          f"launches; {line}")
    sys.stdout.flush()
    torch.cuda.empty_cache()
    return c["flash_attn"]


def phase_serve_v(dev, params, cfg) -> int:
    """internvl2's serving path: `prefill_caches(..., embeds=...)` of
    SERVE_V_B prompts (256 image patches + SERVE_V_TEXT text tokens;
    exactly 24 B5 launches), then SERVE_V_STEPS greedy decode steps (no
    B5 launch), every logit finite; the prefill and a decode step timed
    alone and profiled.  Returns the B5 launches."""
    import torch

    from repro_torch.models import lm

    g = torch.Generator(device=dev).manual_seed(SEED + 34)
    s = cfg.frontend_len + SERVE_V_TEXT
    toks = torch.randint(0, cfg.vocab_size, (SERVE_V_B, s), generator=g,
                         device=dev)
    emb = torch.randn((SERVE_V_B, cfg.frontend_len, cfg.frontend_dim),
                      generator=g, device=dev)
    max_len = s + SERVE_V_STEPS
    st, c, t_pre = step_launches(lambda: lm.prefill_caches(
        params, toks, cfg, max_len, embeds=emb))
    check(c == launches(flash_attn=cfg.n_layers),
          f"[serve-v] prefill launched {c}")
    tok = toks[:, -1:]
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def greedy():
        nonlocal st, tok, finite
        for _ in range(SERVE_V_STEPS):
            lg, st = lm.decode_step(params, tok, st, cfg)
            finite = finite & torch.isfinite(lg).all()
            tok = lg[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)

    _, c, t_dec = step_launches(greedy)
    check(c == launches(), f"[serve-v] decode steps launched {c}")
    check(bool(finite) and st.length.eq(s + SERVE_V_STEPS).all().item(),
          "[serve-v] non-finite logits or wrong lengths")
    pre = profiled(lambda: lm.prefill_caches(params, toks, cfg, max_len,
                                             embeds=emb),
                   f"a prefill alone", SERVE_V_B * s)
    step = profiled(lambda: lm.decode_step(params, tok, st, cfg),
                    f"one decode step alone (B={SERVE_V_B})", SERVE_V_B)
    print(f"[serve-v] {cfg.name}: prefill_caches of {SERVE_V_B} prompts "
          f"({cfg.frontend_len} image patches + {SERVE_V_TEXT} text tokens, "
          f"{cfg.n_layers} B5 launches) {t_pre:.2f} s, then {SERVE_V_STEPS} "
          f"greedy decode steps (no B5 launch; every logit finite) "
          f"{t_dec:.2f} s ({t_dec / SERVE_V_STEPS * 1e3:.1f} ms a step); "
          f"{pre}; {step}")
    sys.stdout.flush()
    del st
    torch.cuda.empty_cache()
    return cfg.n_layers


def phase_serve_vw(dev, cfg_full):
    """internvl2 at full width cut to 2 layers: forward + prefill of a
    300-token prompt (256 patches spliced in) and 2 decode steps, card
    (B5) against CPU (plain) by `twin_cpu_side`'s rule.  The card's part
    runs now; the CPU's is returned, for `on_worker`."""
    import torch

    from repro_torch.models import lm

    cfg = dataclasses.replace(cfg_full, n_layers=2)
    params = lm.make_lm(torch.Generator(device=dev).manual_seed(SEED), cfg)
    cpu_params = _to_cpu(params)
    g = torch.Generator().manual_seed(SEED + 35)
    toks = torch.randint(0, cfg.vocab_size, (1, 300), generator=g)
    emb = torch.randn((1, cfg.frontend_len, cfg.frontend_dim), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (2, 1, 1), generator=g)

    def run(p, device):
        out = lm.forward(p, toks.to(device), cfg, embeds=emb.to(device),
                         return_caches=True, cache_len=512)
        seen = {"logits prefill": out.logits.cpu()}
        st = out.caches
        for t in range(3):
            if t:
                lg, st = lm.decode_step(p, steps[t - 1].to(device), st, cfg)
                seen[f"logits decode {t - 1}"] = lg.cpu()
            tag = f"decode {t - 1}" if t else "prefill"
            seen[f"K {tag}"] = st.caches[0].k.cpu().clone()
            seen[f"V {tag}"] = st.caches[0].v.cpu().clone()
        return seen

    t0 = time.time()
    on_card, c, _ = step_launches(run, params, dev)
    check(c == launches(flash_attn=2 * cfg.n_layers),
          f"[serve-vw] launched {c}")
    t_card = time.time() - t0
    del params
    torch.cuda.empty_cache()
    return functools.partial(
        twin_cpu_side, "[serve-vw]",
        f"{cfg.name} full width (d_model {cfg.d_model}, 16/8 heads of 128, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size:,}), 2 layers: forward + "
        f"prefill of 300 tokens with {cfg.frontend_len} patches spliced in "
        f"and 2 decode steps", run, cpu_params, on_card, t_card)


def cross_attention_ms(dev, cfg) -> tuple[float, float, float]:
    """The decoder's plain cross-attention (`attention.attend_ref` with no
    mask) at [train-e]'s shape, B = 4, S = 2048 queries over F = 1536
    frames, timed alone with CUDA events: its forward, its forward and
    backward, and the step's share, a layer's forward, remat recompute
    and backward times the decoder's layers (ms)."""
    import torch

    from repro_torch.models import attention

    g = torch.Generator(device=dev).manual_seed(SEED + 36)
    h, d = cfg.n_heads, cfg.head_dim
    q, k, v = (torch.randn((TRAIN_B, s, h, d), generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
               for s in (TRAIN_S, cfg.frontend_len, cfg.frontend_len))
    do = torch.randn(q.shape, generator=g, device=dev, dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            return attention.attend_ref(q, k, v, causal=False)

    def fwd_bwd():
        attention.attend_ref(q, k, v, causal=False).backward(do)

    f, fb = cuda_ms(fwd, 3), cuda_ms(fwd_bwd, 3)
    del q, k, v, do
    torch.cuda.empty_cache()
    return f, fb, cfg.n_layers * (f + fb)


def phase_train_e(dev, cfg) -> dict:
    """seamless-m4t-large-v2 whole, remat "full", B = 4, S = 2048 decoder
    tokens, F = 1536 frames, on the launcher's optimizer settings
    (`phase_train_ssm`'s): loop.run on the launcher's KF scheduler for
    TRAIN_E_STEPS balanced steps from the initial state (finite losses;
    exactly 2 B5 launches a layer a step, forward and remat recompute, and
    one B5-bwd; cross-attention is plain), each step's wall, a step alone
    profiled, the peak memory; then batch 0's loss on the trained state
    below its loss at init, the loop's first (the loop's own losses are on
    different batches, whose spread at this lr can hide the fall).  The
    loop is handed batch 0 as drawn for the init line (a batch is a
    function of (seed, step)), so that its vocab-256k synthesis runs
    once.  Returns the launches of every step it took."""
    import torch

    from repro_torch._util import tree_leaves
    from repro_torch.data import synthetic
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib

    n = cfg.n_layers + cfg.n_encoder_layers
    want = launches(flash_attn=2 * n, flash_attn_bwd=n)
    opt_cfg = opt_lib.OptimizerConfig(total_steps=100,
                                      moment_dtype=cfg.optimizer_dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state = step_lib.init_train_state(
        torch.Generator(device=dev).manual_seed(SEED), cfg, opt_cfg)
    n_params = sum(t.numel() for _, t in tree_leaves(state.params))
    ds = synthetic.make_dataset(cfg, TRAIN_S, TRAIN_B, seed=SEED, device=dev)
    batch, _, t_data = step_launches(ds.batch, 0)
    t_init = time.time() - t0
    step = step_lib.make_train_step(cfg, opt_cfg)
    walls = []
    res, c, wall = step_launches(
        lambda: loop_lib.run(
            loop_lib.LoopConfig(total_steps=TRAIN_E_STEPS, log_every=0),
            state, {0: lambda s, b: _timed(step, s, b, walls)},
            lambda i: batch if i == 0 else ds.batch(i),
            launch_train.make_scheduler(), log=lambda s: None))
    del state
    want_c = {k: TRAIN_E_STEPS * v for k, v in want.items()}
    check(len(res.losses) == TRAIN_E_STEPS
          and all(map(math.isfinite, res.losses)) and c == want_c,
          f"[train-e] loop losses {res.losses}, launched {c} (expected "
          f"{want_c})")
    total, l0 = c, res.losses[0]
    state = res.state
    with torch.no_grad():
        again = float(step_lib.make_loss_fn(cfg)(state.params, batch)[0])
    check(again < l0, f"[train-e] batch 0's loss did not fall: {l0} -> "
                      f"{again}")
    toks = TRAIN_B * TRAIN_S
    reset_counts()
    p_wall, busy, top_dev, _, p_note = profile_device(
        lambda: step(state, batch), 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    cross_ms = cross_attention_ms(dev, cfg)
    print(f"[train-e] {cfg.name} full width, {cfg.n_encoder_layers} + "
          f"{cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters, remat "
          f"full, B={TRAIN_B} S={TRAIN_S}, F={cfg.frontend_len} frames (the "
          f"synthetic mask zeroes the first {cfg.frontend_len} decoder "
          f"positions: the reference's quirk): init {t_init:.1f} s (one "
          f"batch of make_dataset {t_data:.2f} s); loop.run {TRAIN_E_STEPS} "
          f"steps (KF scheduler, variants {res.variants}; "
          f"{want['flash_attn']} B5 and {want['flash_attn_bwd']} B5-bwd "
          f"launches a step): losses "
          + ", ".join(f"{x:.4f}" for x in res.losses)
          + f", batch 0's loss after them {again:.4f} below its {l0:.4f} "
          f"at init; "
          f"wall {wall:.1f} s, step walls "
          + ", ".join(f"{x:.3f}" for x in walls)
          + f" s (median {statistics.median(walls):.3f} s, "
          f"{toks / statistics.median(walls):.0f} tokens/s; the prefetcher "
          f"draws the next batch meanwhile); one more step alone, profiled: "
          f"wall {p_wall:.1f} ms ({toks / p_wall * 1e3:.0f} tokens/s), "
          f"device busy {fmt_ms(busy)}{p_note}, idle share "
          + (f"{max(0.0, 1 - busy / p_wall):.3f}" if busy > 0
             else "not measured")
          + f"; top device ops (ms a step): {fmt_top(top_dev)}; peak device "
          f"memory {peak:.1f} GB (torch.cuda.max_memory_allocated); the "
          f"plain cross-attention (attend_ref, no mask) at the step's shape "
          f"timed alone: forward {cross_ms[0]:.3f} ms, forward + backward "
          f"{cross_ms[1]:.3f} ms a layer (events), {cfg.n_layers} layers' "
          f"forward, remat recompute and backward {cross_ms[2]:.1f} ms, "
          f"{cross_ms[2] / p_wall:.3f} of the step alone's wall")
    sys.stdout.flush()
    del state, res, batch
    torch.cuda.empty_cache()
    return total


def encdec_paths(dev, t_start, join_ssm) -> tuple[int, int]:
    """The card sides of [serve-ew], [serve-vw] and [train-ew]; then, with
    the SSM twins' CPU tail (``join_ssm`` waits for it) and these twins'
    CPU sides on a worker thread beside them, [train-e], [fwd-e],
    [serve-e], [fwd-v] and [serve-v] (each model whole, freed after).
    Returns the B5 and B5-bwd launches of the main paths."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.models import encdec, lm

    cfg_e, cfg_v = configs.get("seamless-m4t-large-v2"), configs.get(
        "internvl2-2b")
    twins = [phase_serve_ew(dev, cfg_e), phase_serve_vw(dev, cfg_v)]
    cfg2 = dataclasses.replace(cfg_e, n_layers=2, n_encoder_layers=2)
    twins.append(train_card_vs_cpu(
        dev, "[train-ew]", cfg2, 256,
        launches(flash_attn=4 * 2, flash_attn_bwd=2 * 2),
        f"{cfg_e.name} full width, 2 + 2 layers, {cfg_e.frontend_len} "
        f"frames, the mask all ones", pool_kin=True, defer=True,
        mask_ones=True))
    join_twins = on_worker(lambda: [join_ssm()] + [t() for t in twins])
    stamp("the card sides of [serve-ew], [serve-vw] and [train-ew]", t_start)
    total = phase_train_e(dev, cfg_e)
    stamp("[train-e]", t_start)
    params = encdec.make_encdec(torch.Generator(device=dev).manual_seed(SEED),
                                cfg_e)
    b5 = phase_fwd_e(dev, params, cfg_e) + phase_serve_e(dev, params, cfg_e)
    del params
    torch.cuda.empty_cache()
    stamp("[fwd-e] and [serve-e]", t_start)
    params = lm.make_lm(torch.Generator(device=dev).manual_seed(SEED), cfg_v)
    b5 += phase_fwd_v(dev, params, cfg_v) + phase_serve_v(dev, params, cfg_v)
    del params
    torch.cuda.empty_cache()
    stamp("[fwd-v] and [serve-v]", t_start)
    join_twins()
    stamp("the SSM twins, the encoder-decoder and the vision prefix",
          t_start)
    return b5 + total["flash_attn"], total["flash_attn_bwd"]


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.core.allocator import PolicyConfig
        from repro_torch.core.noc import sim, traffic
        from repro_torch.core.noc.topology import make_topology
        from repro_torch.kernels import _build
        from repro_torch.kernels.flash_attn import kernel as fa_kernel
        from repro_torch.kernels.kf_bank import kernel as kf_kernel
        from repro_torch.kernels.mamba_scan import kernel as ms_kernel
        from repro_torch.kernels.noc_cycle import fused, kernel, ops
        from repro_torch.obs import TraceRecorder, summarize_trace
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing beside this "
              f"script: {e}", file=sys.stderr)
        return 2

    t_start = time.time()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    # ---- phase 1: device line + kernel build
    print(f"[1] device: {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})")
    torch.backends.cuda.matmul.allow_tf32 = False   # torch's default: f32
    torch.backends.cudnn.allow_tf32 = False         # products compared in f32
    t0 = time.time()
    libs = [("noc_cycle", kernel.SOURCES), ("kf_bank", kf_kernel.SOURCES),
            ("flash_attn", fa_kernel.SOURCES),
            ("flash_attn_bwd", fa_kernel.BWD_SOURCES),
            ("mamba_scan", ms_kernel.SOURCES),
            ("mamba_scan_bwd", ms_kernel.BWD_SOURCES)]
    _build.build_all(libs)              # one nvcc per source, in parallel
    for mod in (kernel, kf_kernel, fa_kernel, ms_kernel):
        mod.library()
    fa_kernel.bwd_library()
    ms_kernel.bwd_library()
    print(f"[1] kernel build + load: {time.time() - t0:.1f} s "
          f"({', '.join(src[0].name for _, src in libs)})")
    usage = {}
    for lib, src in libs:
        log = _build.build_log(lib, src)
        if log.exists():
            usage.update(ptxas_usage(log.read_text()))
    want = ({"B1", "B2", "B3", "B2 clocked", "B4", "B6"}
            | {f"B5 {t} D{d}" for t in ("bf16", "f32")
               for d in fa_kernel.HEAD_DIMS}
            | {f"B5b {p} {t} D{d}" for p in ("dkdv", "dq")
               for t in ("bf16", "f32") for d in fa_kernel.HEAD_DIMS}
            | {f"B5b delta {t}" for t in ("bf16", "f32")}
            | {f"B7 {t} S{n}{w}" for t in ("bf16", "f32")
               for n in ms_kernel.FUSED_STATES for w in ("", " narrow")}
            | {"B6b", "B7b heads"}
            | {f"B7b {t} S{n}{m}{w}" for t in ("bf16", "f32")
               for n in ms_kernel.FUSED_STATES for m in ("", " ssd")
               for w in ("", " narrow")}
            | {f"B7b sums {t}" for t in ("bf16", "f32")})
    check(set(usage) == want,
          f"ptxas report lacks a kernel: {sorted(want - set(usage))}")
    print(f"[1] ptxas -v per thread: {json.dumps(usage, sort_keys=True)}")
    # the card's floor for one launch: a one-element torch op
    one = torch.zeros(1, device=dev)
    floor_ms = cuda_ms(lambda: one.add_(1), 200)
    floor_dev_ms = one_kernel_each(lambda: one.add_(1), 50,
                                   "elementwise_kernel", "add_")
    print(f"[1] one-launch floor (one-element add_): events {floor_ms:.4f} "
          f"ms per call, device {fmt_ms(floor_dev_ms)} per launch")
    b7_spill = {k: v for k, v in usage.items() if k.startswith("B7")
                and v["stack"] + v["spill_stores"] + v["spill_loads"]}
    check(not b7_spill, f"a B7 or B7-bwd instantiation has a stack or "
                        f"spills: {b7_spill}")
    b5b_spill = {k: v for k, v in usage.items()
                 if k.startswith("B5b") and "bf16" in k
                 and v["stack"] + v["spill_stores"] + v["spill_loads"]}
    check(not b5b_spill, f"a bf16 B5-bwd kernel has a stack or spills: "
                         f"{b5b_spill}")
    sys.stdout.flush()

    # The kernel checks of phases 2-3 and the live case of phase 4 share one
    # short run: kf with the guard and joint control, under a fault stream
    # and a placement stream built here, so that every mask B1 and B2 take
    # (link, router, MC, VC partition, node class) is live.  Its kernel
    # inputs come from sim's own per-epoch builders.
    topo = make_topology()
    short = dict(n_epochs=6, epoch_len=500,
                 policy=PolicyConfig(warmup=1000, hold=500, revert=1500))
    live = sim.NoCConfig(mode="kf", guard=True, control="joint",
                         faults=fault_stream(topo, 6),
                         placement=placement_stream(topo, 6), **short)
    run = sim.run_inputs(live, "SHIFT_PATH_BFS", device=dev,
                         rng=torch.Generator(device=dev).manual_seed(SEED))
    tables = sim.lane_tables(run)
    d = tables[0]
    L = d.lanes_sr
    boosted = torch.tensor(1, dtype=torch.int32)  # VC boost + cls1 plan

    # ---- phase 2: B1 against its plain version
    subs, mc, outst, backlog = sim.init_sim_state(run.stc, dev)
    st = fused.pack_state(d, subs, mc, outst, backlog,
                          traffic.init_phase().to(dev))
    samples, epoch_starts = [], []
    for e in range(3):
        ep = sim.epoch_inputs(run, e, boosted, e * run.stc.epoch_len)
        xi, xf, consts = sim.lane_row(*sim.lane_inputs(run, tables, ep), 0)
        epoch_starts.append((st, xi, xf, consts))
        done = 0
        for upto in (1, 40, 250, 499, 500):
            st = ops.fused_cycle_step(d, st, xi[done:upto], xf[done:upto],
                                      *consts)
            done = upto
            if done < xi.shape[0]:
                samples.append((st, xi[done], consts))
    b1_err = 0
    for s_st, xi_c, consts in samples:
        ins = arb_inputs(d, s_st, xi_c, consts)
        b1_err = max(b1_err, max_diff(ops.arbitrate_rows(*ins, depth=d.B),
                                      plain_arbitrate(ins, d.B)))
    busy = int(samples[-1][0].count.sum())
    check(busy > 0, "the sampled lane states hold no packets")
    rg = torch.Generator(device=dev).manual_seed(SEED + 1)
    for _ in range(8):
        def ri(lo, hi, rows):
            return torch.randint(lo, hi, (rows, L), generator=rg, device=dev,
                                 dtype=torch.int32)
        ins = (ri(0, 2, d.PV), ri(0, 2, d.PV), ri(0, 5, d.PV), ri(0, d.PV, 5),
               ri(0, d.B + 1, d.PV), ri(0, 2, 5), ri(0, 2, d.V), ri(0, 2, d.V),
               ri(-1, 2, 1), ri(0, 2, 1), ri(0, 2, 1))
        b1_err = max(b1_err, max_diff(ops.arbitrate_rows(*ins, depth=d.B),
                                      plain_arbitrate(ins, d.B)))
        # the same rows as int8 and transposed (non-contiguous) views
        alt = tuple((x.T.contiguous().T if k % 2 else x).to(
            torch.int8 if k in (0, 3, 4, 9) else torch.int32)
            for k, x in enumerate(ins))
        b1_err = max(b1_err, max_diff(ops.arbitrate_rows(*alt, depth=d.B),
                                      plain_arbitrate(ins, d.B)))
    check(b1_err == 0, f"B1 disagrees with its plain version on lane rows "
                       f"(max abs err {b1_err})")
    rows_ins = arb_inputs(d, *samples[-1])

    # B1 on the dense layout, as the "arb" engine calls it: the operands
    # router_cycle hands arbitrate_lanes in six cycles of a 2 x 500-cycle
    # "arb" run of the live configuration (faults and placement live), and
    # six seeded random dense states; each also recast to int8 / uint8 /
    # int64 elements and other strides; against router.arbitrate on the card
    from repro_torch.core.noc import router as rt

    real = ops.arbitrate_lanes

    def dense_err(args, depth):
        want = rt.arbitrate(*args, depth=depth)
        err = 0
        for ins_ in (args, recast(args)):
            got = real(*ins_, depth=depth)
            check(all(a.dtype == b.dtype and a.shape == b.shape
                      for a, b in zip(got, want)),
                  "B1's dense outputs differ from router.arbitrate's in "
                  "dtype or shape")
            err = max(err, max_diff(got, want))
        return err

    seen, recorded = [0], []

    def recording(*args, depth):
        seen[0] += 1
        if seen[0] in (1, 137, 499, 500, 777, 1000):
            recorded.append(dense_err(args, depth))
            recorded_args[:] = [args, depth]
        return real(*args, depth=depth)

    recorded_args = []
    rec_cfg = sim.NoCConfig(
        mode="kf", guard=True, control="joint",
        faults=type(live.faults)(*(x[:2] for x in live.faults)),
        placement=type(live.placement)(*(x[:2] for x in live.placement)),
        n_epochs=2, epoch_len=500, policy=short["policy"])
    ops.arbitrate_lanes = recording
    try:
        sim.simulate(rec_cfg, "SHIFT_PATH_BFS", device=dev, engine="arb",
                     rng=torch.Generator(device=dev).manual_seed(SEED))
    finally:
        ops.arbitrate_lanes = real
    check(len(recorded) == 6, f"recorded {len(recorded)} of 6 dense cycles")
    b1_dense_err = max(recorded)
    for k in range(6):
        b1_dense_err = max(b1_dense_err,
                           dense_err(*dense_operands(SEED + 10 + k, dev)))
    check(b1_dense_err == 0, f"B1 disagrees with router.arbitrate on dense "
                             f"operands (max abs err {b1_dense_err})")
    b1_err = max(b1_err, b1_dense_err)

    # time: the engine's entry point (events), the raw launch on a built
    # descriptor (events), device time (torch.profiler), the rows entry
    args_t, depth_t = recorded_args

    def entry():
        return ops.arbitrate_lanes(*args_t, depth=depth_t)

    arb_t, desc_t = ops.lanes_desc(args_t, depth=depth_t)
    b1_ms = cuda_ms(entry, 200)
    b1_raw_ms = cuda_ms(lambda: kernel.noc_arbitrate(desc_t, dev), 200)
    b1_rows_ms = cuda_ms(lambda: ops.arbitrate_rows(*rows_ins, depth=d.B),
                         200)
    b1_plain_ms = cuda_ms(lambda: rt.arbitrate(*args_t, depth=depth_t), 20)
    b1_dev_ms = one_kernel_each(entry, 50, "noc_arbitrate_kernel",
                                "arbitrate_lanes")
    one_kernel_each(lambda: ops.arbitrate_rows(*rows_ins, depth=d.B), 20,
                    "noc_arbitrate_kernel", "arbitrate_rows")
    bm1, by1 = b1_bound(args_t, arb_t)
    print(f"[2] B1 bitwise equal on lane rows: {len(samples)} sampled "
          f"(faults and placement live) + 8 random states ({busy} buffered "
          f"packets), each also as int8 / transposed rows; on dense "
          f"operands: 6 cycles of an arb run + 6 random states, each also "
          f"recast; one device kernel per arbitrate_lanes / arbitrate_rows "
          f"call; ms per call at {args_t[0].shape[0]}x{args_t[0].shape[1]} "
          f"dense lanes: arbitrate_lanes {b1_ms:.4f} (events), raw launch "
          f"{b1_raw_ms:.4f} (events), device {fmt_ms(b1_dev_ms)}; "
          f"arbitrate_rows at L = {L} {b1_rows_ms:.4f}; plain "
          f"router.arbitrate {b1_plain_ms:.4f}; bound {bm1:.6f} ({by1})")
    sys.stdout.flush()

    # ---- phase 3: B2 against its plain version, on epoch 2's inputs (link
    # down, router browned out, MC stalled, boosted masks and cls1 plan);
    # the plain 500-cycle run is timed as it is checked, as B3's below
    st0, xi2, xf2, consts2 = epoch_starts[2]
    b2_err = 0
    for n in (1, 500):
        k = ops.fused_cycle_step(d, st0, xi2[:n], xf2[:n], *consts2)
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        p = fused.cycle_steps_lanes(d, st0, xi2[:n], xf2[:n], *consts2)
        b.record()
        torch.cuda.synchronize()
        b2_plain_ms = a.elapsed_time(b)
        err = max_diff(k, p)
        check(err == 0, f"B2 disagrees with {n} plain cycles (max abs err "
                        f"{err})")
        b2_err = max(b2_err, err)

    # B3 on the same inputs from a non-zero flight-recorder carry; the
    # plain 500-cycle run is timed as it is checked
    pb0 = random_probe(d, torch.Generator(device=dev).manual_seed(SEED + 2))
    b3_err = 0
    for n in (1, 500):
        k, kp = ops.fused_cycle_step(d, st0, xi2[:n], xf2[:n], *consts2,
                                     probe=pb0)
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        p, pp = fused.cycle_steps_lanes(d, st0, xi2[:n], xf2[:n], *consts2,
                                        probe=pb0)
        b.record()
        torch.cuda.synchronize()
        b3_plain_ms = a.elapsed_time(b)
        err = max(max_diff(k, p), max_diff(kp, pp))
        check(err == 0, f"B3 disagrees with {n} plain cycles (max abs err "
                        f"{err})")
        b3_err = max(b3_err, err)
        check(bool((kp.occ > pb0.occ).any()), "B3 added nothing to occ")
    # B2 and B3 in turns on scratch copies (B2, B3, B3, B2)
    scratch = fused.LaneState(*(x.clone() for x in st0))
    scratch_pb = fused.ProbeLanes(*(x.clone() for x in pb0))

    def time_b2():
        return cuda_ms(lambda: kernel.noc_fused_cycles(
            d, scratch, xi2, xf2, *consts2), 10)

    def time_b3():
        return cuda_ms(lambda: kernel.noc_fused_cycles_probed(
            d, scratch, scratch_pb, xi2, xf2, *consts2), 10)

    turns = [time_b2(), time_b3(), time_b3(), time_b2()]
    b2_ms = (turns[0] + turns[3]) / 2
    b3_ms = (turns[1] + turns[2]) / 2
    print(f"[3] B2 bitwise equal after 1 and 500 cycles, B3 (B2 + probes) "
          f"bitwise equal after 1 and 500 cycles from a non-zero carry; ms "
          f"per 500-cycle launch in turns B2/B3/B3/B2 "
          f"{' / '.join(f'{t:.4f}' for t in turns)}: B2 {b2_ms:.4f}, B3 "
          f"{b3_ms:.4f} ({b3_ms / b2_ms:.3f}x); plain B2 {b2_plain_ms:.1f} "
          f"ms, plain B3 {b3_plain_ms:.1f} ms per 500 cycles")
    # where one simulated cycle goes: B2's clocked instantiation (thread
    # 0's clock64() at the stage marks) on epoch 2's 500 cycles
    clk_state = fused.LaneState(*(x.clone() for x in st0))
    clocks = kernel.noc_fused_cycles_clocked(d, clk_state, xi2, xf2, *consts2)
    check(max_diff(clk_state, ops.fused_cycle_step(
        d, st0, xi2, xf2, *consts2)) == 0,
        "B2's clocked instantiation disagrees with B2")
    n_cyc = xi2.shape[0]
    per = {k: clocks[k] / n_cyc for k in kernel.CYCLE_STAGES}
    once = {k: v for k, v in clocks.items() if k not in per}
    print(f"[3] B2 split of one simulated cycle (SM clocks, thread 0, mean "
          f"of {n_cyc}): total {sum(per.values()):.0f}; "
          + "; ".join(f"{k} {v:.0f}" for k, v in per.items())
          + "; per launch: " + "; ".join(f"{k} {v}" for k, v in once.items()))
    sys.stdout.flush()

    stamp("phases 1-3", t_start)

    # ---- phase 4: engine congruence at the full grid, CONG_EPOCHS x 500
    # cycles, with the flight recorder on; the live case's fault and
    # placement streams built for CONG_EPOCHS epochs, every mask kind and
    # both telemetry faults inside them
    b1_launches = None
    cong = dict(short, n_epochs=CONG_EPOCHS)
    live_c = dataclasses.replace(
        live, n_epochs=CONG_EPOCHS,
        faults=fault_stream(topo, CONG_EPOCHS, telem_at=CONG_EPOCHS - 2),
        placement=placement_stream(topo, CONG_EPOCHS))
    cases = (("kf", sim.NoCConfig(mode="kf", **cong), "SHIFT_PATH_BFS"),
             ("kf+guard+joint+faults+placement", live_c, "SHIFT_PATH_BFS"),
             ("4subnet", sim.NoCConfig(mode="4subnet", **cong), "STO"),
             ("fair", sim.NoCConfig(mode="fair", **cong), "STO"))
    n_cong = CONG_EPOCHS * short["epoch_len"]
    for label, cfg, wl in cases:
        res, trc, secs = {}, {}, {}
        for engine in ("fused", "arb", "ref"):
            ops.reset_launches()
            t0 = time.time()
            res[engine], trc[engine] = sim.simulate_with_trace(
                cfg, wl, device=dev, engine=engine,
                rng=torch.Generator(device=dev).manual_seed(SEED))
            secs[engine] = time.time() - t0
            if engine == "fused":
                check(ops.LAUNCHES["noc_fused_cycles_probed"] == CONG_EPOCHS
                      and ops.LAUNCHES["noc_fused_cycles"] == 0,
                      f"traced fused engine launched {ops.LAUNCHES}")
            if engine == "arb":
                check(ops.LAUNCHES["noc_arbitrate"] == n_cong,
                      f"arb engine launched B1 {ops.LAUNCHES} times")
                if label == "kf":
                    b1_launches = ops.LAUNCHES["noc_arbitrate"]
        for engine in ("arb", "ref"):
            diff = results_equal(res["fused"], res[engine])
            check(diff is None, f"{label}: {diff} differs between fused and "
                                f"{engine}")
            for f, x, y in zip(trc["fused"]._fields, trc["fused"],
                               trc[engine]):
                check(same(x, y), f"{label}: SimTrace {f} differs between "
                                  f"fused and {engine}")
        conf = res["fused"].applied_config
        if label == "kf":
            check(bool((conf[1:] != conf[:-1]).any()),
                  "kf run never changed its applied_config")
        tsum = summarize_trace(trc["fused"])
        print(f"[4] {label}/{wl}: fused == arb == ref bitwise (SimResult "
              f"and SimTrace) over {CONG_EPOCHS}x500 cycles; applied_config "
              f"{conf.tolist()}; trace digest grants "
              f"{tsum['arb_grant_total']}, denies {tsum['arb_deny_total']}, "
              f"rejects {tsum['kf_rejected_total']}, fault epochs "
              f"{tsum['fault_epochs']}, moves {tsum['place_moves_total']}; "
              f"wall s "
              + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
        sys.stdout.flush()

    stamp("phase 4", t_start)

    # ---- phase 5: the main path at full width through B2
    b2_launches = None
    for mode in ("kf", "fair"):
        cfg = sim.NoCConfig(mode=mode)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        res = sim.simulate(cfg, "SHIFT_PATH_BFS")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = ops.LAUNCHES["noc_fused_cycles"]
        check(launches == cfg.n_epochs,
              f"{mode}: B2 launched {launches} times, expected {cfg.n_epochs}")
        check(ops.LAUNCHES["noc_arbitrate"] == 0, "main path launched B1")
        if mode == "kf":
            b2_launches = launches
        c = res.counters
        check(all(bool((x >= 0).all()) for x in c), f"{mode}: negative counter")
        check(int(c.gpu_push.sum()) <= int(c.gpu_gen.sum()),
              f"{mode}: gpu_push > gpu_gen")
        check(int(c.gpu_done.sum()) <= int(c.gpu_push.sum()),
              f"{mode}: gpu_done > gpu_push")
        check(res.gpu_ipc.shape == (cfg.n_epochs,)
              and bool(torch.isfinite(res.gpu_ipc).all())
              and bool(torch.isfinite(res.avg_latency).all()),
              f"{mode}: non-finite or misshapen result")
        cycles = cfg.n_epochs * cfg.epoch_len
        summ = {k: round(v, 6) for k, v in sim.summarize(res).items()}
        print(f"[5] {mode}/SHIFT_PATH_BFS {cfg.n_epochs}x{cfg.epoch_len}: "
              f"{launches} B2 launches, wall {wall:.2f} s, "
              f"{cycles / wall:.0f} simulated cycles/s, summarize {summ}")
        sys.stdout.flush()

    # ---- phase 5b: the traced path at full width through B3, and the
    # recorder's record -> npz -> replay
    n_full = sim.NoCConfig().n_epochs
    traced_cfg = sim.NoCConfig(mode="kf", guard=True, control="joint",
                               faults=fault_stream(topo, n_full),
                               placement=placement_stream(topo, n_full))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    res_t, trace = sim.simulate_with_trace(traced_cfg, "SHIFT_PATH_BFS")
    torch.cuda.synchronize()
    wall_t = time.time() - t0
    b3_launches = ops.LAUNCHES["noc_fused_cycles_probed"]
    check(b3_launches == n_full and ops.LAUNCHES["noc_fused_cycles"] == 0
          and ops.LAUNCHES["noc_arbitrate"] == 0,
          f"traced path launched {ops.LAUNCHES}, expected {n_full} of B3 "
          f"and nothing else")
    check(trace.occ_sum.shape == (n_full, 4, topo.n_routers, 5, 4)
          and bool((trace.occ_sum >= 0).all())
          and bool((trace.mcq_max <= trace.mcq_sum).all())
          and bool(torch.isfinite(trace.kf_gain).all()),
          "traced path: misshapen or out-of-range SimTrace")
    tsum = summarize_trace(trace)
    check(tsum["fault_epochs"] > 0 and tsum["place_moves_total"] > 0
          and tsum["kf_rejected_total"] > 0,
          f"traced path: fault, placement or guard channel idle: {tsum}")
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    res_u = sim.simulate(traced_cfg, "SHIFT_PATH_BFS")
    torch.cuda.synchronize()
    wall_u = time.time() - t0
    check(ops.LAUNCHES["noc_fused_cycles"] == n_full,
          f"untraced twin launched {ops.LAUNCHES}")
    diff = results_equal(res_t, res_u)
    check(diff is None, f"traced SimResult differs from untraced at {diff}")
    cycles = n_full * traced_cfg.epoch_len
    print(f"[5] traced kf+guard+joint+faults+placement/SHIFT_PATH_BFS "
          f"{n_full}x{traced_cfg.epoch_len}: {b3_launches} B3 launches, "
          f"wall {wall_t:.2f} s, {cycles / wall_t:.0f} simulated cycles/s; "
          f"untraced twin {wall_u:.2f} s, {cycles / wall_u:.0f} cycles/s; "
          f"SimResult bitwise equal; digest {tsum}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capture.npz")
        rec = TraceRecorder(name="chip_smoke").record_to(
            path, traced_cfg, "SHIFT_PATH_BFS")
        # (json text, so that a NaN innovation of a NaN-telemetry epoch
        # compares equal to itself)
        check(json.dumps(rec.meta["observed"], sort_keys=True)
              == json.dumps(tsum, sort_keys=True),
              "the recorder's observed digest differs from the traced run's")
        with np.load(path, allow_pickle=False) as data:
            problems = traffic.validate_trace_npz(data)
        check(problems == [], f"recorded npz invalid: {problems}")
        loaded = traffic.RecordedTrace.load(path)
    replay = sim.simulate(traced_cfg, loaded)
    diff = results_equal(replay, res_u)
    check(diff is None, f"replayed npz differs from the run at {diff}")
    print(f"[5] TraceRecorder(observe=True) -> npz ({loaded.n_epochs_recorded}"
          f" rows) -> RecordedTrace.load -> simulate: bitwise equal to the "
          f"untraced run")
    sys.stdout.flush()

    stamp("phase 5", t_start)
    # ---- the paper sweep: simulate_batch / sweep through B2 at batch > 1
    swp = phase_sweep(dev)
    # ---- the named fault and placement scenarios through sweep
    scen = phase_scen(dev)
    stamp("[scen]", t_start)
    # ---- replayed serving traces through the predictor grid, and the
    # flight-recorder renderer
    rpl = phase_replay(dev)
    trc = phase_trace(dev)
    # ---- the benchmark drivers, the port's ledger and its gate, the dry run
    bench, bench_err = phase_bench(dev)
    stamp("the NoC paths", t_start)

    # ---- the fleet path (B4) and the serving path (B5)
    b4 = phase_b4(dev)
    b5 = phase_b5(dev)
    twins = [phase_serve_w(dev)]   # the CPU sides run beside [train]
    b5["launches"] = phase_serve(dev)
    stamp("llama3.2-3b", t_start)

    # ---- the mamba paths: forward through B6, serving through B7, on
    # falcon-mamba-7b at full width, depth cut to SERVE_M_LAYERS of its 64
    # layers to keep the script inside its time limit (llama's weights
    # are freed)
    import repro_torch.configs as configs
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import lm

    b6 = phase_b6(dev)
    b7 = phase_b7(dev)
    cfg_m = dataclasses.replace(configs.get("falcon-mamba-7b"),
                                n_layers=SERVE_M_LAYERS)
    t0 = time.time()
    params_m = lm.make_lm(torch.Generator(device=dev).manual_seed(SEED), cfg_m)
    torch.cuda.synchronize()
    t_init_m = time.time() - t0
    b6["launches"] = phase_fwd_m(dev, params_m, cfg_m)
    twins.append(phase_serve_mw(dev))
    b7["launches"] = serve_main(
        dev, "[serve-m]", cfg_m, params_m, t_init_m,
        [(ms_ops, "mamba_fused", "B7", cfg_m.n_layers)])["B7"]
    del params_m
    torch.cuda.empty_cache()
    stamp("falcon-mamba-7b", t_start)

    # ---- the hybrid: zamba2-2.7b at full width, depth cut to
    # SERVE_Z_LAYERS of its 54 layers to keep the script inside its time
    # limit, its
    # SSD scan through B7 (S = 64) and its shared attention block through B5
    from repro_torch.kernels.flash_attn import ops as fa_ops

    cfg_z = dataclasses.replace(configs.get("zamba2-2.7b"),
                                n_layers=SERVE_Z_LAYERS)
    t0 = time.time()
    params_z = lm.make_lm(torch.Generator(device=dev).manual_seed(SEED), cfg_z)
    torch.cuda.synchronize()
    t_init_z = time.time() - t0
    fwd_z = phase_fwd_z(dev, params_z, cfg_z)
    twins.append(phase_serve_zw(dev))
    serve_z = serve_main(
        dev, "[serve-z]", cfg_z, params_z, t_init_z,
        [(ms_ops, "mamba_fused", "B7", cfg_z.n_layers),
         (fa_ops, "flash_attn", "B5",
          cfg_z.n_layers // cfg_z.shared_attn_period)])
    b5["launches"] += fwd_z["flash_attn"] + serve_z["B5"]
    b7["launches"] += fwd_z["mamba_fused"] + serve_z["B7"]
    del params_z
    torch.cuda.empty_cache()
    stamp("the hybrid", t_start)

    # ---- the MoE decoders: grok-1 and llama4-maverick, attention via B5
    b5["launches"] += moe_paths(dev, t_start)

    # ---- the training path: llama3.2-3b through B5 and B5-bwd
    b5b, b5_train = train_paths(dev, t_start, twins)
    b5["launches"] += b5_train

    # ---- the SSM training paths: falcon-mamba-7b through B7 and B7-bwd
    # (and B6, B6-bwd with use_kernel), zamba2-2.7b through B7, B7-bwd, B5
    # and B5-bwd
    b7b, ssd, b6b, ssm, join_ssm = ssm_train_paths(dev, t_start)
    b5["launches"] += ssm["flash_attn"]
    b5b["launches"] += ssm["flash_attn_bwd"]
    b6["launches"] += ssm["mamba_scan"]
    b7["launches"] += ssm["mamba_fused"]

    # ---- the encoder-decoder (seamless-m4t-large-v2: its encoder through
    # B5 with no mask, training through B5-bwd) and the vision prefix
    # (internvl2-2b)
    b5_e, b5b_e = encdec_paths(dev, t_start, join_ssm)
    b5["launches"] += b5_e
    b5b["launches"] += b5b_e

    # ---- phase 6: the kernels line; [bench]'s launches and its kernel
    # micro-benches' errors added to B1, B2, B4, B5 and B6
    b1_launches += bench["noc_arbitrate"]
    b1_err = max(b1_err, bench_err["noc_arbitrate"])
    b2_err = max(b2_err, bench_err["noc_fused_cycles"])
    for entry, counter in ((b4, "kf_bank"), (b5, "flash_attn"),
                           (b6, "mamba_scan")):
        entry["launches"] += bench[counter]
        entry["max_abs_err"] = max(entry["max_abs_err"], bench_err[counter])
    nb2, op2 = b2_bound(d, 500)
    nb3, op3 = b3_bound(d, 500)
    bm2, by2 = bound_ms(nb2, op2)
    bm3, by3 = bound_ms(nb3, op3)
    kernels = [
        dict(name="noc_arbitrate", route="cuda",
             source="src/repro_torch/kernels/noc_cycle/csrc/noc_cycle.cu",
             replaces="src/repro/kernels/noc_cycle/kernel.py:34",
             launches=b1_launches, max_abs_err=b1_err, ms=b1_ms,
             plain_ms=b1_plain_ms, bound_ms=bm1, bound_by=by1,
             library_ms=None),
        dict(name="noc_fused_cycles", route="cuda",
             source="src/repro_torch/kernels/noc_cycle/csrc/noc_cycle.cu",
             replaces="src/repro/kernels/noc_cycle/kernel.py:114",
             launches=(b2_launches + swp["launches"] + scen["b2"]
                       + rpl["b2"] + trc["b2"] + bench["noc_fused_cycles"]),
             max_abs_err=max(b2_err, swp["b2_err"]),
             ms=b2_ms,
             plain_ms=b2_plain_ms, bound_ms=bm2, bound_by=by2,
             library_ms=None),
        dict(name="noc_fused_cycles_probed", route="cuda",
             source="src/repro_torch/kernels/noc_cycle/csrc/noc_cycle.cu",
             replaces="src/repro/kernels/noc_cycle/kernel.py:152",
             launches=b3_launches + scen["b3"] + trc["b3"],
             max_abs_err=b3_err,
             ms=b3_ms,
             plain_ms=b3_plain_ms, bound_ms=bm3, bound_by=by3,
             library_ms=None),
        b4, b5, b5b, b6, b7, b6b, b7b, ssd,
    ]
    print(f"[6] total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
