"""Smoke run of adaptdl_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. device: versions, the card's name and power limit; CUDA required.
2. build: every kernel under adaptdl_tpu_torch/csrc, compiled in
   parallel (adaptdl_tpu_torch/ops/_build.py) into the kernel cache on a
   share path the whole run uses (ADAPTDL_SHARE_PATH, a temp dir); ptxas
   registers, spills and shared memory of every instance (the f32
   kernel's head_dim-64 instances must spill nothing).
3. kernels vs plain: both flash forward kernels against their plain
   PyTorch version on the card -- the sm90 kernel (bf16, head_dim 64
   and 128) at the main path's shape, head_dim 128 and a ragged seq;
   the f32 kernel (3xTF32 on the tensor cores) at f32 at the main shape,
   S 512, head dims 8, 72 and 128 and a ragged seq at 120, and at bf16
   head_dim 40 (ragged) and 96 -- with stated tolerances (a per-element
   bound for the sm90 kernel, see sm90_bound) and a check of which kernel
   each input reached; the flash gradient (autograd Function) against
   dense autograd in f32 and bf16; times of both kernels on the main
   path's bf16 input, of the f32 kernel on f32 and on bf16 at head_dim 40
   and 96, each beside the plain version and one PyTorch library call
   computing the same function; the device kernels f32 SDPA runs (a
   torch.profiler window) and the card's mma.sync TF32 rate (a probe
   kernel built here), against which the f32 kernel's 3xTF32 work has a
   floor of its own.
4. main path: the full-width transformer LM (12 x 768, 12 heads, seq
   512, vocab 32000, bf16) through initialize_job ->
   AdaptiveDataLoader -> ElasticTrainer.run_step, 10 steps at
   accum_steps 0 and 4 at accum_steps 1; launch counts reset just
   before and read just after, and held to the expected count per
   step (the sm90 kernel; the f32 kernel must not move); loss falls,
   statistics finite; the flash model agrees with the dense-attention
   model on 2 x 512 tokens in bf16 (sm90 kernel) and in f32 (f32
   kernel); a checkpoint restores bit for bit into a fresh trainer.
5. multi-replica: the same full-width LM, each replica a fresh process
   started by ``python -m adaptdl_tpu_torch.launch`` (this script with
   --replica-worker):
   a. two replicas on the one card (gloo: two local ranks, one card),
      atomic 16, accum 0, with the launch counts of each rank reset just
      before and read just after its steps, as in phase 4; after every
      step the ranks' parameter, Adam-moment and noise-statistic
      checksums and their (atomic_bsz, accum_steps) must be equal;
   b. rank 1 alone raises the exit flag after step 5: both ranks stop
      after step 6, rank 0 saves, and the launcher exits 143;
   c. a successor at one replica restores bit-equal to what rank 0
      saved (checksums), resumes at the saved position, recomputes its
      batch (atomic 32) and trains 4 steps with falling loss, holding
      profiles at 2 and 1 replicas;
   d. in a fresh process, the port's process group at world size 1 on
      NCCL: the flat all-reduce of a full-width gradient set is one call
      and returns its input bit for bit.
   The two ranks of 5a run under the supervisor recorder (below): both
   register, rendezvous through /discover and heartbeat; rank 0 alone
   posts hints.
6. supervised and guarded: the full-width LM at one replica as a job of
   a supervisor, in this process. The supervisor is a recorder on the
   standard library's HTTP server in a thread (the supervisor of the JAX
   package needs aiohttp): it serves the job-facing routes, checks every
   hint payload with the port's validate_hints and serves one
   batchConfig once told to. Settings: a fit interval of 2 s,
   heartbeats every 0.5 s, a save every 2 steps, good markers after 2
   healthy observations, metrics_every 1 and an injected NaN gradient
   statistic at the guard's 7th observation. Checked: a) heartbeats, and
   accepted hints whose perfParams are finite, non-negative and predict
   this card's measured throughput within 2x, with finite gradParams;
   b) once /config serves {"atomicBsz": 16, "accumSteps": 1} for a
   one-slot allocation, the loader adopts (16, 1) at its next
   re-optimisation; c) the guard reports nan_grad at observation 7 and
   rolls back: parameters, Adam moments and noise statistics equal
   their checksums at the good-marked save, the loader resumes at that
   save's position and skips the poisoned span; d) one incident
   (nan_grad, rollback) reaches the supervisor; e) 5 more steps with
   finite losses; f) the sm90 launches per step as in phase 4, none of
   the f32 kernel. Prints the hint-post latency, the rollback's restore
   seconds, the phase's median step time against phase 4's, and the
   profile entries the fit reads (mean calibration and optimizer-step
   time per atomic batch) beside the measured step.
7. model zoo: each path through the port's entry points on the card,
   a fresh job each (registries reset, its own checkpoint dir), with the
   flash launch counts reset just before and read just after (none of
   them runs a flash kernel; BERT's attention is dense, as the JAX
   example's):
   a. CIFAR ResNet-18 (examples/cifar_resnet18.py: width 64, bf16,
      SGD(0.1, momentum 0.9) + AdaScale, 50,000 images): 40 steps at
      (128, 0) and 5 at (128, 1); losses finite, the last three below
      the first (the loss climbs for about ten steps first); median step
      ms, samples/s, peak memory, the device's busy time and the host
      time in each of the trainer's ranges over 3 traced steps, the
      bare train_step's time (no loader or metrics) and the device's
      idle share of it (1 - busy / bare step); a save, a restore into a fresh trainer that is
      bit-equal (parameters, momentum, noise statistics, progress), and
      a resumed step whose loss matches the original trainer's;
   b. NCF (256 users, 512 items, Adam + AdamScale, batch 256): 8 steps
      and the ranked evaluation;
   c. DCGAN (64 features, latent 32, batch 64): 8 steps of D under
      has_aux with a G step after each; a sample grid; G and D restored
      together bit-equal;
   d. BERT MLM (12 x 768 x 3072, seq 512, vocab 30522, bf16, remat): 5
      steps;
   e. linear regression: its main() for 3 epochs; the weights within
      0.05 of the true ones.
8. rescale: the full-width LM through a planned rescale and a
   preemption, each incarnation a fresh process (this script with
   --rescale-worker) under the supervisor recorder, with the handoff on
   (ADAPTDL_HANDOFF), the kernel cache on the job's share path, one
   trace context (ADAPTDL_TRACEPARENT) and a span journal
   (ADAPTDL_TRACE_DIR); the launch counts of each incarnation are reset
   just before its steps and read just after (sm90 only):
   a. incarnation 0 loads the kernels from the cache on the share path
      (phase 2 built it there), takes 7 steps with a save every 3 in
      the background (each save's blocking
      snapshot and background write seconds, the step after each save
      against the others, the pinned host buffers), the guard grading
      every step (every GOOD-marked dir must verify), then stops: a
      blocking save, a shard server left behind, exit 143;
   b. successor A loads the kernels from the same cache (every
      incarnation must: build seconds < 1), restores every state from the
      peer (handoff seconds and bytes), bit-equal to the stopping
      incarnation's state and to a storage restore of the same
      checkpoint (its seconds), takes 3 steps and stops the same way;
      the first shard server exits on the successor's /done;
   c. successor B, with handoff.fetch failing, restores from storage
      bit-equal; a notice (preempt.notice on the listener's first poll)
      while a periodic write is in flight runs the urgent drain, which
      joins the write and meets its deadline, the recorder receives
      /preempt, exit 143; the last shard server exits on B's /done (a
      rank that gave up on the peer posts it too) and is reaped (this
      process is the servers' subreaper): none outlives the phase;
   d. the journal holds incarnation 0's and successor A's spans under
      one trace id; its per-phase medians are printed.
9. options: the LM's one-card options, each part a fresh job with the
   flash launch counts reset just before and read just after it (no part
   may launch the f32 kernel). First, the index-form MoE FFN (full width's
   d and f, 8 experts) against its one-hot plain version on the card at
   2048 tokens, token choice top-2 and expert choice: routing bit-equal,
   outputs within 1e-5 of the largest; then
   a. the full-width MoE LM (8 experts top-2 every second block, chunked
      head 4096, flash, remat) through initialize_job ->
      AdaptiveDataLoader -> run_step, 6 steps at (32, 0): finite losses,
      sm90 launches 24 per step plus 96 for the calibration; the median
      step, tokens/s, MFU through adaptdl_tpu_torch.flops (and by 6N +
      12LdS), peak memory, the weighted aux loss and the share of dropped
      (token, choice) pairs;
   b. the chunked head against the dense head on the dense main-path LM:
      4 bare train_step runs each at (32, 0) from AdaptiveBPTTLoader over
      a flat corpus; peak memory, step time, and the first step's losses
      within 2^-7 of the largest logit (the dense head rounds to bf16);
   c. remat policies nothing_saveable, dots_with_no_batch_dims_saveable
      and everything_saveable on the dense main-path LM: gradients within
      2^-16 (relative to each tensor's largest) of today's remat, then 4
      bare steps each: peak memory, step time, sm90 launches per step (24,
      24, 12); two flash forwards of one input are bit-equal;
   d. BERT MLM with 8 experts every second block under expert-choice
      routing (the example's make_trainer and make_loader), 4 steps, aux 0;
   e. the MoE LM's trainer (full width, depth 4) with the expert weights
      in parameter group 1: GNS state of shape (2,), finite LR factors;
      every parameter in group 0 is bit-equal to no groups after 3 steps;
   f. tutorial step 5 on the card: one epoch, a save, and a restart that
      restores both loaders (train and "eval-loader") and runs epoch 1
      with its evaluation (accuracy > 0.5).
10. control plane: the port's own scheduler on the card (it needs neither
   JAX nor aiohttp), each job incarnation a fresh `python -m
   adaptdl_tpu_torch.launch` of an example with --steps and --report-dir,
   the kernels loaded from the cache on the share path:
   a. LocalElasticRunner over two slots (both ranks share the one card
      over gloo: the mechanism, not scaling) runs the full-width flash
      LM (examples/transformer_lm.py --flash) under the port's
      supervisor and a Pollux allocator cycling every 2 s. The job's
      bounds are edited as a user edits them (validate_job_spec, then
      ClusterState.update): max 1 at the start, min = max = 2 once its
      hints arrive, min = max = 1 once the two-rank incarnation's hints
      arrive. Checked: the allocator publishes each allocation and every
      launch carries out the last one published; replica counts 1, 2, 1,
      exits 143, 143, 0, the job Succeeded, never degraded; each
      successor resumes at its predecessor's saved step with finite
      losses; the two ranks end with equal parameters; each incarnation
      posted accepted hints; sm90 launches > 0 and f32 launches 0 in
      every incarnation. Printed: each Pollux cycle (time, mode,
      allocation, speedups scored, ms), each rescale's seconds from the
      spec edit to the publish, the SIGTERM, the exit 143 and the
      successor's first step, the cycle's p50 and max ms, the hint and
      heartbeat round trips as the job's span journal saw them (p50,
      p99) and the median step at 1 and 2 ranks. The operator's surface,
      after the last edit: once the allocator publishes the last
      allocation, GET /explain/{job} holds the publishing cycle's record
      with that allocation; once the last incarnation runs (its spans and
      a watch sample after its launch arrived), GET /watch (goodput
      samples, measured and predicted, drift), /explain (the last
      decision is the running allocation), /metrics (text/plain, passes
      tests/promcheck.py, drift and the job's tenant families) and
      /status (each job's watch fields) from the live supervisor, then
      `python -m adaptdl_tpu_torch.cli status|top|explain|trace
      --perfetto FILE` as four processes at once, each exit 0, the
      Perfetto file one trace id, the decision's, with the last
      incarnation's spans in it. Printed: one {"watch": ...} line (the
      routes' and verbs' ms, /metrics bytes and families, the watch
      store's sampling seconds over the allocator's cycle seconds);
   b. MultiJobRunner over two slots, co-scheduling that forces a
      decision: linear regression (examples/linear_regression.py) starts
      alone at min = max = 2 and holds both slots; once it posts hints,
      the LM (min = max = 1) is submitted and linear regression's bounds
      relaxed to 1..2 in one step, so Pollux must shrink it to place the
      LM. Checked: both Succeeded with exit 0 and hints, every launch
      carries out the last published allocation, linear regression ran
      2 then 1 replicas (exit 143, then 0) and its first restart came
      from the cycle that placed the LM, each incarnation resumed at the
      saved step, while both ran each held a slot, linear regression
      within 0.05 of its true weights, the LM's launches as in 10a.
      Printed: every restart with the cycle that caused it, the seconds
      from the LM's submit to the publish, the SIGTERM, the exit 143 and
      each job's first step.
   c. 10a's job and edits (step budget 140: the incumbent steps on
      through each warm-up window) with the warm successor
      (ADAPTDL_WARMUP_ENABLED, ADAPTDL_WARMUP_DEADLINE_S=120), the peer
      handoff (ADAPTDL_HANDOFF) and a journaled cluster state
      (ADAPTDL_SCHED_STATE_DIR). While the job trains at one rank, the
      runner's supervisor, allocator and state are stopped, a fresh state
      recovers from the journal and is served on the same port. Checked:
      the recovered job, allocation and candidate equal those before, no
      restart count or group moved, the lease reattached within the
      reconciliation window and a hint was accepted after it; both
      rescales adopted warm (events warm_spawn, warm_ready, signal, exit,
      launch, cutover; no discard; every successor rank's hold verdict
      go), each successor resumed at its predecessor's drain step with
      finite losses, sm90 launches in every incarnation and none of the
      f32 kernel, as in 10a. Printed: the restart (recovery ms, journal
      records replayed, torn records, reattach and first-hint seconds);
      each rescale's seconds from the edit to the publish, the warm
      spawn, ready, SIGTERM, exit 143, go and the successor's first step,
      its restore (seconds; bytes pulled and reused by the differential
      pull) and hold; the stall (the incumbent's last step to the
      successor's first) beside 10a's; the incumbent's median step while
      the successor warmed against before; the hint and heartbeat round
      trips with the journal against 10a's. 10a also prints its stall.
      10c reads the operator's surface as 10a does, after its last
      cutover.
   d. elastic tuning: tune.TrialScheduler runs three trials of
      examples/tune_trial.py (linear regression, lr 0.05, 0.02 and a
      hopeless 1e-6) on the card through the port's MultiJobRunner over
      three slots (one per trial: on two, a trial paused at its rung gate
      would hold its slot and the third could never reach the rung),
      halving at rungs of 2 results; beside it `python -m
      adaptdl_tpu_torch.cli submit examples/linear_regression.py --chips
      1` runs 3 epochs. 10d runs beside 10b (after 10a, before 10c): all
      its jobs are small, and the script's time limit has no room for it
      after 10c. Checked: the 1e-6 trial stopped at a rung and
      exited 143 after a checkpoint, the best trial one of the good two,
      DONE, its last loss under 0.1; submit exits 0 with weights within
      0.05 of the true ones. Printed: each trial's results, exits, first
      launch and run seconds, the order of the stops, and the tuner's
      and submit's seconds.
11. ZeRO storage modes: the full-width LM (12 x 768, 12 heads, seq 512,
   vocab 32000, bf16 compute, f32 params, remat, AdamW + AdamScale with
   the Adam-preconditioned statistics) from the same weights under
   dense and zero1 and zero3 (flash attention, the sm90 kernel), and
   under zero3_blocks (the per-layer ZeRO-3 LM, plain attention as the
   JAX example runs it) beside a dense run with plain attention, each
   its own bare train_step runs on the same batches with the launch
   counts reset just before and read just after (sm90: 24 per step, 0
   under plain attention; the f32 kernel 0) and per-rank peak memory
   (torch.cuda.max_memory_allocated) reset just before the steps:
   a. one rank, a fresh process whose process group is NCCL at world
      size 1, 4 steps at (32, 0): zero1 and zero3 held to the dense run,
      zero3_blocks to the dense plain-attention run, parameters within
      ZERO_PARAM_TOL of the largest and losses within ZERO_LOSS_RTOL
      (bit-equal expected: the element arithmetic is the same);
   b. two ranks on the one card over gloo (the launcher), ZERO_PAIR_STEPS
      (1) steps at (16, 0) each: the ranks' parameters bit-equal, each mode held to
      its dense reference as in 11a; per-rank resident and peak memory
      and the median step (host-staged collectives: correctness and
      memory, not a scaling figure);
   c. rescale, for zero1 and zero3_blocks, each through TrainerCheckpoint
      and through ShardedTrainerCheckpoint: two ranks (11b's launch, once
      its modes are done) take 2 steps and save, the launcher exits 143,
      a one-rank successor restores at the saved step with the saved
      parameters (canonical checksums) and takes 2 steps with finite
      losses; save and restore seconds.
   Each process draws the seed-0 weights once per model kind (the dense
   LM, the zero3 LM) through init_transformer / init_zero3_lm and loads
   them into its later trainers. 11a's process runs beside 11b's launch
   (neither reads the other's results), so their step times are taken
   side by side. The phase runs beside phase 12's worker processes.
12. the sequence axis: the full-width LM with inputs and targets aligned
   on the host (lm_pair_loss_fn), AdamW(3e-4) + AdamScale + the Adam
   preconditioner, bare train_step runs at (8, 0) from the seed-0
   weights, in modes "ulysses" (two all-to-all exchanges around the
   flash forward, the sm90 kernel, on the gathered sequence) and "ring"
   (the K/V rotation with its own blocked softmax). Per-rank peak memory
   reset just before the steps, launch counts and collective.TRAFFIC
   reset just before and read just after:
   a. one rank (a fresh process) runs each mode's one-rank counterpart
      (flash attention; plain attention) SEQ_STEPS (1) steps; beside
      it two ranks on the one card over gloo (the launcher,
      ADAPTDL_NUM_REPLICAS=2 ADAPTDL_SEQ_SHARDS=2: dp 1 x sp 2, each rank
      the example's rewrite to one replica) run each mode as many steps on the
      same batches, each comparison waiting for the one-rank run's file: finite
      losses, the ranks' parameters bit-equal, losses within SEQ_LOSS_RTOL
      and parameters within SEQ_PARAM_RL2 (the L2 norm of the difference
      over that of the one-rank run's update) of the one-rank run; sm90
      launches 24 per step on each rank under ulysses, 0 under ring, the
      f32 kernel 0. The sm90 kernel is timed at the gathered shape
      [8 * 6, 512, 64] against its plain version and bf16 SDPA.
   b. per-rank peak memory at seq 512 (a) and at seq 4096 (atomic 2, one
      step) for both modes, against one rank at the same global batch.
   c. checkpoint-restart sp 1 -> sp 2 -> sp 1 (ulysses with flash): one
      rank takes 2 steps and saves; the two ranks restore, resume at its
      step with its parameters (checksums), take a step and save; the
      one-rank process restores that.
   Host-staged collectives on one card: correctness and per-rank memory,
   not the seq axis's speed. Phase 11 runs beside phase 12's worker
   processes, started once phase 12 has timed its kernel in this process
   (neither reads the other's results).
13. the model and expert axes, and the ZeRO modes under a seq axis: two
   ranks on the one card over gloo (the launcher, ADAPTDL_NUM_REPLICAS=2),
   each run from the seed-0 full-width weights (every rank cut to its
   shards), AdamW + AdamScale + the Adam preconditioner, bare steps at
   (8, 0) on the same batches as a one-rank run (a fresh process beside
   them; each comparison waits for its file), launch counts and
   collective.TRAFFIC reset just before the steps and read just after,
   per-rank peak memory reset there too:
   a. dp 1 x tp 2 with --flash (the Megatron split, the sm90 kernel on
      each rank's 6 heads at [8 * 6, 512, 64]) against one rank with
      --flash: losses within AXES_LOSS_RTOL and the full parameters
      within AXES_PARAM_RL2 of the one-rank update; the replicated
      leaves bit-equal across the ranks; sm90 launches 24 per step on
      each rank, the f32 kernel 0; the model group's all-reduce bytes per
      step; the sm90 kernel timed at the local shape against its plain
      version (held by sm90_bound) and bf16 SDPA.
   b. the MoE LM (--flash --moe-experts 8 --moe-top-k 2, every second
      block; the example's 12 x 768) at dp 1 x ep 2 (switch_moe: each
      rank holds 4 of the 8 experts, an all-to-all each way) against
      one rank's dense_switch_moe at moe_dense_slices 2: the same
      bounds, the all-to-all bytes, per-rank peak.
   c. dp 1 x sp 2 (ring attention) under zero1, zero3 and zero3_blocks,
      AXES_STEPS steps each, against one rank in the same mode: ranks
      bit-equal and the same bounds.
   d. checkpoint-restart tp 2 -> tp 1 and ep 2 -> ep 1: the two ranks
      save a's and b's trainers after their steps (the full logical
      tensors, gathered in sync()); the one-rank process restores each
      and resumes at the saved step with the saved parameters
      (checksums).
   Host-staged collectives on one card: correctness and per-rank memory,
   not the axes' speed.
14. the stage axis: from the seed-0 full-width weights, plain attention
   (the pipelined blocks' own), AdamW + AdamScale + the Adam
   preconditioner, PIPE_STEPS bare steps at (8, 0) on raw token rows at
   M PIPE_MICRO, against a one-rank dense LM with plain attention on the
   same batches (a fresh process beside the launches; each comparison
   waits for its file); launch counts, collective.TRAFFIC and per-rank
   peak memory reset just before the steps and read just after:
   a. dp 1 x ss 2 under GPipe (two gloo ranks on the one card);
   b. dp 1 x ss 2 under the example's interleaved schedule (v 6);
   c. dp 1 x tp 2 x ss 2, interleaved (four gloo ranks);
   each: losses within AXES_LOSS_RTOL and the full parameters within
   AXES_PARAM_RL2 of the one-rank update, the replicated leaves and the
   gathered parameters bit-equal across the ranks, 0 launches of either
   flash kernel on every rank, ppermute and all-reduce bytes per step;
   d. checkpoint-restart: a's and b's trainers saved after their steps
      (the dense LM's tensors, gathered in sync()) and restored by the
      one-rank dense LM, which resumes at the saved step with the saved
      parameters (checksums); the one-rank save restored at ss 2.
   Host-staged collectives on one card: correctness, per-rank memory and
   bytes, not the stage axis's speed. Phase 14 runs beside phase 13's
   worker processes, started once phase 13 has timed its kernel in this
   process (neither reads the other's results). Every phase
   prints its seconds, then the whole run's.
15. result: the kernels line, the card line, then the device line. Each
   kernel row's "launches" is its count in the main path's steps (0 for
   the f32 kernel, which the bf16 path does not run); "check_launches"
   is its count in the flash-vs-dense model check; "multi_replica_
   launches" its count on each rank of 5a, "rescaled_launches" in 5c,
   "supervised_launches" in phase 6, "zoo_launches" in each path of
   phase 7, "rescale_launches" in each incarnation of phase 8 and
   "options_launches" in each part of phase 9 (its MoE LM's steps and
   calibration alone under "moe_lm_steps"; per bare step under each remat
   policy under "remat_per_step"), "control_launches" on each rank of
   each incarnation of 10a, "control_warm_launches" of 10c, and
   "zero_launches" in each mode of 11a and
   on each rank of 11b, and "seq_launches" on each rank of each mode of
   12a (the sm90 row's "seq_gathered" is its time at 12a's gathered
   shape), "tp_launches" on each rank of 13a and 13b (the sm90 row's
   "tp_local" is its time at 13a's local shape), and
   "pipeline_launches" on each rank of 14a-14c (0: plain attention). The
   sm90 row is timed on bf16 and the f32 kernel's on f32, each with its
   own bound (the f32 kernel's: 3xTF32 at TF32's peak), plain version and
   SDPA on the same inputs; the f32 row's "bf16_input_ms" is the f32
   kernel on the bf16 main-shape input, "bf16_d40"/"bf16_d96" its times
   on bf16 at those head dims, "mma_sync_tflops" the probe's rate,
   "mma_sync_floor_ms" the 3xTF32 work at that rate and
   "library_kernels" the device kernels of f32 SDPA.
"""

import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM tensor cores, dense
PEAK_TF32_FLOPS = 495e12  # H100 SXM tensor cores, dense
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

# Rate probe: independent mma.sync m16n8k8 TF32 products, 16 accumulators a
# warp, 4 blocks of 4 warps on every SM; no loads, no other instructions.
MMA_PROBE_SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_probe(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7 + i;
  const uint32_t b0 = threadIdx.x, b1 = threadIdx.x + 1;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int c = 0; c < 16; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_probe_launch(void* out, int blocks, int iters, void* stream) {
  mma_probe<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
'''


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {message}")


def cuda_ms(fn, iters):
    """Mean milliseconds per call over ``iters`` calls (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(x):
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(
        f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}"
    )
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def ptxas_report(log):
    """Registers and spill-store bytes of each kernel instance (by its
    mangled entry name) in a ptxas -v report."""
    entry, report = None, {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            report[entry] = {"registers": None, "spill_bytes": 0}
        elif entry is None:
            continue
        elif "spill stores" in line:
            found = re.search(r"(\d+) bytes spill stores", line)
            report[entry]["spill_bytes"] = int(found.group(1))
        elif "Used" in line and "registers" in line:
            report[entry]["registers"] = int(line.split("Used")[1].split()[0])
    return report


def phase_build():
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    start = time.perf_counter()
    built = _build.build_all()
    print(f"build: {sorted(built)} in {time.perf_counter() - start:.1f} s")
    check({KERNEL, KERNEL_SM90} <= set(built), "a flash library did not build")
    report = ptxas_report(_build.build_log(KERNEL))
    registers = {n: r["registers"] for n, r in report.items()}
    spilled = {
        n: r["spill_bytes"] for n, r in report.items() if r["spill_bytes"]
    }
    f32_smem = _build.load(KERNEL).adaptdl_flash_attention_fwd_smem_bytes
    f32_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    f32_smem.restype = ctypes.c_int
    print(
        f"build: {KERNEL}: {len(report)} kernel instances, "
        f"{len(spilled)} spill {spilled}; registers per thread "
        f"{min(registers.values())}-{max(registers.values())}"
    )
    for name, r in sorted(report.items()):
        head_dim = int(re.search(r"Li(\d+)E", name).group(1))
        dtype = 1 if "bfloat16" in name else 0
        print(
            f"build: {KERNEL} {('f32', 'bf16')[dtype]} head_dim {head_dim}: "
            f"{r['registers']} registers per thread, {r['spill_bytes']} bytes "
            f"spilled, {f32_smem(head_dim, dtype)} bytes shared memory"
        )
        if head_dim == 64:
            check(r["spill_bytes"] == 0, f"{KERNEL} head_dim 64 spills")
    lib = _build.load(KERNEL_SM90)
    smem = lib.adaptdl_flash_attention_fwd_sm90_smem_bytes
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_int
    for name, r in sorted(ptxas_report(_build.build_log(KERNEL_SM90)).items()):
        head_dim = int(re.search(r"ILi(\d+)E", name).group(1))
        print(
            f"build: {KERNEL_SM90} head_dim {head_dim}: {r['registers']} "
            f"registers per thread, {r['spill_bytes']} bytes spilled, "
            f"{smem(head_dim)} bytes shared memory"
        )


def sm90_bound(q, k, v, causal, ref, ref_lse):
    """Per-element bound on |sm90 kernel - plain version| (bf16 inputs).

    Scores agree up to f32 summation order (bf16 products are exact in
    f32). The kernel then rounds P to bf16 before P V: each p_ij moves by
    at most 2^-9 p_ij, so o_id moves by at most 2^-9 w_id with w_id =
    sum_j p_ij |v_jd| (p normalised, rebuilt here from the plain
    version's lse). Both outputs are then rounded to bf16, together at
    most one bf16 ulp at |ref_id| + 2^-9 w_id. The bound takes the P term
    twice, for f32 summation order: 2^-8 w + ulp(|ref| + 2^-8 w)."""
    from adaptdl_tpu_torch.ops.flash_attention import NEG_INF

    seq, head_dim = q.shape[1:]
    s = (q.float() * head_dim**-0.5) @ k.float().transpose(1, 2)
    if causal:
        above = torch.ones(seq, seq, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    w = torch.exp(s - ref_lse[..., None]) @ v.float().abs()
    magnitude = ref.float().abs() + 2.0**-8 * w
    ulp = torch.exp2(torch.floor(torch.log2(magnitude.clamp_min(2.0**-126))) - 7)
    return 2.0**-8 * w + ulp


def mma_sync_tf32_tflops():
    """The card's rate for mma.sync m16n8k8 in TF32 (TFLOP/s), from
    MMA_PROBE_SOURCE built with nvcc into a temporary directory."""
    from adaptdl_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory(prefix="adaptdl-mma-probe-") as tmp:
        src = os.path.join(tmp, "mma_probe.cu")
        lib_path = os.path.join(tmp, "mma_probe.so")
        with open(src, "w") as f:
            f.write(MMA_PROBE_SOURCE)
        subprocess.run(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", lib_path, src],
            check=True, capture_output=True,
        )
        lib = ctypes.CDLL(lib_path)
    fn = lib.mma_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    out = torch.empty(blocks * 128, device="cuda")

    def launch():
        err = fn(out.data_ptr(), blocks, iters,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"mma probe launch failed: CUDA error {err}")

    ms = cuda_ms(launch, 3)
    flops = 2 * 16 * 8 * 8 * 16 * iters * (blocks * 4)
    return flops / (ms * 1e-3) / 1e12


def device_kernels(fn, calls):
    """{kernel name: device microseconds per call} of ``fn`` from a
    torch.profiler window of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
            e, "is_user_annotation", False
        ):
            span = e.time_range.end - e.time_range.start
            totals[e.name] = totals.get(e.name, 0.0) + span / calls
    return totals


def phase_flash():
    """Both flash forward kernels vs their plain version, gradients,
    times. Returns the kernel rows of the result line."""
    import torch.nn.functional as F

    from adaptdl_tpu_torch.models.transformer import causal_attention
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import (
        KERNEL,
        KERNEL_SM90,
        _launch,
        flash_attention,
        flash_attention_fwd,
        flash_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(shape, dtype):
        return [
            torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)
        ]

    def compare(kernel, label, q, k, v, causal, block, out, lse):
        ref, ref_lse = flash_attention_reference(
            q, k, v, causal, None, block, block
        )
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if kernel == KERNEL_SM90:
            bound = sm90_bound(q, k, v, causal, ref, ref_lse)
            ratio = (diff / bound).max().item()
            rule = (
                f"per-element bound, median {bound.median().item():.3g}, "
                f"max err/bound {ratio:.3g}"
            )
            ok = ratio <= 1
        else:
            # f32: summation order only. bf16: both round an f32 result
            # to bf16, one bf16 ulp at the output's scale.
            tol = (
                2e-5 if q.dtype == torch.float32
                else bf16_ulp(ref.float().abs().max().item())
            )
            rule = f"tol {tol:.3g}"
            ok = err <= tol
        print(
            f"{label} {tuple(q.shape)} {str(q.dtype)[6:]} causal={causal}: "
            f"max|out-plain|={err:.3g} ({rule}), "
            f"max|lse-plain|={lse_err:.3g} (tol 1e-4)"
        )
        check(ok and lse_err <= 1e-4, f"{label} disagrees")
        return err

    def through_wrapper(shape, dtype, causal, block, want):
        """flash_attention_fwd on fresh inputs; checks that exactly the
        kernel ``want`` launched, once, and agrees with the plain version."""
        q, k, v = qkv(shape, dtype)
        before = dict(_build.LAUNCHES)
        out, lse = flash_attention_fwd(q, k, v, causal, None, block, block)
        torch.cuda.synchronize()
        moved = {
            n: c - before.get(n, 0) for n, c in _build.LAUNCHES.items()
            if c != before.get(n, 0)
        }
        check(moved == {want: 1}, f"{shape} {dtype} launched {moved}")
        compare(want, want, q, k, v, causal, block, out, lse)

    main_shape = (32 * 12, 512, 64)  # B*H, S, D of the main path
    errs = {}
    # sm90 kernel: the main shape, head_dim 128, a ragged seq with a
    # small bh.
    for shape, block in (
        (main_shape, 128), ((8, 256, 128), 128), ((3, 100, 64), 100),
        ((2, 100, 128), 100),
    ):
        for causal in (True, False):
            through_wrapper(shape, torch.bfloat16, causal, block, KERNEL_SM90)
    # f32 kernel: f32 at the main shape, at S 512 with a small bh, at the
    # smallest and largest head dims and one that is not a power of two,
    # a ragged seq; bf16 at head_dim 40 (ragged) and 96.
    for shape, dtype, block in (
        (main_shape, torch.float32, 128), ((8, 128, 64), torch.float32, 64),
        ((8, 512, 64), torch.float32, 128), ((4, 256, 8), torch.float32, 128),
        ((4, 256, 72), torch.float32, 128), ((4, 256, 128), torch.float32, 128),
        ((3, 100, 120), torch.float32, 100),
        ((3, 100, 40), torch.bfloat16, 100),
        ((4, 256, 96), torch.bfloat16, 128),
    ):
        for causal in (True, False):
            through_wrapper(shape, dtype, causal, block, KERNEL)
    # Both kernels on one bf16 main-shape input.
    q, k, v = qkv(main_shape, torch.bfloat16)
    for name in (KERNEL_SM90, KERNEL):
        out, lse = _launch(name, q, k, v, True, None)
        torch.cuda.synchronize()
        errs[name] = compare(name, name, q, k, v, True, 128, out, lse)

    # Gradient through the autograd Function vs dense autograd.
    for shape, dtype, block, atol, rtol in (
        ((2, 4, 128, 64), torch.float32, 64, 5e-5, 5e-4),
        # 512-term sums instead of 128: a looser bound.
        ((32, 12, 512, 64), torch.float32, 128, 1e-4, 1e-3),
        # bf16 (the sm90 kernel's out and lse) against dense autograd in
        # f32 on the same bf16 values: out, its gradient and dq/dk/dv are
        # each rounded to 8 significant bits, and the backward's row term
        # sums 64 products of rounded values, so errors reach a few units
        # of 2^-8 of the gradient's scale; 2^-5 max|grad| bounds that.
        ((2, 4, 128, 64), torch.bfloat16, 64, None, None),
    ):
        q, k, v = (
            t.reshape(shape).requires_grad_()
            for t in qkv((shape[0] * shape[1],) + shape[2:], dtype)
        )
        before = dict(_build.LAUNCHES)
        flash_out = flash_attention(q, k, v, True, None, block, block)
        got = torch.autograd.grad(
            (flash_out.float() * torch.cos(flash_out.float())).sum(),
            (q, k, v),
        )
        want_kernel = KERNEL_SM90 if dtype == torch.bfloat16 else KERNEL
        check(
            _build.LAUNCHES[want_kernel] == before.get(want_kernel, 0) + 1,
            f"flash grad {shape} {dtype} did not run {want_kernel}",
        )
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        dense_out = causal_attention(*ref, causal=True)
        want = torch.autograd.grad(
            (dense_out * torch.cos(dense_out)).sum(), ref
        )
        for g, w, name in zip(got, want, "qkv"):
            g = g.float()
            if atol is None:
                bound = 2.0**-5 * w.abs().max().item()
                bad = (g - w).abs() > bound
                rule = f"tol 2^-5 max|grad| = {bound:.3g}"
            else:
                bad = (g - w).abs() > atol + rtol * w.abs()
                rule = f"atol {atol}, rtol {rtol}"
            print(
                f"flash grad d{name} {shape} {str(dtype)[6:]}: max err "
                f"{(g - w).abs().max().item():.3g} ({rule})"
            )
            check(not bad.any().item(), f"flash gradient d{name} disagrees")

    # Times at the main path's shape (causal), all in this run: the sm90
    # kernel on bf16, the f32 kernel on f32 (its own dtype; it also takes
    # the bf16 input, timed beside for the earlier rows), each with the
    # plain version and SDPA on the same inputs (TF32 off, as the port
    # runs).
    q, k, v = qkv(main_shape, torch.bfloat16)
    qf, kf, vf = (t.float() for t in (q, k, v))
    ms = cuda_ms(lambda: _launch(KERNEL_SM90, q, k, v, True, None), 50)
    f32_kernel_ms = cuda_ms(lambda: _launch(KERNEL, qf, kf, vf, True, None), 20)
    f32_kernel_bf16_ms = cuda_ms(lambda: _launch(KERNEL, q, k, v, True, None), 20)
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, True), 5)
    f32_plain_ms = cuda_ms(lambda: flash_attention_reference(qf, kf, vf, True), 5)

    def sdpa(a, b, c):
        a, b, c = (t.reshape(32, 12, 512, -1) for t in (a, b, c))
        return lambda: F.scaled_dot_product_attention(a, b, c, is_causal=True)

    library_ms = cuda_ms(sdpa(q, k, v), 50)
    f32_library_ms = cuda_ms(sdpa(qf, kf, vf), 20)
    noncausal_ms = cuda_ms(
        lambda: _launch(KERNEL_SM90, q, k, v, False, None), 50
    )
    f32_noncausal_ms = cuda_ms(
        lambda: _launch(KERNEL, qf, kf, vf, False, None), 20
    )
    # Which kernels f32 SDPA runs (TF32 off): the f32 row's yardstick.
    sdpa_kernels = device_kernels(sdpa(qf, kf, vf), 5)
    print(
        "f32 sdpa device kernels, us per call: "
        + ("; ".join(f"{n} {us:.1f}" for n, us in sorted(
            sdpa_kernels.items(), key=lambda kv: -kv[1]))
           or "none seen by the profiler (not measured)")
    )
    mma_tflops = mma_sync_tf32_tflops()
    bh, seq, head_dim = main_shape
    # Visible (query, key) pairs under the causal mask; two products of
    # 2*D operations each.
    flops = 4 * head_dim * bh * seq * (seq + 1) / 2

    def bound(element_bytes, peak_flops, products=1, d=head_dim):
        nbytes = 4 * bh * seq * d * element_bytes + bh * seq * 4
        by_flops = products * flops * d / head_dim / peak_flops * 1e3
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        return nbytes, {
            "bound_ms": max(by_flops, by_bytes),
            "bound_by": "operations" if by_flops > by_bytes else "bytes",
        }

    nbytes, bf16_bound = bound(2, PEAK_BF16_FLOPS)
    # The f32 kernel runs three TF32 products (3xTF32) per product.
    f32_bytes, f32_bound = bound(4, PEAK_TF32_FLOPS, products=3)
    _, f32_cuda_core_bound = bound(4, PEAK_F32_FLOPS)
    mma_sync_floor_ms = 3 * flops / (mma_tflops * 1e12) * 1e3
    print(
        f"flash fwd times (causal {main_shape}): bf16: {KERNEL_SM90} "
        f"{ms:.4f} ms, non-causal {noncausal_ms:.4f} ms; {KERNEL} "
        f"{f32_kernel_bf16_ms:.4f} ms; plain {plain_ms:.4f} ms; sdpa "
        f"{library_ms:.4f} ms; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB, "
        f"bound {bf16_bound}. f32: {KERNEL} {f32_kernel_ms:.4f} ms, "
        f"non-causal {f32_noncausal_ms:.4f} ms; plain {f32_plain_ms:.4f} ms; "
        f"sdpa {f32_library_ms:.4f} ms; {f32_bytes / 1e6:.2f} MB, 3xTF32 "
        f"bound {f32_bound} (on the CUDA cores, as before: "
        f"{f32_cuda_core_bound}); mma.sync TF32 rate {mma_tflops:.1f} TFLOP/s, "
        f"3xTF32 at that rate {mma_sync_floor_ms:.4f} ms"
    )
    # The f32 kernel's bf16 route at head dims the sm90 kernel does not
    # take, beside the plain version and bf16 SDPA on the same inputs.
    other_dims = {}
    for d in (40, 96):
        qo, ko, vo = qkv((bh, seq, d), torch.bfloat16)
        before = _build.LAUNCHES[KERNEL]
        flash_attention_fwd(qo, ko, vo, True, None, 128, 128)
        check(_build.LAUNCHES[KERNEL] == before + 1,
              f"bf16 head_dim {d} did not take {KERNEL}")
        other_dims[f"bf16_d{d}"] = {
            "ms": cuda_ms(lambda: _launch(KERNEL, qo, ko, vo, True, None), 20),
            "plain_ms": cuda_ms(
                lambda: flash_attention_reference(qo, ko, vo, True), 5
            ),
            "library_ms": cuda_ms(sdpa(qo, ko, vo), 20),
            **bound(2, PEAK_BF16_FLOPS, d=d)[1],
        }
        print(f"{KERNEL} bf16 (causal {(bh, seq, d)}): {other_dims[f'bf16_d{d}']}")
    common = {
        "route": "cuda",
        "replaces": "adaptdl_tpu/ops/flash_attention.py:57",
        "launches": None,
    }
    return [
        {"name": KERNEL_SM90,
         "source": f"adaptdl_tpu_torch/csrc/{KERNEL_SM90}.cu",
         "max_abs_err": errs[KERNEL_SM90], "ms": ms, "plain_ms": plain_ms,
         "library_ms": library_ms, **bf16_bound, **common},
        {"name": KERNEL, "source": f"adaptdl_tpu_torch/csrc/{KERNEL}.cu",
         "max_abs_err": errs[KERNEL], "ms": f32_kernel_ms,
         "plain_ms": f32_plain_ms, "library_ms": f32_library_ms,
         "bf16_input_ms": f32_kernel_bf16_ms,
         "noncausal_ms": f32_noncausal_ms,
         "mma_sync_tflops": mma_tflops,
         "mma_sync_floor_ms": mma_sync_floor_ms,
         "library_kernels": sorted(sdpa_kernels, key=sdpa_kernels.get,
                                   reverse=True)[:3],
         **other_dims, **f32_bound, **common},
    ]


def phase_main_path(kernel_rows):
    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import checkpoint, epoch, metrics
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.examples.transformer_lm import (
        lm_config,
        synthetic_tokens,
    )
    from adaptdl_tpu_torch.models import (
        TransformerLM,
        init_transformer,
        lm_loss_fn,
    )
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    ckpt_dir = tempfile.mkdtemp(prefix="adaptdl-torch-smoke-")
    os.environ["ADAPTDL_CHECKPOINT_PATH"] = ckpt_dir
    try:
        device = adaptdl_tpu_torch.initialize_job(device="cuda")
        seq_len = 512
        config = lm_config(cpu=False, seq_len=seq_len, flash=True)

        def build(seed):
            model = init_transformer(config, seed=seed, device=device)
            trainer = ElasticTrainer(
                lm_loss_fn, model, AdamW(model.parameters(), lr=3e-4),
                init_batch_size=32, scaling_rule=AdamScale(),
                precondition="adam", device=device,
            )
            holder = {"state": trainer.init_state()}
            ckpt = trainer.make_checkpoint_state(
                lambda: holder["state"],
                lambda s: holder.__setitem__("state", s),
            )
            return model, trainer, holder, ckpt

        model, trainer, holder, ckpt = build(seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        check(not checkpoint.load_state(ckpt), "fresh run found a checkpoint")
        metrics.ensure_checkpoint_registered()
        dataset = synthetic_tokens(1024, seq_len, config.vocab_size)
        loader = AdaptiveDataLoader(dataset, batch_size=32)
        per_pass = config.num_layers * 2  # forward + remat recompute
        plan = [(32, 0)] * 10 + [(16, 1)] * 4
        losses, step_s = [], []

        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        for _ in epoch.remaining_epochs_until(1):
            for batch in loader:
                i = len(losses)
                before = _build.LAUNCHES[KERNEL_SM90]
                calibrations = len(trainer._calibrated)
                torch.cuda.synchronize()
                start = time.perf_counter()
                holder["state"], m = trainer.run_step(
                    holder["state"], batch, loader
                )
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - start)
                calibrated = len(trainer._calibrated) - calibrations
                accum = loader.current_accum_steps
                check(
                    (loader.current_atomic_bsz, accum) == plan[i],
                    f"step {i} ran {loader.current_atomic_bsz, accum}",
                )
                expected = per_pass * (
                    accum + 1
                    + calibrated * (trainer.calibrate_repeats + 1)
                )
                got = _build.LAUNCHES[KERNEL_SM90] - before
                check(
                    got == expected,
                    f"step {i}: {got} flash launches, expected {expected}",
                )
                check(
                    _build.LAUNCHES[KERNEL] == 0,
                    f"step {i}: the bf16 main path launched {KERNEL}",
                )
                losses.append(float(m["loss"]))
                if i + 1 == 10:
                    loader.apply_retune(16, 1)
                if i + 1 == len(plan):
                    break
        # The main path's launches, the only ones the kernel rows report:
        # the f32 kernel is off the bf16 path and shows 0.
        launches = {n: _build.LAUNCHES[n] for n in (KERNEL_SM90, KERNEL)}
        check(launches[KERNEL_SM90] > 0, f"{KERNEL_SM90} never launched")
        peak_mem = torch.cuda.max_memory_allocated()
        stats = {k: float(v) for k, v in m.items()}
        print(f"main path: {n_params / 1e6:.1f} M params, losses {losses}")
        print(f"main path: last step statistics {stats}")
        check(all(math.isfinite(x) for x in losses), "non-finite loss")
        check(
            sum(losses[-3:]) / 3 < losses[0],
            f"loss did not fall: {losses[0]} -> {losses[-3:]}",
        )
        check(
            all(math.isfinite(stats[k]) for k in
                ("grad_sqr", "grad_var", "gain", "progress")),
            "non-finite noise statistics",
        )
        check(
            int(holder["state"].step) == len(plan),
            f"step counter {int(holder['state'].step)}",
        )
        steady = sorted(step_s[1:10])[len(step_s[1:10]) // 2]
        print(
            f"main path: step {steady * 1e3:.1f} ms (median of steps 2-10, "
            f"accum 0, batch 32x{seq_len}), "
            f"{32 * seq_len / steady:.0f} tokens/s, "
            f"first step (with calibration) {step_s[0] * 1e3:.1f} ms, "
            f"peak memory {peak_mem / 2**30:.2f} GiB"
        )
        print(f"main path: step times ms {[round(s * 1e3, 1) for s in step_s]}")

        # The flash model against the dense-attention model on 2 x 512
        # tokens, in f32 (the f32 kernel) and in bf16 (the sm90 kernel):
        # one forward launch per layer each.
        tokens = torch.as_tensor(dataset["tokens"][:2, :-1], device=device)
        logits = {}
        _build.reset_launches()
        with torch.no_grad():
            for dtype in (torch.float32, torch.bfloat16):
                for name, attention_fn in (
                    ("flash", config.attention_fn), ("dense", None),
                ):
                    twin = TransformerLM(dataclasses.replace(
                        config, dtype=dtype, attention_fn=attention_fn,
                    )).to(device)
                    twin.load_state_dict(model.state_dict())
                    logits[name, dtype] = twin(tokens).float()
        check_launches = dict(_build.LAUNCHES)
        check(
            check_launches == {
                KERNEL: config.num_layers, KERNEL_SM90: config.num_layers,
            },
            f"model check launched {check_launches}",
        )
        f32, bf16 = torch.float32, torch.bfloat16
        err = (logits["flash", f32] - logits["dense", f32]).abs().max().item()
        # f32: accumulation order only.
        print(f"model: max|logits flash - dense| (f32) = {err:.3g} (tol 1e-3)")
        check(
            logits["flash", f32].shape == (2, seq_len, config.vocab_size)
            and torch.isfinite(logits["flash", f32]).all().item()
            and err <= 1e-3,
            "flash model disagrees with the dense model (f32)",
        )
        # bf16: rounding to bf16 alone moves the dense model's logits by
        # e = max|dense bf16 - dense f32|. A right kernel changes where
        # bf16 rounds, not how much, so the flash model stays within 2e of
        # the dense bf16 model.
        err = (logits["flash", bf16] - logits["dense", bf16]).abs().max().item()
        e = (logits["dense", bf16] - logits["dense", f32]).abs().max().item()
        print(
            f"model: max|logits flash - dense| (bf16) = {err:.3g} "
            f"(tol 2 x {e:.3g}, bf16's own error)"
        )
        check(
            torch.isfinite(logits["flash", bf16]).all().item()
            and err <= 2 * e,
            "flash model disagrees with the dense model (bf16)",
        )
        for row in kernel_rows:
            row["launches"] = launches[row["name"]]
            row["check_launches"] = check_launches[row["name"]]

        # Checkpoint -> a fresh trainer, bit for bit.
        start = time.perf_counter()
        saved = checkpoint.save_all_states()
        save_s = time.perf_counter() - start
        ckpt.unregister()
        model2, trainer2, holder2, ckpt2 = build(seed=1)
        start = time.perf_counter()
        check(checkpoint.load_state(ckpt2), "checkpoint did not restore")
        load_s = time.perf_counter() - start
        a, b = holder["state"], holder2["state"]
        for (name, p), q in zip(
            model.state_dict().items(), model2.state_dict().values()
        ):
            check(torch.equal(p, q), f"restored parameter {name} differs")
        for p, q in zip(trainer.optimizer.params(), trainer2.optimizer.params()):
            s1, s2 = trainer.optimizer.state[p], trainer2.optimizer.state[q]
            check(
                all(torch.equal(s1[k], s2[k]) for k in s1),
                "restored optimizer state differs",
            )
        g1, g2 = a.gns.tensors(), b.gns.tensors()
        for k in g1:
            pair = zip(g1[k], g2[k]) if k == "prev_grad" else [(g1[k], g2[k])]
            check(all(torch.equal(x, y) for x, y in pair), f"restored gns.{k} differs")
        check(
            torch.equal(a.step, b.step) and torch.equal(a.progress, b.progress),
            "restored step/progress differ",
        )
        print(
            f"checkpoint: {os.path.basename(saved)} saved in {save_s:.1f} s, "
            f"restored bit-equal in {load_s:.1f} s (step {int(b.step)})"
        )
        metrics.join_fit()
        return steady
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# -- the supervisor recorder (phases 5 and 6) -----------------------------

PAIR_JOB = "smoke/pair"
SUPERVISED_JOB = "smoke/guarded"


class SupervisorRecorder:
    """A stand-in for the supervisor's job-facing routes on the standard
    library's HTTP server, in a thread. It records every request and
    answers as the supervisor does: ``PUT /register`` and the
    ``GET /discover`` long poll (per restart group), ``PUT /heartbeat``,
    ``PUT /hints`` (checked with the port's ``validate_hints``: 400 when
    it refuses), ``GET /config`` (the job's allocation, its batchConfig
    once :meth:`serve_batch_config` was called, its traceParent once
    :meth:`serve_trace_parent` was), ``POST /incident``, ``PUT`` and
    ``GET /handoff`` (a shard server's advertisement, kept per job unless
    its group is older), ``POST /preempt`` (a notice: the job drains and
    takes the notice's traceParent) and ``PUT /trace`` (spans, kept per
    job). Jobs are ``{job_id: allocation}``."""

    def __init__(self, jobs):
        self.jobs = dict(jobs)
        self.cond = threading.Condition()
        self.requests = []  # guarded-by: cond
        self.workers = {}  # (job, group) -> {rank: address}; guarded-by: cond
        self.batch_config = {}  # job -> batchConfig; guarded-by: cond
        self.trace_parent = {}  # job -> traceParent; guarded-by: cond
        self.handoff = {}  # job -> {"url", "group"}; guarded-by: cond
        self.spans = {}  # job -> [span]; guarded-by: cond
        self.server = None
        self.thread = None
        self.url = None

    def start(self) -> str:
        recorder = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _answer(self):
                parts = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(parts.query))
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                body = json.loads(raw) if raw else None
                status, reply = recorder.handle(
                    self.command, parts.path.strip("/").split("/"), query, body
                )
                data = json.dumps(reply).encode()
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # a client that stopped waiting (an exiting worker)

            do_GET = do_PUT = do_POST = _answer

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(
            target=self.server.serve_forever, name="supervisor-recorder"
        )
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        return self.url

    def stop(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.thread.join(10)

    def serve_batch_config(self, job, config):
        with self.cond:
            self.batch_config[job] = dict(config)

    def serve_trace_parent(self, job, traceparent):
        with self.cond:
            self.trace_parent[job] = traceparent

    def handle(self, method, path, query, body):
        """(status, reply) for one request; every request is recorded."""
        from adaptdl_tpu_torch import sched_hints

        route, job, rest = path[0], "/".join(path[1:3]), path[3:]
        status, reply = 404, {"error": "no such route"}
        if job in self.jobs:
            status, reply = 200, {"ok": True}
            if (method, route) == ("PUT", "register"):
                group, rank = int(rest[0]), int(rest[1])
                with self.cond:
                    self.workers.setdefault((job, group), {})[rank] = body["address"]
                    self.cond.notify_all()
            elif (method, route) == ("GET", "discover"):
                group, want = int(rest[0]), int(query.get("replicas", 0))
                with self.cond:
                    self.cond.wait_for(
                        lambda: len(self.workers.get((job, group), {})) >= want,
                        timeout=60,
                    )
                    workers = dict(self.workers.get((job, group), {}))
                if len(workers) >= want:
                    reply = {str(r): a for r, a in workers.items()}
                else:
                    status, reply = 408, {"error": "discover timeout"}
            elif (method, route) == ("PUT", "hints"):
                try:
                    sched_hints.validate_hints(body)
                except (ValueError, TypeError) as exc:
                    status, reply = 400, {"error": str(exc)}
            elif (method, route) == ("GET", "config"):
                with self.cond:
                    reply = {
                        "allocation": self.jobs[job],
                        "topology": None,
                        "batchConfig": self.batch_config.get(job),
                        "retunes": int(job in self.batch_config),
                        "group": 0,
                        "traceParent": self.trace_parent.get(job),
                    }
            elif (method, route) == ("POST", "incident"):
                if not (body or {}).get("kind"):
                    status, reply = 400, {"error": "kind required"}
            elif (method, route) == ("PUT", "handoff"):
                with self.cond:
                    known = self.handoff.get(job)
                    if known and int(body["group"]) < known["group"]:
                        status, reply = 404, {"error": "stale group"}
                    else:
                        self.handoff[job] = {
                            "url": body["url"], "group": int(body["group"]),
                        }
            elif (method, route) == ("GET", "handoff"):
                with self.cond:
                    reply = dict(self.handoff.get(job) or {})
            elif (method, route) == ("POST", "preempt"):
                with self.cond:
                    if (body or {}).get("traceParent"):
                        self.trace_parent[job] = body["traceParent"]
                reply = {"ok": True, "draining": True}
            elif (method, route) == ("PUT", "trace"):
                with self.cond:
                    self.spans.setdefault(job, []).extend((body or {}).get("spans") or [])
            elif (method, route) != ("PUT", "heartbeat"):
                status, reply = 404, {"error": "no such route"}
        elif route in ("register", "discover", "heartbeat", "hints",
                       "config", "incident", "handoff", "preempt", "trace"):
            reply = {"error": "no such job"}
        with self.cond:
            self.requests.append({
                "method": method, "route": route, "job": job, "rest": rest,
                "query": query, "body": body, "status": status,
                "time": time.monotonic(),
            })
        return status, reply

    def seen(self, job, route, status=200):
        with self.cond:
            return [
                r for r in self.requests
                if r["job"] == job and r["route"] == route
                and r["status"] == status
            ]


# -- phase 5: multi-replica ----------------------------------------------

PAIR_STEPS = 6  # rank 1 raises its exit flag after PAIR_STEPS - 1
SUCCESSOR_STEPS = 4


def state_checksums(model, optimizer, gns_state):
    """One int64 per tensor of the parameters, Adam's moments and the
    noise statistics: the sum of its elements' bit patterns, which any
    changed bit moves."""
    tensors = list(model.state_dict().values())
    for p in optimizer.params():
        tensors += [optimizer.state[p][k] for k in ("exp_avg", "exp_avg_sq")]
    fields = gns_state.tensors()
    tensors += fields.pop("prev_grad") + list(fields.values())
    sums = [
        (t.contiguous().view(torch.int32) if t.element_size() == 4
         else t.to(torch.int64)).sum(dtype=torch.int64)
        for t in tensors
    ]
    return torch.stack(sums).tolist()


def replica_run(root, successor):
    """One replica of phase 5a/b (``successor`` false) or 5c, started by
    the launcher; writes its report to ``root``."""
    import torch.distributed as dist

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import (
        _signal, bootstrap, checkpoint, collective, env, epoch, metrics,
    )
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.examples.transformer_lm import lm_config, synthetic_tokens
    from adaptdl_tpu_torch.models import init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    # The host the process group is joined at: rank 0's address as the
    # supervisor's /discover gave it.
    joined = {}
    join = collective.initialize

    def recorded_join(addr, port, **kwargs):
        joined["host"] = addr
        return join(addr, port, **kwargs)

    collective.initialize = recorded_join
    device = adaptdl_tpu_torch.initialize_job(device="cuda")
    rank, replicas = env.process_rank(), env.num_replicas()
    name = f"rank {rank} of {replicas}"
    backend = dist.get_backend() if collective.initialized() else None
    check(
        (backend is None) == (replicas == 1),
        f"{name}: process group {backend}",
    )
    config = lm_config(cpu=False, seq_len=512, flash=True)
    model = init_transformer(config, seed=0, device=device)
    trainer = ElasticTrainer(
        lm_loss_fn, model, AdamW(model.parameters(), lr=3e-4),
        init_batch_size=32, scaling_rule=AdamScale(), precondition="adam",
        device=device,
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    start = time.perf_counter()
    restored = checkpoint.load_state(ckpt)
    restore_s = time.perf_counter() - start
    check(restored == successor, f"{name}: restored={restored}")
    metrics.ensure_checkpoint_registered()
    loader = AdaptiveDataLoader(
        synthetic_tokens(1024, 512, config.vocab_size), batch_size=32
    )
    report = {
        "rank": rank, "backend": backend, "device": str(device),
        "address": bootstrap._local_address(), "group_host": joined.get("host"),
        "position": [loader.sampler.epoch, loader.sampler.index],
        "restore_s": restore_s, "steps": [], "hint_posts": [],
    }
    post = metrics.sched_hints.post_sched_hints

    def counted_post(hints):
        ok = post(hints)
        report["hint_posts"].append(ok)
        return ok

    metrics.sched_hints.post_sched_hints = counted_post
    if successor:
        with open(os.path.join(root, "pair-rank0.json")) as f:
            saved = json.load(f)
        check(
            state_checksums(model, trainer.optimizer, holder["state"].gns)
            == saved["checksums"],
            f"{name}: restored state differs from what rank 0 saved",
        )
        check(
            report["position"] == [0, PAIR_STEPS * 32],
            f"{name}: resumed at {report['position']}",
        )
    print(
        f"multi-replica {name}: backend {backend}, {device}, restored "
        f"{restored} in {restore_s:.2f} s, position {report['position']}",
        flush=True,
    )
    per_pass = config.num_layers * 2  # forward + remat recompute
    torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launches()
    stop_start = None
    try:
        for _ in epoch.remaining_epochs_until(1):
            for batch in loader:
                before = _build.LAUNCHES[KERNEL_SM90]
                calibrations = len(trainer._calibrated)
                torch.cuda.synchronize(device)
                start = time.perf_counter()
                holder["state"], m = trainer.run_step(
                    holder["state"], batch, loader
                )
                torch.cuda.synchronize(device)
                step_s = time.perf_counter() - start
                config_now = (loader.current_atomic_bsz, loader.current_accum_steps)
                calibrated = len(trainer._calibrated) - calibrations
                expected = per_pass * (
                    config_now[1] + 1
                    + calibrated * (trainer.calibrate_repeats + 1)
                )
                got = _build.LAUNCHES[KERNEL_SM90] - before
                check(got == expected, f"{name}: {got} flash launches, expected {expected}")
                check(_build.LAUNCHES[KERNEL] == 0, f"{name}: launched {KERNEL}")
                sums = state_checksums(model, trainer.optimizer, holder["state"].gns)
                seen = collective.allreduce((config_now, sums), list)
                check(
                    all(x == seen[0] for x in seen),
                    f"{name}: replicas out of lockstep after step "
                    f"{len(report['steps']) + 1}",
                )
                stats = {k: float(v) for k, v in m.items()}
                check(
                    all(math.isfinite(stats[k]) for k in
                        ("loss", "grad_sqr", "grad_var", "gain", "progress")),
                    f"{name}: non-finite statistics {stats}",
                )
                report["steps"].append({
                    "config": config_now, "loss": stats["loss"],
                    "seconds": step_s, "calibrated": calibrated,
                })
                report["checksums"] = sums
                print(
                    f"multi-replica {name}: step {len(report['steps'])} "
                    f"atomic {config_now[0]} accum {config_now[1]}: "
                    f"{step_s * 1e3:.1f} ms{' (calibration)' if calibrated else ''}, "
                    f"loss {stats['loss']:.4f}, {got} sm90 launches, "
                    f"replicas in lockstep",
                    flush=True,
                )
                n = len(report["steps"])
                if not successor and n == PAIR_STEPS - 1 and rank == 1:
                    _signal.set_exit_flag(True)
                if successor and n == SUCCESSOR_STEPS:
                    break
                stop_start = time.perf_counter()
    finally:
        report["stop_s"] = (
            time.perf_counter() - stop_start if stop_start else None
        )
        metrics.join_fit()
        report["launches"] = {k: _build.LAUNCHES[k] for k in (KERNEL_SM90, KERNEL)}
        report["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        state = metrics.current_state()
        report["max_profiled_replicas"] = state.max_profiled_replicas
        report["profiled_replicas"] = sorted(
            {key[1] for key, e in state.profile.items() if e.optim_count}
        )
        tag = "successor" if successor else f"pair-rank{rank}"
        with open(os.path.join(root, f"{tag}.json"), "w") as f:
            json.dump(report, f)


def nccl_world_one():
    """Phase 5d, in its own process: the port's process group at world
    size 1 on the one card must pick NCCL, and the flat all-reduce of a
    full-width gradient set must be one call returning its input."""
    import socket

    import torch.distributed as dist

    from adaptdl_tpu_torch import collective
    from adaptdl_tpu_torch.examples.transformer_lm import lm_config
    from adaptdl_tpu_torch.models import TransformerLM

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    device = torch.device("cuda", 0)
    backend = collective.initialize(
        "127.0.0.1", port, rank=0, world_size=1, device=device,
        local_world_size=1,
    )
    try:
        check(backend == "nccl", f"world-1 backend {backend}")
        with torch.device("meta"):
            model = TransformerLM(lm_config(cpu=False, seq_len=512, flash=True))
        shapes = [p.shape for p in model.parameters()]
        gen = torch.Generator(device=device).manual_seed(0)
        tensors = [
            torch.randn(shape, generator=gen, device=device)
            for shape in shapes + [(1,), ()]
        ]
        want = [t.clone() for t in tensors]
        calls = []
        real = dist.all_reduce
        dist.all_reduce = lambda t, *a, **k: calls.append(t.numel()) or real(t, *a, **k)
        try:
            collective.allreduce_mean(tensors)
            torch.cuda.synchronize()
            start = time.perf_counter()
            collective.allreduce_mean(tensors)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
        finally:
            dist.all_reduce = real
        n = sum(t.numel() for t in tensors)
        check(calls == [n, n], f"flat all-reduce made calls {calls}")
        check(
            all(torch.equal(a, b) for a, b in zip(tensors, want)),
            "world-1 NCCL all-reduce changed its input",
        )
        print(
            f"multi-replica nccl: backend {backend} at world size 1, "
            f"{len(tensors)} tensors ({n / 1e6:.1f} M float32) in one "
            f"all-reduce per call, bit-equal; {ms:.1f} ms",
            flush=True,
        )
    finally:
        collective.teardown()


def phase_multi_replica(kernel_rows, recorder):
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="adaptdl-torch-smoke-mr-")
    base = {k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")}

    def launch(replicas, restarts, mode, **extra):
        run_env = dict(
            base,
            ADAPTDL_NUM_REPLICAS=str(replicas),
            ADAPTDL_NUM_RESTARTS=str(restarts),
            ADAPTDL_CHECKPOINT_PATH=os.path.join(root, "ckpt"),
            ADAPTDL_SHARE_PATH=os.environ["ADAPTDL_SHARE_PATH"],
            **extra,
        )
        start = time.perf_counter()
        code = subprocess.run(
            [sys.executable, "-m", "adaptdl_tpu_torch.launch",
             os.path.join(here, "chip_smoke.py"), "--replica-worker", mode,
             root],
            cwd=here, env=run_env, timeout=600,
        ).returncode
        return code, time.perf_counter() - start

    def load(tag):
        with open(os.path.join(root, f"{tag}.json")) as f:
            return json.load(f)

    try:
        code, wall = launch(
            2, 0, "pair", ADAPTDL_SUPERVISOR_URL=recorder.url,
            ADAPTDL_JOB_ID=PAIR_JOB, ADAPTDL_HEARTBEAT_INTERVAL="1",
        )
        check(code == 143, f"two-replica launch exited {code}, expected 143")
        pair = [load(f"pair-rank{r}") for r in (0, 1)]
        registered = {
            int(r["rest"][1]) for r in recorder.seen(PAIR_JOB, "register")
            if r["rest"][0] == "0"
        }
        discovered = recorder.seen(PAIR_JOB, "discover")
        beats = {int(r["rest"][0]) for r in recorder.seen(PAIR_JOB, "heartbeat")}
        hints = recorder.seen(PAIR_JOB, "hints")
        posts = [r["hint_posts"] for r in pair]
        workers = recorder.workers[(PAIR_JOB, 0)]
        check(
            registered == {0, 1} and len(discovered) == 2
            and workers == {r["rank"]: r["address"] for r in pair}
            and [r["group_host"] for r in pair] == [workers[0]] * 2,
            f"pair rendezvous: registered {registered} ({workers}), "
            f"{len(discovered)} discover replies, group joined at "
            f"{[r['group_host'] for r in pair]}",
        )
        check(beats == {0, 1}, f"pair heartbeats from ranks {beats}")
        check(
            len(hints) >= 1 and posts[0] and all(posts[0]) and posts[1] == []
            and not recorder.seen(PAIR_JOB, "hints", status=400),
            f"pair hint posts: rank 0 {posts[0]}, rank 1 {posts[1]}, "
            f"{len(hints)} accepted",
        )
        print(
            f"multi-replica supervisor: ranks {sorted(registered)} registered "
            f"and rendezvoused through /discover ({workers}; group joined "
            f"at rank 0's {workers[0]}), heartbeats from ranks "
            f"{sorted(beats)}, {len(hints)} hint post(s) accepted, all from "
            f"rank 0"
        )
        for r in pair:
            check(
                r["backend"] == "gloo" and r["device"] == "cuda:0",
                f"rank {r['rank']} ran {r['backend']} on {r['device']}",
            )
            check(
                len(r["steps"]) == PAIR_STEPS,
                f"rank {r['rank']} stopped after {len(r['steps'])} steps",
            )
            check(
                all(s["config"] == [16, 0] for s in r["steps"]),
                f"rank {r['rank']} ran {[s['config'] for s in r['steps']]}",
            )
        check(pair[0]["checksums"] == pair[1]["checksums"], "final states differ")
        step_ms = [
            sorted(s["seconds"] for s in r["steps"][1:])[(PAIR_STEPS - 1) // 2]
            * 1e3 for r in pair
        ]
        saved = sorted(os.listdir(os.path.join(root, "ckpt")))
        print(
            f"multi-replica pair: 2 ranks on one card over gloo, "
            f"{PAIR_STEPS} steps each in lockstep, both stopped after step "
            f"{PAIR_STEPS} (flag on rank 1 after step {PAIR_STEPS - 1}), "
            f"launcher exit 143, checkpoint {saved}; step wall time (median "
            f"of steps 2-{PAIR_STEPS}, correctness run, not a scaling "
            f"figure) {step_ms[0]:.1f} / {step_ms[1]:.1f} ms; stop "
            f"(agreement, save, barrier) {pair[0]['stop_s']:.1f} / "
            f"{pair[1]['stop_s']:.1f} s; peak memory "
            f"{pair[0]['peak_gib']:.2f} / {pair[1]['peak_gib']:.2f} GiB; "
            f"launch wall {wall:.1f} s"
        )

        code, wall = launch(1, 1, "successor")
        check(code == 0, f"one-replica successor exited {code}")
        succ = load("successor")
        check(
            all(s["config"] == [32, 0] for s in succ["steps"])
            and len(succ["steps"]) == SUCCESSOR_STEPS,
            f"successor ran {[s['config'] for s in succ['steps']]}",
        )
        losses = [s["loss"] for s in succ["steps"]]
        check(losses[-1] < losses[0], f"successor loss did not fall: {losses}")
        check(
            succ["max_profiled_replicas"] == 2
            and succ["profiled_replicas"] == [1, 2],
            f"successor profiles {succ['profiled_replicas']}, max "
            f"{succ['max_profiled_replicas']}",
        )
        print(
            f"multi-replica successor: 1 replica, restored bit-equal to rank "
            f"0's save in {succ['restore_s']:.2f} s at position "
            f"{succ['position']}, atomic 32, losses {losses}, profiles at "
            f"{succ['profiled_replicas']} replicas; step "
            f"{sorted(s['seconds'] for s in succ['steps'][1:])[1] * 1e3:.1f} ms, "
            f"peak memory {succ['peak_gib']:.2f} GiB, launch wall {wall:.1f} s"
        )

        code = subprocess.run(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--nccl-check"],
            cwd=here, env=base, timeout=300,
        ).returncode
        check(code == 0, f"NCCL world-1 check exited {code}")
        for row in kernel_rows:
            row["multi_replica_launches"] = [
                r["launches"][row["name"]] for r in pair
            ]
            row["rescaled_launches"] = succ["launches"][row["name"]]
        launches = {r["name"]: r["multi_replica_launches"] for r in kernel_rows}
        check(
            all(n > 0 for n in launches[KERNEL_SM90])
            and launches[KERNEL] == [0, 0],
            f"multi-replica launch counts {launches}",
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phase 6: supervised and guarded --------------------------------------

FAULT_AT = 7  # the guard's observation that gets a NaN gradient statistic
SERVE_BATCH_CONFIG_AFTER = 4  # steps before /config publishes a batchConfig
SUPERVISED_STEPS = 12
# The loader's configuration per step: (32, 0) until the re-optimisation
# after step 9 (its 8th completed step: step 7 rolled back) adopts the
# published (16, 1).
SUPERVISED_PLAN = [(32, 0)] * 9 + [(16, 1)] * 3


def phase_supervised(kernel_rows, recorder, main_step_s):
    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import (
        bootstrap,
        checkpoint,
        epoch,
        faults,
        guard,
        metrics,
        rpc,
        sched_hints,
    )
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.examples.transformer_lm import lm_config, synthetic_tokens
    from adaptdl_tpu_torch.goodput import GoodputFunction, PerfParams
    from adaptdl_tpu_torch.models import init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    ckpt_dir = tempfile.mkdtemp(prefix="adaptdl-torch-smoke-guard-")
    settings = {
        "ADAPTDL_CHECKPOINT_PATH": ckpt_dir,
        "ADAPTDL_SUPERVISOR_URL": recorder.url,
        "ADAPTDL_JOB_ID": SUPERVISED_JOB,
        "ADAPTDL_FIT_INTERVAL": "2",
        "ADAPTDL_HEARTBEAT_INTERVAL": "0.5",
        "ADAPTDL_CKPT_EVERY_STEPS": "2",
        "ADAPTDL_GUARD_CONFIRM_STEPS": "2",
        "ADAPTDL_FAULT_SPEC": f"guard.corrupt_grad=fail@{FAULT_AT}",
    }
    previous = {k: os.environ.get(k) for k in settings}
    os.environ.update(settings)
    for reset in (checkpoint._reset_registry, metrics._reset_state,
                  epoch._reset_state, guard._reset_state, faults.reset,
                  rpc.reset_default_client):
        reset()
    # Timed wrappers around the two calls whose seconds are reported
    # (metrics and guard reach them through these module attributes).
    posts, rollbacks = [], []
    real_post, real_rollback = sched_hints.post_sched_hints, checkpoint.rollback_to_good

    def timed_post(hints):
        start = time.perf_counter()
        ok = real_post(hints)
        posts.append((ok, time.perf_counter() - start))
        return ok

    def timed_rollback():
        start = time.perf_counter()
        restored = real_rollback()
        rollbacks.append((restored, time.perf_counter() - start))
        return restored

    sched_hints.post_sched_hints = timed_post
    checkpoint.rollback_to_good = timed_rollback
    try:
        device = adaptdl_tpu_torch.initialize_job(device="cuda")
        check(
            bootstrap._heartbeat_thread is not None
            and bootstrap._heartbeat_thread.is_alive(),
            "initialize_job started no heartbeat thread",
        )
        config = lm_config(cpu=False, seq_len=512, flash=True)
        model = init_transformer(config, seed=0, device=device)
        trainer = ElasticTrainer(
            lm_loss_fn, model, AdamW(model.parameters(), lr=3e-4),
            init_batch_size=32, scaling_rule=AdamScale(), precondition="adam",
            device=device,
        )
        trainer.metrics_every = 1
        holder = {"state": trainer.init_state()}
        ckpt = trainer.make_checkpoint_state(
            lambda: holder["state"], lambda s: holder.__setitem__("state", s)
        )
        check(not checkpoint.load_state(ckpt), "fresh run found a checkpoint")
        metrics.ensure_checkpoint_registered()
        loader = AdaptiveDataLoader(
            synthetic_tokens(1024, 512, config.vocab_size), batch_size=32
        )
        loader.autoscale_batch_size(
            32, local_bsz_bounds=(16, 32), gradient_accumulation=True
        )
        loader._reoptimize_every = 4
        per_pass = config.num_layers * 2  # forward + remat recompute
        saved = {}  # checkpoint dir -> what the state was when it was saved
        steps, rollback_step = [], None
        served_at = None
        _build.reset_launches()
        for _ in epoch.remaining_epochs_until(1):
            for batch in loader:
                i = len(steps) + 1
                saves = len(saved)
                # A periodic save snapshots after a step, before the next
                # batch (its write lands later): the state here is the
                # state it saved.
                inflight = checkpoint.inflight_save()
                path = inflight.path if inflight is not None else None
                if path is not None and path not in saved:
                    saved[path] = {
                        "checksums": state_checksums(
                            model, trainer.optimizer, holder["state"].gns
                        ),
                        "step": int(holder["state"].step),
                        "position": (loader.sampler.epoch, loader.sampler.index),
                    }
                if i == SERVE_BATCH_CONFIG_AFTER + 1:
                    recorder.serve_batch_config(
                        SUPERVISED_JOB, {"atomicBsz": 16, "accumSteps": 1}
                    )
                    served_at = time.monotonic()
                span = loader.current_batch_span()
                config_now = (loader.current_atomic_bsz, loader.current_accum_steps)
                before = _build.LAUNCHES[KERNEL_SM90]
                calibrations = len(trainer._calibrated)
                rolled = len(rollbacks)
                torch.cuda.synchronize()
                start = time.perf_counter()
                holder["state"], m = trainer.run_step(holder["state"], batch, loader)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - start
                calibrated = len(trainer._calibrated) - calibrations
                expected = per_pass * (
                    config_now[1] + 1 + calibrated * (trainer.calibrate_repeats + 1)
                )
                got = _build.LAUNCHES[KERNEL_SM90] - before
                check(got == expected, f"step {i}: {got} flash launches, expected {expected}")
                check(_build.LAUNCHES[KERNEL] == 0, f"step {i}: launched {KERNEL}")
                loss = float(m["loss"])
                check(math.isfinite(loss), f"step {i}: loss {loss}")
                steps.append({
                    "config": config_now, "span": span, "seconds": step_s,
                    "calibrated": calibrated, "loss": loss,
                    "after_save": len(saved) > saves,
                })
                if len(rollbacks) > rolled:
                    restored, restore_s = rollbacks[-1]
                    incident = guard._get_guard().last_incident
                    check(
                        i == FAULT_AT and incident["kind"] == "nan_grad"
                        and incident["action"] == "rollback"
                        and incident["step"] == FAULT_AT,
                        f"step {i}: incident {incident}",
                    )
                    good = os.path.join(ckpt_dir, restored)
                    check(
                        good in saved and checkpoint.is_good_checkpoint(good),
                        f"rolled back to {restored}, not a good-marked save",
                    )
                    want = saved[good]
                    check(
                        state_checksums(model, trainer.optimizer, holder["state"].gns)
                        == want["checksums"]
                        and int(holder["state"].step) == want["step"],
                        f"the state after the rollback differs from {restored}",
                    )
                    check(
                        (loader.sampler.epoch, loader.sampler.index)
                        == want["position"] and loader._skip_ranges == [span],
                        f"loader at {(loader.sampler.epoch, loader.sampler.index)} "
                        f"skipping {loader._skip_ranges}, expected "
                        f"{want['position']} skipping [{span}]",
                    )
                    rollback_step = {
                        "dir": restored, "restore_s": restore_s,
                        "position": want["position"], "step": want["step"],
                        "poisoned": span,
                    }
                    print(
                        f"supervised: observation {i} nan_grad -> rolled back "
                        f"to {restored} (step {want['step']}, position "
                        f"{want['position']}), checksums equal, skipping "
                        f"{span}; restore {restore_s:.2f} s",
                        flush=True,
                    )
                if i == SUPERVISED_STEPS:
                    break
        launches = {n: _build.LAUNCHES[n] for n in (KERNEL_SM90, KERNEL)}
        metrics.join_fit()
        bootstrap.stop_heartbeat()
        check(
            faults.hit_count("guard.corrupt_grad") == SUPERVISED_STEPS,
            f"the guard observed {faults.hit_count('guard.corrupt_grad')} "
            f"times in {SUPERVISED_STEPS} steps",
        )
        # c, e: one rollback, at the fault; 5 more steps, never the
        # poisoned span.
        check(rollback_step is not None and len(rollbacks) == 1, f"rollbacks {rollbacks}")
        after = steps[FAULT_AT:]
        poisoned = rollback_step["poisoned"]
        check(
            len(after) == SUPERVISED_STEPS - FAULT_AT
            and all(s["span"][1] >= poisoned[2] or s["span"][2] <= poisoned[1]
                    for s in after),
            f"steps after the rollback ran spans {[s['span'] for s in after]}",
        )
        check(
            after[0]["span"][1] == rollback_step["position"][1],
            f"resumed at {after[0]['span']}, saved at {rollback_step['position']}",
        )
        # b: (16, 1) from the re-optimisation after serving began.
        configs = [s["config"] for s in steps]
        check(configs == SUPERVISED_PLAN, f"configs {configs}")
        fetched = [
            r for r in recorder.seen(SUPERVISED_JOB, "config")
            if r["time"] > served_at
        ]
        check(fetched, "no /config fetch after the batchConfig was served")
        # d: one incident.
        incidents = recorder.seen(SUPERVISED_JOB, "incident")
        check(
            len(incidents) == 1
            and incidents[0]["body"]["kind"] == "nan_grad"
            and incidents[0]["body"]["action"] == "rollback"
            and incidents[0]["body"]["step"] == FAULT_AT,
            f"incidents {[r['body'] for r in incidents]}",
        )
        # a: heartbeats, and hints fitted from this card's step times.
        beats = recorder.seen(SUPERVISED_JOB, "heartbeat")
        hints = [r["body"] for r in recorder.seen(SUPERVISED_JOB, "hints")]
        check(beats, "no heartbeat reached the supervisor")
        check(
            not recorder.seen(SUPERVISED_JOB, "hints", status=400)
            and posts and all(ok for ok, _ in posts),
            f"hint posts {posts}",
        )
        fitted = [h for h in hints if h.get("perfParams") and h.get("gradParams")]
        check(fitted, f"no accepted hints carried perfParams ({len(hints)} posts)")
        last = fitted[-1]
        perf = PerfParams(**last["perfParams"])
        grad = last["gradParams"]
        check(
            all(math.isfinite(v) and v >= 0 for v in perf)
            and all(math.isfinite(v) for v in grad.values()),
            f"hint params {last['perfParams']} {grad}",
        )
        steady = sorted(
            s["seconds"] for k, s in enumerate(steps, 1)
            if s["config"] == (32, 0) and not s["calibrated"] and k != FAULT_AT
        )
        step_s = steady[len(steady) // 2]
        predicted = GoodputFunction(
            perf, (grad["sqr"], grad["var"]), 32
        ).throughput(1, 1, 32, 0)
        check(
            0.5 <= predicted * step_s / 32 <= 2.0,
            f"fitted model predicts {predicted:.1f} samples/s, measured "
            f"{32 / step_s:.1f}",
        )
        # The fit's inputs beside the measured step: each profile entry's
        # mean compute-only calibration (accum) and mean optimizer-step
        # time (optim, the step less its modelled microbatches).
        entries = []
        for key, e in sorted(metrics.current_state().profile.items()):
            accum = e.accum_time_sum / e.accum_count if e.accum_count else None
            optim = e.optim_time_sum / e.optim_count if e.optim_count else None
            entries.append(
                f"replicas {key[1]} atomic {key[-1]}: accum "
                + (f"{accum * 1e3:.1f} ms (n {e.accum_count})"
                   if accum is not None else "none")
                + ", optim "
                + (f"{optim * 1e3:.1f} ms (n {e.optim_count})"
                   if optim is not None else "none")
            )
        print(f"supervised: profile entries {'; '.join(entries)}; measured "
              f"step at (32, 0) {step_s * 1e3:.1f} ms")
        latency = sorted(dt for _, dt in posts)
        print(
            f"supervised: {len(beats)} heartbeats, {len(hints)} hint posts "
            f"accepted ({len(fitted)} with fitted params: predicted "
            f"{predicted:.1f} samples/s at (32, 0), measured {32 / step_s:.1f}); "
            f"hint-post latency median {latency[len(latency) // 2] * 1e3:.1f} ms, "
            f"max {latency[-1] * 1e3:.1f} ms over {len(latency)} posts; "
            f"(16, 1) adopted at step {configs.index((16, 1)) + 1}; incident "
            f"{incidents[0]['body']}"
        )
        print(
            f"supervised: step {step_s * 1e3:.1f} ms (median of {len(steady)} "
            f"accum-0 steps) against phase 4's {main_step_s * 1e3:.1f} ms; "
            f"rollback restore {rollback_step['restore_s']:.2f} s; losses "
            f"{[round(s['loss'], 4) for s in steps]}"
        )
        print(
            "supervised: step times ms (* after a save) "
            + str([f"{s['seconds'] * 1e3:.1f}{'*' if s['after_save'] else ''}"
                   for s in steps])
        )
        check(launches[KERNEL_SM90] > 0 and launches[KERNEL] == 0, f"launches {launches}")
        for row in kernel_rows:
            row["supervised_launches"] = launches[row["name"]]
    finally:
        sched_hints.post_sched_hints = real_post
        checkpoint.rollback_to_good = real_rollback
        bootstrap.stop_heartbeat()
        metrics.join_fit()
        faults.reset()
        for k, v in previous.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        # The last periodic save may still be writing into ckpt_dir.
        checkpoint.wait_for_inflight_save()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# -- phase 7: the model zoo -------------------------------------------------

ZOO_RESNET_PLAN = [(128, 0)] * 40 + [(128, 1)] * 5
ZOO_STEPS = 8  # NCF and DCGAN
ZOO_BERT_STEPS = 5
ZOO_LINEAR_EPOCHS = 3


def _zoo_job(prefix):
    """A fresh job of the port in this process: its own checkpoint dir,
    every registry reset, no other phase's tensors left on the card.
    Returns the checkpoint dir."""
    import gc

    from adaptdl_tpu_torch import checkpoint, epoch, guard, metrics

    metrics.join_fit()
    for reset in (checkpoint._reset_registry, metrics._reset_state,
                  epoch._reset_state, guard._reset_state):
        reset()
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_dir = tempfile.mkdtemp(prefix=prefix)
    os.environ["ADAPTDL_CHECKPOINT_PATH"] = ckpt_dir
    torch.cuda.reset_peak_memory_stats()
    return ckpt_dir


def _drive(trainer, holder, loader, count, aux=None, after_step=None, plan=None):
    """``count`` steps of ``trainer.run_step`` over ``loader``, each timed
    between two synchronisations. Returns (losses, step seconds)."""
    from adaptdl_tpu_torch import epoch

    losses, seconds = [], []
    for _ in epoch.remaining_epochs_until(1):
        for batch in loader:
            i = len(losses)
            if plan is not None:
                check(
                    (loader.current_atomic_bsz, loader.current_accum_steps) == plan[i],
                    f"step {i} ran {loader.current_atomic_bsz, loader.current_accum_steps}",
                )
            torch.cuda.synchronize()
            start = time.perf_counter()
            holder["state"], m = trainer.run_step(holder["state"], batch, loader, aux)
            if after_step is not None:
                after_step(batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
            losses.append(float(m["loss"]))
            if len(losses) == count:
                break
            if plan is not None and plan[len(losses)] != plan[i]:
                loader.apply_retune(*plan[len(losses)])
    check(len(losses) == count, f"{len(losses)} of {count} steps ran")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    return losses, seconds


def _median(values):
    return sorted(values)[len(values) // 2]


def _equal_states(model_a, opt_a, model_b, opt_b, what):
    for (name, p), q in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        check(torch.equal(p, q), f"{what}: restored parameter {name} differs")
    for p, q in zip(opt_a.params(), opt_b.params()):
        s1, s2 = opt_a.state[p], opt_b.state[q]
        check(
            s1.keys() == s2.keys() and all(torch.equal(s1[k], s2[k]) for k in s1),
            f"{what}: restored optimizer state differs",
        )


def _device_busy(run, steps=3):
    """(busy ms, traced window ms, host ms in each of the trainer's
    three ranges), each per step, over ``steps`` runs of ``run`` traced
    by torch.profiler (after one untraced run). The window includes the
    profiler's own host overhead, so it is longer than an untraced step."""
    from adaptdl_tpu_torch import trainer
    from adaptdl_tpu_torch.examples.profile_step import _timeline

    run()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    _, _, busy_us, window_us, _ = _timeline(prof, {}, None)
    check(window_us > 0, "the profiler saw no device kernel")
    ranges = (trainer.RANGE_MICROBATCHES, trainer.RANGE_STATISTICS, trainer.RANGE_OPTIMIZER)
    host_us = dict.fromkeys(ranges, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in host_us:
            host_us[e.name] += e.time_range.end - e.time_range.start
    host_ms = {name.split(".")[-1]: us / steps / 1e3 for name, us in host_us.items()}
    return busy_us / steps / 1e3, window_us / steps / 1e3, host_ms


def zoo_resnet(device):
    """CIFAR ResNet-18 at full width through the example's make_trainer
    and make_loader."""
    from adaptdl_tpu_torch import checkpoint, metrics
    from adaptdl_tpu_torch.examples import cifar_resnet18

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-resnet-")
    try:
        trainer, holder, ckpt = cifar_resnet18.make_trainer(device, cpu=False)
        check(not checkpoint.load_state(ckpt), "fresh run found a checkpoint")
        metrics.ensure_checkpoint_registered()
        loader = cifar_resnet18.make_loader(cpu=False)
        model = trainer.model
        n_params = sum(p.numel() for p in model.parameters())
        base = torch.cuda.memory_allocated()
        losses, seconds = _drive(
            trainer, holder, loader, len(ZOO_RESNET_PLAN), plan=ZOO_RESNET_PLAN
        )
        peak = torch.cuda.max_memory_allocated()
        accum0 = losses[: ZOO_RESNET_PLAN.count((128, 0))]
        # At SGD(0.1, momentum 0.9) from the flax initialisation the loss
        # climbs for about ten steps (the JAX trainer's does the same)
        # before it falls below where it started.
        check(
            sum(losses[-3:]) / 3 < losses[0],
            f"ResNet-18 loss did not fall: {losses[:3]} -> {losses[-3:]}",
        )
        step_s = _median(seconds[1:len(accum0)])
        accum_s = _median(seconds[len(accum0) + 1:])
        batch = {k: v[:128] for k, v in loader.dataset.items()}
        device_batch = trainer.to_device(batch)
        step = trainer.train_step(128, 0)

        def traced():
            holder["state"], _ = step(holder["state"], device_batch)

        busy_ms, window_ms, host_ms = _device_busy(traced)
        # The trainer's step alone: no loader, metrics or refit thread.
        bare = []
        for _ in range(10):
            torch.cuda.synchronize()
            start = time.perf_counter()
            traced()
            torch.cuda.synchronize()
            bare.append(time.perf_counter() - start)
        bare_s = _median(bare)
        idle = 1.0 - busy_ms / (bare_s * 1e3)
        print(
            f"zoo resnet18: {n_params / 1e6:.2f} M params, losses {[round(x, 4) for x in losses]}"
        )
        print(
            f"zoo resnet18: step {step_s * 1e3:.2f} ms (median of steps 2-{len(accum0)}, "
            f"(128, 0)), {128 / step_s:.0f} samples/s; (128, 1) step "
            f"{accum_s * 1e3:.2f} ms; first step (with calibration) "
            f"{seconds[0] * 1e3:.1f} ms; peak memory {peak / 2**30:.3f} GiB "
            f"({(peak - base) / 2**30:.3f} GiB over the {base / 2**20:.0f} MiB "
            f"held before the steps); bare train_step at (128, 0) "
            f"{bare_s * 1e3:.2f} ms (median of 10), device busy {busy_ms:.2f} ms "
            f"per step (3 traced calls, window {window_ms:.2f} ms per step), idle "
            f"{idle:.3f} of the bare step; host ms per step (traced) by range "
            f"{host_ms}; progress "
            f"{float(holder['state'].progress):.3f}"
        )
        print(f"zoo resnet18: step times ms {[round(s * 1e3, 2) for s in seconds]}")

        # Save, restore into a fresh trainer bit for bit, resume.
        saved = checkpoint.save_all_states()
        ckpt.unregister()
        trainer2, holder2, ckpt2 = cifar_resnet18.make_trainer(device, cpu=False, seed=1)
        check(checkpoint.load_state(ckpt2), "ResNet-18 checkpoint did not restore")
        a, b = holder["state"], holder2["state"]
        _equal_states(trainer.model, trainer.optimizer, trainer2.model,
                      trainer2.optimizer, "ResNet-18")
        check(
            all(len(trainer2.optimizer.state[p]) == 1 for p in trainer2.optimizer.params()),
            "ResNet-18: a momentum buffer is missing",
        )
        g1, g2 = a.gns.tensors(), b.gns.tensors()
        for k in g1:
            pair = zip(g1[k], g2[k]) if k == "prev_grad" else [(g1[k], g2[k])]
            check(all(torch.equal(x, y) for x, y in pair), f"ResNet-18: gns.{k} differs")
        check(
            torch.equal(a.step, b.step) and torch.equal(a.progress, b.progress)
            and a.host_step == b.host_step == len(ZOO_RESNET_PLAN) + 14,
            "ResNet-18: restored step/progress differ",
        )
        _, m1 = step(a, device_batch)
        _, m2 = trainer2.train_step(128, 0)(b, trainer2.to_device(batch))
        l1, l2 = float(m1["loss"]), float(m2["loss"])
        check(
            math.isfinite(l2) and abs(l1 - l2) <= 1e-5 * abs(l1),
            f"ResNet-18: resumed step loss {l2} against {l1}",
        )
        print(
            f"zoo resnet18: {os.path.basename(saved)} restored bit-equal "
            f"(parameters, momentum, noise statistics, progress, step "
            f"{int(b.step)}); resumed step loss {l2:.6f} (original {l1:.6f})"
        )
        return {"step_ms": step_s * 1e3, "accum1_step_ms": accum_s * 1e3,
                "samples_per_s": 128 / step_s, "peak_gib": peak / 2**30,
                "idle": idle, "busy_ms": busy_ms, "bare_step_ms": bare_s * 1e3,
                "host_ms": host_ms}
    finally:
        metrics.join_fit()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def zoo_ncf(device):
    from adaptdl_tpu_torch import checkpoint, metrics
    from adaptdl_tpu_torch.examples import ncf

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-ncf-")
    try:
        trainer, holder, ckpt = ncf.make_trainer(device, 256, 512)
        checkpoint.load_state(ckpt)
        metrics.ensure_checkpoint_registered()
        data, _, held_out = ncf.make_data(256, 512)
        loader = ncf.make_loader(data)
        losses, seconds = _drive(trainer, holder, loader, ZOO_STEPS)
        hr, ndcg = ncf.ranked_eval(trainer.model, held_out, 512)
        check(0.0 <= ndcg <= hr <= 1.0, f"NCF eval {hr}, {ndcg}")
        step_s, peak = _median(seconds[1:]), torch.cuda.max_memory_allocated()
        print(
            f"zoo ncf: step {step_s * 1e3:.2f} ms (median of steps 2-{ZOO_STEPS}, "
            f"batch {loader.current_batch_size}), {loader.current_batch_size / step_s:.0f} "
            f"samples/s, peak memory {peak / 2**30:.3f} GiB; losses "
            f"{[round(x, 4) for x in losses]}; HR@10 {hr:.4f} NDCG@10 {ndcg:.4f}"
        )
        return {"step_ms": step_s * 1e3, "peak_gib": peak / 2**30}
    finally:
        metrics.join_fit()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def zoo_dcgan(device):
    from adaptdl_tpu_torch import checkpoint, metrics
    from adaptdl_tpu_torch.examples import dcgan

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-dcgan-")
    try:
        d_trainer, holder, d_ckpt, g_step, g_ckpt = dcgan.make_pair(device, cpu=False)
        checkpoint.load_state(d_ckpt)
        checkpoint.load_state(g_ckpt)
        metrics.ensure_checkpoint_registered()
        loader = dcgan.make_loader(cpu=False)
        generator = g_ckpt.generator
        g_losses = []

        def generator_step(batch):
            z = d_trainer.to_device({"z": batch["z"]})["z"]
            g_losses.append(g_step(z))

        losses, seconds = _drive(
            d_trainer, holder, loader, ZOO_STEPS, aux=generator,
            after_step=generator_step,
        )
        g_losses = [float(x) for x in g_losses]
        check(all(math.isfinite(x) for x in g_losses), f"generator losses {g_losses}")
        step_s, peak = _median(seconds[1:]), torch.cuda.max_memory_allocated()
        fixed = torch.randn(16, 32, generator=torch.Generator().manual_seed(1)).to(device)
        grid = dcgan.sample_grid(generator, fixed)
        check(grid.shape == (128, 128, 3), f"sample grid {grid.shape}")

        checkpoint.save_all_states()
        d_ckpt.unregister()
        g_ckpt.unregister()
        d2, holder2, d_ckpt2, _, g_ckpt2 = dcgan.make_pair(device, cpu=False, seed=1)
        check(
            checkpoint.load_state(d_ckpt2) and checkpoint.load_state(g_ckpt2),
            "DCGAN pair did not restore",
        )
        _equal_states(d_trainer.model, d_trainer.optimizer, d2.model, d2.optimizer,
                      "discriminator")
        _equal_states(generator, g_ckpt.optimizer, g_ckpt2.generator,
                      g_ckpt2.optimizer, "generator")
        check(torch.equal(holder["state"].step, holder2["state"].step),
              "discriminator step differs")
        print(
            f"zoo dcgan: step {step_s * 1e3:.2f} ms (D under has_aux + G, median of "
            f"steps 2-{ZOO_STEPS}, batch {loader.current_batch_size}), peak memory "
            f"{peak / 2**30:.3f} GiB; d losses {[round(x, 4) for x in losses]}; "
            f"g losses {[round(x, 4) for x in g_losses]}; G and D restored together "
            f"bit-equal"
        )
        return {"step_ms": step_s * 1e3, "peak_gib": peak / 2**30}
    finally:
        metrics.join_fit()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def zoo_bert(device):
    from adaptdl_tpu_torch import checkpoint, metrics
    from adaptdl_tpu_torch.examples import bert_mlm

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-bert-")
    try:
        trainer, holder, ckpt = bert_mlm.make_trainer(device, cpu=False)
        checkpoint.load_state(ckpt)
        metrics.ensure_checkpoint_registered()
        loader = bert_mlm.make_loader(cpu=False)
        cfg = trainer.model.config
        check(not cfg.causal and cfg.attention_fn is None, f"BERT config {cfg}")
        losses, seconds = _drive(trainer, holder, loader, ZOO_BERT_STEPS)
        step_s, peak = _median(seconds[1:]), torch.cuda.max_memory_allocated()
        tokens = loader.current_batch_size * 512
        print(
            f"zoo bert_mlm: step {step_s * 1e3:.1f} ms (median of steps "
            f"2-{ZOO_BERT_STEPS}, ({loader.current_atomic_bsz}, "
            f"{loader.current_accum_steps}) x 512), {tokens / step_s:.0f} tokens/s, "
            f"peak memory {peak / 2**30:.2f} GiB; losses {[round(x, 4) for x in losses]}"
        )
        return {"step_ms": step_s * 1e3, "peak_gib": peak / 2**30}
    finally:
        metrics.join_fit()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def zoo_linear(device):
    from adaptdl_tpu_torch.examples import linear_regression

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-linear-")
    try:
        start = time.perf_counter()
        w, b = linear_regression.main(["--epochs", str(ZOO_LINEAR_EPOCHS)])
        seconds = time.perf_counter() - start
        err = float(abs(w - linear_regression.TRUE_W).max())
        print(
            f"zoo linear_regression: w {w.tolist()} b {b:.4f} after "
            f"{ZOO_LINEAR_EPOCHS} epochs in {seconds:.1f} s, max|w - true| {err:.4f} "
            "(tol 0.05)"
        )
        check(err < 0.05 and abs(b) < 0.05, "linear regression did not converge")
        return {"seconds": seconds}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def phase_zoo(kernel_rows):
    """Phase 7: every zoo path through the port's entry points on the
    card, the flash launch counts reset before and read after each."""
    import adaptdl_tpu_torch
    from adaptdl_tpu_torch.ops import _build

    device = adaptdl_tpu_torch.initialize_job(device="cuda")
    check(device.type == "cuda", f"zoo device {device}")
    paths = {
        "resnet18": zoo_resnet, "ncf": zoo_ncf, "dcgan": zoo_dcgan,
        "bert_mlm": zoo_bert, "linear_regression": zoo_linear,
    }
    launches, results = {}, {}
    for name, run in paths.items():
        start = time.perf_counter()
        _build.reset_launches()
        results[name] = run(device)
        launches[name] = dict(_build.LAUNCHES)
        print(f"zoo {name}: {time.perf_counter() - start:.1f} s, flash launches "
              f"{launches[name]}")
        # None of these paths runs the flash kernels (BERT's attention is
        # dense, as the JAX example's).
        check(not any(launches[name].values()), f"{name} launched {launches[name]}")
    for row in kernel_rows:
        row["zoo_launches"] = {n: c.get(row["name"], 0) for n, c in launches.items()}
    return results


# -- phase 8: the rescale path ----------------------------------------------

RESCALE_JOB = "smoke/rescale"
RESCALE_PLAN = {
    # mode: (restarts, steps taken, step whose body raises the exit flag)
    "first": (0, 7, 6),
    "successor": (1, 3, 2),
    "fallback": (2, 4, None),
}
RESCALE_SAVE_EVERY = {"first": 3, "successor": 0, "fallback": 2}
PR_SET_CHILD_SUBREAPER = 36


def rescale_run(mode, root):
    """One incarnation of phase 8 (``first``, ``successor`` or
    ``fallback``), a fresh process; rewrites ``root/<mode>.json`` after
    every step and at exit."""
    import atexit

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import _signal, checkpoint, env, epoch, handoff, metrics
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.examples.transformer_lm import lm_config, synthetic_tokens
    from adaptdl_tpu_torch.models import init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.sched import preemption
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    _, steps, flag_at = RESCALE_PLAN[mode]
    report = {"mode": mode, "pid": os.getpid(), "steps": [], "saves": []}
    path = os.path.join(root, f"{mode}.json")

    handles = []  # (step the save followed, its handle)

    def write():
        report["saves"] = [
            {"after_step": step, "snapshot_s": h.snapshot_s,
             "write_s": h.write_s if h.done() else None}
            for step, h in handles
        ]
        report["restart_stats"] = metrics.restart_stats()
        report["notice"] = preemption.notice_state()
        report["written"] = time.time()
        with open(path + ".tmp", "w") as f:
            json.dump(report, f)
        os.replace(path + ".tmp", path)

    # The kernel cache on the job's share path, which phase 2 built.
    hit = all(_build._library_path(n).exists() for n in _build.sources())
    start = time.perf_counter()
    _build.build_all()
    report["build"] = {
        "dir": str(_build.cache_dir()), "hit": hit,
        "seconds": time.perf_counter() - start,
    }
    device = adaptdl_tpu_torch.initialize_job(device="cuda")
    config = lm_config(cpu=False, seq_len=512, flash=True)

    def make(seed):
        model = init_transformer(config, seed=seed, device=device)
        trainer = ElasticTrainer(
            lm_loss_fn, model, AdamW(model.parameters(), lr=3e-4),
            init_batch_size=32, scaling_rule=AdamScale(), precondition="adam",
            device=device,
        )
        trainer.metrics_every = 1  # the guard grades every step
        holder = {"state": trainer.init_state()}
        ckpt = trainer.make_checkpoint_state(
            lambda: holder["state"], lambda s: holder.__setitem__("state", s)
        )
        return model, trainer, holder, ckpt

    model, trainer, holder, ckpt = make(seed=100 + env.num_restarts())
    start = time.perf_counter()
    report["restored"] = checkpoint.load_state(ckpt)
    report["restore_s"] = time.perf_counter() - start
    if report["restored"]:
        report["restored_checksums"] = state_checksums(
            model, trainer.optimizer, holder["state"].gns
        )
    metrics.ensure_checkpoint_registered()
    loader = AdaptiveDataLoader(
        synthetic_tokens(1024, 512, config.vocab_size), batch_size=32
    )
    atexit.register(write)
    per_pass = config.num_layers * 2  # forward + remat recompute
    _build.reset_launches()
    for _ in epoch.remaining_epochs_until(1):
        for batch in loader:
            n = len(report["steps"]) + 1
            if n == 1:
                # Every state is restored now (the epoch's at the loop).
                report["loaded_from"] = {
                    k: v if v == checkpoint.HANDOFF_SOURCE else os.path.basename(v)
                    for k, v in checkpoint._loaded_from.items()
                }
                report["handoff"] = handoff.fetch_stats()
                if mode == "successor":
                    report["storage"] = storage_restore(make, ckpt)
            if mode == "fallback" and n == 3:
                # The save after step 2 is writing: a notice now, on the
                # listener's first poll.
                check(
                    checkpoint.inflight_save() is not None,
                    "fallback: no write in flight at the notice",
                )
                preemption.start_listener(interval=0.05)
            inflight = checkpoint.inflight_save()
            if inflight is not None and all(h is not inflight for _, h in handles):
                handles.append((n - 1, inflight))
            before = _build.LAUNCHES[KERNEL_SM90]
            calibrations = len(trainer._calibrated)
            torch.cuda.synchronize(device)
            start = time.perf_counter()
            holder["state"], m = trainer.run_step(holder["state"], batch, loader)
            torch.cuda.synchronize(device)
            step_s = time.perf_counter() - start
            accum = loader.current_accum_steps
            calibrated = len(trainer._calibrated) - calibrations
            got = _build.LAUNCHES[KERNEL_SM90] - before
            expected = per_pass * (
                accum + 1 + calibrated * (trainer.calibrate_repeats + 1)
            )
            check(got == expected, f"{mode} step {n}: {got} flash launches, "
                  f"expected {expected}")
            check(_build.LAUNCHES[KERNEL] == 0, f"{mode}: launched {KERNEL}")
            loss = float(m["loss"])
            check(math.isfinite(loss), f"{mode} step {n}: loss {loss}")
            report["steps"].append({
                "seconds": step_s, "loss": loss, "calibrated": calibrated,
                "config": [loader.current_atomic_bsz, accum],
            })
            report["launches"] = {k: _build.LAUNCHES[k] for k in (KERNEL_SM90, KERNEL)}
            report["checksums"] = state_checksums(
                model, trainer.optimizer, holder["state"].gns
            )
            report["host_buffer_bytes"] = ckpt.host_buffer_bytes
            report["last_step_end"] = time.time()
            write()
            if n == flag_at:
                _signal.set_exit_flag(True)
            check(n < steps + 1, f"{mode}: step {n} ran past the stop")
    check(False, f"{mode}: the loop ended without a stop")


def storage_restore(make, ckpt):
    """The successor's cross-check: the same checkpoint restored from
    storage into a fresh trainer; its seconds and checksums."""
    from adaptdl_tpu_torch import checkpoint, handoff

    handoff.mark_unavailable()
    ckpt.unregister()
    model, trainer, holder, other = make(seed=7)
    start = time.perf_counter()
    check(checkpoint.load_state(other), "storage restore found nothing")
    seconds = time.perf_counter() - start
    source = os.path.basename(checkpoint._loaded_from[other.name])
    sums = state_checksums(model, trainer.optimizer, holder["state"].gns)
    other.unregister()
    checkpoint._registry[ckpt.name] = ckpt
    del model, trainer, holder, other
    torch.cuda.empty_cache()
    return {"seconds": seconds, "source": source, "checksums": sums}


def _reap(pid, what, timeout=60.0):
    """Wait for an orphaned shard server (reparented to this process, the
    subreaper) to exit; its exit status."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            done, status = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            check(not os.path.exists(f"/proc/{pid}"), f"{what} {pid} is not reapable")
            return None
        if done:
            return os.waitstatus_to_exitcode(status)
        time.sleep(0.05)
    check(False, f"{what} {pid} still runs after {timeout} s")


def _children():
    pids = []
    for tid in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{tid}/children") as f:
            pids += [int(p) for p in f.read().split()]
    return pids


def phase_rescale(kernel_rows, recorder):
    """Phase 8: the rescale path at full width, each incarnation a fresh
    process under the supervisor recorder, with the kernel cache on the
    share path, the handoff on and one trace context."""
    from adaptdl_tpu_torch import checkpoint, handoff, trace
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    libc = ctypes.CDLL(None, use_errno=True)
    # Orphaned shard servers come back to this process, which reaps them.
    check(libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0,
          "cannot become the shard servers' subreaper")
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="adaptdl-torch-smoke-rs-")
    ckpt_root = os.path.join(root, "ckpt")
    decision = trace.new_traceparent()
    recorder.serve_trace_parent(RESCALE_JOB, decision)
    base = {k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")}
    common = dict(
        ADAPTDL_CHECKPOINT_PATH=ckpt_root,
        ADAPTDL_SHARE_PATH=os.environ["ADAPTDL_SHARE_PATH"],
        ADAPTDL_TRACE_DIR=os.path.join(root, "trace"),
        ADAPTDL_TRACEPARENT=decision,
        ADAPTDL_SUPERVISOR_URL=recorder.url, ADAPTDL_JOB_ID=RESCALE_JOB,
        ADAPTDL_HEARTBEAT_INTERVAL="1", ADAPTDL_HANDOFF="on",
        ADAPTDL_GUARD_CONFIRM_STEPS="2",
        ADAPTDL_PREEMPT_NOTICE_S="30", ADAPTDL_PREEMPT_MARGIN_S="5",
    )

    def run(mode, **extra):
        run_env = dict(
            base, **common, ADAPTDL_NUM_RESTARTS=str(RESCALE_PLAN[mode][0]),
            ADAPTDL_CKPT_EVERY_STEPS=str(RESCALE_SAVE_EVERY[mode]), **extra,
        )
        start = time.perf_counter()
        code = subprocess.run(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--rescale-worker", mode, root],
            cwd=here, env=run_env, timeout=600,
        ).returncode
        wall = time.perf_counter() - start
        with open(os.path.join(root, f"{mode}.json")) as f:
            report = json.load(f)
        # From the end of the last step to the process's exit: the stop;
        # its last part from the worker's exit hook (after the final save
        # and the shard server's spawn) on.
        now = time.time()
        report["stop_s"] = now - report["last_step_end"]
        report["teardown_s"] = now - report["written"]
        check(code == 143, f"rescale {mode} exited {code}, expected 143")
        check(len(report["steps"]) == RESCALE_PLAN[mode][1],
              f"rescale {mode} took {len(report['steps'])} steps")
        check(report["build"]["hit"] and report["build"]["seconds"] < 1.0,
              f"rescale {mode} rebuilt the kernels: {report['build']}")
        launches = report["launches"]
        check(launches[KERNEL_SM90] > 0 and launches[KERNEL] == 0,
              f"rescale {mode} launches {launches}")
        print(
            f"rescale {mode}: {wall:.1f} s, stop {report['stop_s']:.2f} s (exit "
            f"teardown {report['teardown_s']:.2f} s), kernel "
            f"build {report['build']['seconds']:.2f} s "
            f"(cache {'hit' if report['build']['hit'] else 'cold'}, "
            f"{report['build']['dir']}), steps ms "
            f"{[round(s['seconds'] * 1e3, 1) for s in report['steps']]}, losses "
            f"{[round(s['loss'], 4) for s in report['steps']]}, launches {launches}",
            flush=True,
        )
        return report

    def peer(group, timeout=60.0):
        """The descriptor of incarnation ``group``'s shard server, which
        the detached child writes once it serves (after its parent's
        exit, so it is waited for)."""
        path = os.path.join(ckpt_root, handoff.DESCRIPTOR_NAME)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with open(path) as f:
                    body = json.load(f)
                if body.get("group") == group:
                    return body
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        check(False, f"no shard server of incarnation {group} advertised in {timeout} s")

    start = time.perf_counter()
    try:
        # 1. Incarnation 0: periodic saves in the background, then a stop.
        first = run("first")
        saves = first["saves"]
        # A periodic save after every RESCALE_SAVE_EVERY-th step but the
        # last (whose stop saves blocking).
        periodic = (RESCALE_PLAN["first"][1] - 1) // RESCALE_SAVE_EVERY["first"]
        check(len(saves) == periodic
              and all(s["write_s"] is not None for s in saves),
              f"first: saves {saves}, expected {periodic}")
        seconds = [s["seconds"] for s in first["steps"]]
        after = {s["after_step"] + 1 for s in saves}
        others = [t for i, t in enumerate(seconds, 1) if i not in after and i > 1]
        for s in saves:
            print(
                f"rescale first: save after step {s['after_step']}: blocked "
                f"{s['snapshot_s'] * 1e3:.1f} ms (snapshot), write "
                f"{s['write_s']:.2f} s in the background; step "
                f"{s['after_step'] + 1} {seconds[s['after_step']] * 1e3:.1f} ms "
                f"against the others' median {_median(others) * 1e3:.1f} ms"
            )
        stats = first["restart_stats"]
        print(
            f"rescale first: pinned host buffers {first['host_buffer_bytes'] / 1e9:.3f} GB; "
            f"final blocking save {stats['snapshotS']:.3f} s snapshot + "
            f"{stats['writeS']:.2f} s write, {stats['saveBytes'] / 1e9:.3f} GB"
        )
        dirs = sorted(os.listdir(ckpt_root))
        for name in dirs:
            path = os.path.join(ckpt_root, name)
            if checkpoint.is_good_checkpoint(path):
                with open(os.path.join(path, "manifest.json")) as f:
                    states = json.load(f)["states"]
                check(all(checkpoint._verify(path, n) == "ok" for n in states),
                      f"GOOD marker on an incomplete {name}")
        good = [d for d in dirs if checkpoint.is_good_checkpoint(os.path.join(ckpt_root, d))]
        check(good, f"no save earned a GOOD marker: {dirs}")
        print(f"rescale first: dirs {dirs}, GOOD on {good} (each complete)")
        peer0 = peer(0)
        check(peer0["group"] == 0 and os.path.exists(f"/proc/{peer0['pid']}"),
              f"first left no shard server: {peer0}")

        # 2. Successor A: every state from the peer, bit-equal to storage.
        successor = run("successor")
        sources = set(successor["loaded_from"].values())
        check(sources == {checkpoint.HANDOFF_SOURCE},
              f"successor restored from {successor['loaded_from']}")
        storage = successor["storage"]
        check(successor["restored_checksums"] == first["checksums"]
              == storage["checksums"], "successor: peer, storage and the "
              "stopping incarnation's state differ")
        moved = successor["handoff"]
        print(
            f"rescale successor: {len(successor['loaded_from'])} states from the "
            f"peer in {moved['seconds']:.2f} s ({moved['bytes'] / 1e9:.3f} GB; "
            f"trainer state {successor['restore_s']:.2f} s); storage restore of "
            f"{storage['source']} {storage['seconds']:.2f} s; checksums equal"
        )
        code = _reap(peer0["pid"], "the first shard server")
        check(code in (0, None), f"the first shard server exited {code}")
        print(f"rescale successor: the first shard server exited ({code}) on /done")
        peer1 = peer(1)
        check(peer1["group"] == 1, f"successor's shard server {peer1}")

        # 3. Successor B: a failed fetch falls back to storage; then a
        # preemption notice while a periodic write is in flight.
        fallback = run(
            "fallback",
            ADAPTDL_FAULT_SPEC="handoff.fetch=fail@1;preempt.notice=fail@1",
        )
        check(checkpoint.HANDOFF_SOURCE not in fallback["loaded_from"].values(),
              f"fallback restored from {fallback['loaded_from']}")
        check(fallback["restored_checksums"] == successor["checksums"],
              "fallback: the storage restore differs from the successor's state")
        notice = fallback["notice"]
        check(notice and notice["drained"] and notice["drainS"] <= notice["budgetS"],
              f"fallback: drain {notice}")
        check(recorder.seen(RESCALE_JOB, "preempt"), "no /preempt reached the supervisor")
        print(
            f"rescale fallback: storage restore {fallback['restore_s']:.2f} s, "
            f"bit-equal; urgent drain {notice['drainS']:.2f} s within its "
            f"{notice['budgetS']:.0f} s budget"
        )
        code = _reap(peer1["pid"], "the successor's shard server")
        check(code in (0, None), f"the successor's shard server exited {code}")
        print(f"rescale fallback: the successor's shard server exited ({code}) "
              "on the fallback's /done")

        # 4. The trace: incarnation 0 and successor A under one trace id.
        records = trace.read_journal(
            os.path.join(root, "trace", "trace-smoke-rescale.jsonl")
        )
        trace_id = trace.parse_traceparent(decision)[0]
        by_inc = {}
        for rec in records:
            by_inc.setdefault(rec["inc"], []).append(rec)
        names = {i: {r["name"] for r in recs} for i, recs in by_inc.items()}
        check({"ckpt.snapshot", "ckpt.write"} <= names.get(0, set())
              and {"handoff.fetch", "restart.first_step"} <= names.get(1, set()),
              f"trace journal spans {names}")
        check({r["trace"] for r in by_inc[0] + by_inc[1]} == {trace_id},
              "incarnations 0 and 1 are not in one trace")
        drains = [r for r in by_inc.get(2, []) if r["name"] == "drain.save"]
        check(len(drains) == 1 and drains[0]["attrs"]["joined_inflight"]
              and "drain.deadline_exceeded" not in names.get(2, set()),
              f"drain spans {drains}")
        summary = trace.phase_summary(by_inc[0] + by_inc[1])
        print(f"rescale trace {trace_id}: phase medians (s) "
              f"{ {k: round(v, 4) for k, v in sorted(summary.items())} }")
        with recorder.cond:
            flushed = {r.get("inc") for r in recorder.spans.get(RESCALE_JOB, [])}
        check({0, 1, 2} <= flushed, f"spans reached the supervisor from {flushed}")
        check(not _children(), f"processes left behind: {_children()}")
        for row in kernel_rows:
            row["rescale_launches"] = {
                mode: report["launches"][row["name"]]
                for mode, report in (("first", first), ("successor", successor),
                                     ("fallback", fallback))
            }
        print(f"rescale: phase {time.perf_counter() - start:.1f} s")
    finally:
        # A failed phase may leave incarnations' shard servers behind.
        for pid in _children():
            try:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            except (ProcessLookupError, ChildProcessError):
                pass
        shutil.rmtree(root, ignore_errors=True)


# -- phase 9: the LM's one-card options ---------------------------------------

OPTIONS_JOB_STEPS = 6  # MoE LM steps after calibration
OPTIONS_BARE_STEPS = 4  # bare train_step runs per head / policy (first warms up)
OPTIONS_POLICIES = (
    "nothing_saveable", "dots_with_no_batch_dims_saveable", "everything_saveable",
)
OPTIONS_GROUPS_LAYERS = 4  # depth of 9e's trainers (2 MoE blocks), full width
MOE_CHECK_TOKENS = 2048  # tokens of the index-vs-one-hot check


def _moe_lm_config(**kw):
    from adaptdl_tpu_torch.examples.transformer_lm import lm_config

    return dataclasses.replace(
        lm_config(cpu=False, seq_len=512, flash=True, moe_experts=8, moe_top_k=2), **kw
    )


def options_moe_check(device):
    """The index-form MoE FFN against its one-hot plain version on the
    card, at the full width's d, f, 8 experts and the reduced token count
    MOE_CHECK_TOKENS (the one-hot tensors are s x E x C floats): routing
    bit-equal, outputs within 1e-5 of the largest output (float32
    accumulation order; TF32 is off)."""
    from adaptdl_tpu_torch.models import moe
    from adaptdl_tpu_torch.models.transformer import MoEFFN

    config = _moe_lm_config()
    layer = MoEFFN(config)
    with torch.no_grad():
        layer.router.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(9))
        for w in (layer.w_up, layer.w_down):
            w.normal_(0.0, (w.shape[0] * w.shape[1]) ** -0.5,
                      generator=torch.Generator().manual_seed(w.shape[1]))
    layer = layer.to(device)
    x = torch.randn(MOE_CHECK_TOKENS, config.d_model,
                    generator=torch.Generator().manual_seed(3)).to(device)
    params = {"w_up": layer.w_up, "w_down": layer.w_down}
    result = {}
    with torch.no_grad():
        for router, top_k in (("tokens", 2), ("experts", 1)):
            cap = moe.capacity(router, 2.0, top_k, MOE_CHECK_TOKENS, 8)
            routing = moe.route(x, layer.router, 8, cap, top_k, router)
            if router == "experts":
                dispatch, combine, _ = moe.expert_choice_routing_onehot(x, layer.router, 8, cap)
            else:
                dispatch, combine, _ = moe.routing_onehot(x, layer.router, 8, cap, top_k)
            got_d, got_c = moe.onehot_from_routing(routing, MOE_CHECK_TOKENS, 8, cap)
            check(torch.equal(got_d, dispatch) and torch.equal(got_c, combine),
                  f"MoE {router} routing differs from the one-hot version")
            kw = dict(top_k=top_k, router_type=router)
            ref = moe.dense_switch_moe_reference(layer.router, params, x, **kw)
            out = moe.dense_switch_moe(layer.router, params, x, **kw)
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            ms = cuda_ms(lambda: moe.dense_switch_moe(layer.router, params, x, **kw), 5)
            plain_ms = cuda_ms(
                lambda: moe.dense_switch_moe_reference(layer.router, params, x, **kw), 5
            )
            print(
                f"options: MoE FFN {router} top-{top_k} at {MOE_CHECK_TOKENS} tokens x "
                f"{config.d_model} (C {cap}): routing bit-equal to one-hot, max|index - "
                f"one-hot| {err:.3g} (tol 1e-5 x {scale:.3g}); {ms:.3f} ms against "
                f"one-hot {plain_ms:.3f} ms"
            )
            check(torch.isfinite(out).all().item() and err <= 1e-5 * scale,
                  f"MoE {router}: index form off its one-hot version by {err}")
            result[router] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return result


def _routing_report(model, tokens):
    """(weighted aux, share of (token, choice) pairs dropped, share of
    tokens no kept pair routes) of one forward, from the MoE blocks'
    inputs captured by hooks."""
    from adaptdl_tpu_torch.models import moe
    from adaptdl_tpu_torch.models.transformer import MoEFFN, apply_with_moe_aux

    cfg = model.config
    seen = []
    hooks = [
        m.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
        for m in model.modules() if isinstance(m, MoEFFN)
    ]
    try:
        with torch.no_grad():
            _, aux = apply_with_moe_aux(model, tokens)
            kept = total = unrouted = tokens_seen = 0
            for x, layer in zip(seen, (m for m in model.modules() if isinstance(m, MoEFFN))):
                flat = x.reshape(-1, cfg.d_model)
                cap = moe.capacity(cfg.moe_router, cfg.moe_capacity_factor,
                                   cfg.moe_top_k, flat.shape[0], cfg.moe_num_experts)
                routing = moe.route(flat, layer.router, cfg.moe_num_experts, cap,
                                    cfg.moe_top_k, cfg.moe_router)
                kept += int(routing.kept.sum())
                total += routing.kept.numel()
                routed = torch.unique(routing.token[routing.kept]).numel()
                unrouted += flat.shape[0] - routed
                tokens_seen += flat.shape[0]
    finally:
        for h in hooks:
            h.remove()
    return float(aux), 1.0 - kept / total, unrouted / tokens_seen


def options_moe_lm(device):
    """9a: the full-width MoE LM with the chunked head through
    initialize_job -> AdaptiveDataLoader -> run_step."""
    from adaptdl_tpu_torch import checkpoint, flops, metrics
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.examples.transformer_lm import synthetic_tokens
    from adaptdl_tpu_torch.models import init_transformer
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.chunked_xent import chunked_lm_loss_fn
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-moe-")
    try:
        config = _moe_lm_config()
        model = init_transformer(config, seed=0, device=device)
        n_params = sum(p.numel() for p in model.parameters())
        trainer = ElasticTrainer(
            chunked_lm_loss_fn(4096), model, AdamW(model.parameters(), lr=3e-4),
            init_batch_size=32, scaling_rule=AdamScale(), precondition="adam",
            device=device,
        )
        holder = {"state": trainer.init_state()}
        ckpt = trainer.make_checkpoint_state(
            lambda: holder["state"], lambda s: holder.__setitem__("state", s)
        )
        check(not checkpoint.load_state(ckpt), "fresh run found a checkpoint")
        metrics.ensure_checkpoint_registered()
        dataset = synthetic_tokens(32 * (OPTIONS_JOB_STEPS + 2), 512, config.vocab_size)
        loader = AdaptiveDataLoader(dataset, batch_size=32)
        _build.reset_launches()
        losses, seconds = _drive(trainer, holder, loader, OPTIONS_JOB_STEPS,
                                 plan=[(32, 0)] * OPTIONS_JOB_STEPS)
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        per_step = 2 * config.num_layers  # forward + remat recompute
        expected = per_step * (OPTIONS_JOB_STEPS + trainer.calibrate_repeats + 1)
        check(launches.get(KERNEL_SM90, 0) == expected and not launches.get(KERNEL),
              f"MoE LM launched {launches}, expected {expected} sm90 and 0 f32")
        aux, dropped, unrouted = _routing_report(
            model, torch.as_tensor(dataset["tokens"][:32, :-1], device=device)
        )
        step_s = _median(seconds[1:])
        model_flops = flops.transformer_train_flops(config, 32, 512).total
        peak_flops = flops.device_peak_flops(device)
        mfu = flops.mfu(model_flops, step_s, device=device)
        dense_mfu = None
        dense_formula = (6 * n_params + 12 * config.num_layers * config.d_model * 512) * 32 * 512
        if peak_flops:
            dense_mfu = dense_formula / step_s / peak_flops
        print(
            f"options: MoE LM ({n_params / 1e6:.1f} M params, 8 experts top-2 every 2nd "
            f"block, chunked head 4096): losses {[round(x, 4) for x in losses]}; step "
            f"{step_s * 1e3:.1f} ms (median of steps 2-{OPTIONS_JOB_STEPS}, (32, 0) x 512), "
            f"{32 * 512 / step_s:.0f} tokens/s, MFU {mfu} ({model_flops / 1e12:.3f} "
            f"TFLOP/step by flops.py over peak {peak_flops} FLOP/s; 6N+12LdS counts "
            f"{dense_formula / 1e12:.3f}, MFU {dense_mfu}), peak memory "
            f"{peak / 2**30:.2f} GiB; aux {aux:.5f} (weighted), dropped (token, choice) "
            f"pairs {dropped:.4f}, unrouted tokens {unrouted:.4f}; "
            f"launches {launches}; step times ms {[round(s * 1e3, 1) for s in seconds]}"
        )
        check(all(math.isfinite(x) for x in (aux, dropped)), "MoE aux not finite")
        return {
            "launches": launches, "step_ms": step_s * 1e3, "mfu": mfu, "peak_gib": peak / 2**30,
            "aux": aux, "dropped": dropped, "unrouted": unrouted,
        }
    finally:
        metrics.join_fit()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _bare_steps(trainer, batches):
    """(losses, seconds, peak bytes, sm90 launches per step) of bare
    train_step runs at (32, 0), the first a warm-up."""
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL_SM90

    step = trainer.train_step(32, 0)
    state = trainer.init_state()
    losses, seconds = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    for batch in batches:
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, m = step(state, trainer.to_device(batch))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        losses.append(float(m["loss"]))
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    launches = _build.LAUNCHES[KERNEL_SM90] / len(batches)
    return losses, seconds, torch.cuda.max_memory_allocated(), launches


def _dense_lm_trainer(device, loss_fn, **config_kw):
    from adaptdl_tpu_torch.examples.transformer_lm import lm_config
    from adaptdl_tpu_torch.models import init_transformer
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    config = lm_config(cpu=False, seq_len=512, flash=True, **config_kw)
    model = init_transformer(config, seed=0, device=device)
    return ElasticTrainer(
        loss_fn, model, AdamW(model.parameters(), lr=3e-4), init_batch_size=32,
        scaling_rule=AdamScale(), precondition="adam", device=device,
    )


def _window_lm_loss(chunked):
    """The JAX example's loss over {"inputs", "targets"} windows: the
    dense head (bf16 logits, F.cross_entropy) or the chunked one."""
    import torch.nn.functional as F

    from adaptdl_tpu_torch.models.transformer import apply_with_moe_aux
    from adaptdl_tpu_torch.ops.chunked_xent import chunked_softmax_xent

    def loss_fn(model, batch, generator=None):
        out, aux = apply_with_moe_aux(model, batch["inputs"], return_hidden=chunked)
        if chunked:
            losses = chunked_softmax_xent(
                out.reshape(-1, out.shape[-1]), model.embed.weight,
                batch["targets"].reshape(-1), 4096,
            )
            return losses.mean() + aux
        return F.cross_entropy(
            out.reshape(-1, out.shape[-1]), batch["targets"].reshape(-1).long()
        ) + aux

    return loss_fn


def options_heads(device):
    """9b: the chunked head against the dense head on the main path's
    dense LM, bare train_step runs at (32, 0) fed by AdaptiveBPTTLoader
    over a synthetic flat corpus. The two losses of the first step (same
    weights, same batch) differ by the heads' precision: the dense head
    rounds both product operands and its output to bf16 (each at most
    2^-9 relative), the chunked one multiplies a bf16 hidden by the
    float32 table in float32, as the reference; the bound is 2^-7 of the
    largest logit."""
    import numpy as np

    from adaptdl_tpu_torch import metrics
    from adaptdl_tpu_torch.iterator import AdaptiveBPTTLoader

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-heads-")
    try:
        corpus = np.random.default_rng(0).integers(
            0, 32000, 32 * 512 * OPTIONS_BARE_STEPS + 1
        )
        loader = AdaptiveBPTTLoader(corpus, batch_size=32, bptt=512, shuffle=False)
        batches = []
        for batch in loader:
            batches.append(batch)
        check(len(batches) == OPTIONS_BARE_STEPS and batches[0]["inputs"].shape == (32, 512),
              f"BPTT loader yielded {len(batches)} batches")
        result = {}
        for name in ("dense", "chunked"):
            trainer = _dense_lm_trainer(device, _window_lm_loss(name == "chunked"))
            if name == "dense":
                with torch.no_grad():
                    first = trainer.to_device(batches[0])
                    max_logit = trainer.model(first["inputs"]).abs().max().item()
            losses, seconds, peak, launches = _bare_steps(trainer, batches)
            result[name] = {"loss": losses[0], "step_ms": _median(seconds[1:]) * 1e3,
                            "peak_gib": peak / 2**30, "launches": launches}
            del trainer
            gc_cuda()
        diff = abs(result["chunked"]["loss"] - result["dense"]["loss"])
        tol = 2.0**-7 * max_logit
        print(
            f"options: heads at (32, 0) x 512 (AdaptiveBPTTLoader): dense {result['dense']}, "
            f"chunked 4096 {result['chunked']}; first-step |loss chunked - dense| "
            f"{diff:.3g} (tol 2^-7 x max|logit| {max_logit:.3g} = {tol:.3g})"
        )
        check(diff <= tol, f"chunked head off the dense head by {diff}")
        return result
    finally:
        metrics.join_fit()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def options_remat(device):
    """9c: per remat policy on the dense main-path LM, gradients against
    today's remat on one batch, then bare steps (peak memory, step time,
    sm90 launches per step: 24 where blocks are recomputed, 12 under
    everything_saveable). The recompute runs the same kernels on the same
    inputs, so the gradients agree to float32 reduction order at most:
    each tensor within 2^-16 of its largest entry."""
    from adaptdl_tpu_torch import metrics
    from adaptdl_tpu_torch.examples.transformer_lm import synthetic_tokens
    from adaptdl_tpu_torch.models import lm_loss_fn
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import flash_attention_fwd

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-remat-")
    try:
        # The flash forward is deterministic: a recompute equals the forward.
        q, k, v = (torch.randn(384, 512, 64, generator=torch.Generator().manual_seed(i))
                   .to(device, torch.bfloat16) for i in range(3))
        a, b = (flash_attention_fwd(q, k, v) for _ in range(2))
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              "two flash forwards on one input differ")
        data = synthetic_tokens(32 * OPTIONS_BARE_STEPS, 512, 32000)
        batches = [{"tokens": data["tokens"][i * 32:(i + 1) * 32]}
                   for i in range(OPTIONS_BARE_STEPS)]
        result, reference = {}, None
        for policy in (None,) + OPTIONS_POLICIES:
            trainer = _dense_lm_trainer(device, lm_loss_fn, remat_policy=policy)
            micro = trainer.to_device(batches[0])
            _build.reset_launches()
            loss = lm_loss_fn(trainer.model, micro)
            grads = torch.autograd.grad(loss, list(trainer.model.parameters()))
            grad_launches = dict(_build.LAUNCHES)
            if policy is None:
                reference = grads
                del trainer, grads
                gc_cuda()
                continue
            worst = max(
                ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
                for g, r in zip(grads, reference)
            )
            del grads
            losses, seconds, peak, launches = _bare_steps(trainer, batches)
            layers = trainer.model.config.num_layers
            expected = layers if policy == "everything_saveable" else 2 * layers
            result[policy] = {
                "step_ms": _median(seconds[1:]) * 1e3, "peak_gib": peak / 2**30,
                "launches_per_step": launches, "grad_rel_err": worst,
            }
            print(f"options: remat {policy}: {result[policy]}, gradient launches "
                  f"{grad_launches}")
            check(launches == expected, f"{policy}: {launches} sm90 launches per step, "
                  f"expected {expected}")
            check(worst <= 2.0**-16, f"{policy}: gradients off today's remat by {worst}")
            del trainer
            gc_cuda()
        return result
    finally:
        metrics.join_fit()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def options_bert_experts(device):
    """9d: BERT MLM with 8 experts every second block, expert-choice
    routing, through the example's make_trainer and make_loader."""
    from adaptdl_tpu_torch import checkpoint, metrics
    from adaptdl_tpu_torch.examples import bert_mlm

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-bert-moe-")
    try:
        trainer, holder, ckpt = bert_mlm.make_trainer(
            device, cpu=False, moe_experts=8, moe_router="experts"
        )
        checkpoint.load_state(ckpt)
        metrics.ensure_checkpoint_registered()
        cfg = trainer.model.config
        check(cfg.moe_router == "experts" and not cfg.causal, f"BERT config {cfg}")
        loader = bert_mlm.make_loader(cpu=False)
        losses, seconds = _drive(trainer, holder, loader, 4)
        aux, _, unrouted = _routing_report(
            trainer.model,
            torch.as_tensor(loader.dataset["tokens"][:32], device=device),
        )
        step_s = _median(seconds[1:])
        peak = torch.cuda.max_memory_allocated()
        print(
            f"options: BERT MLM expert choice (8 experts every 2nd block): losses "
            f"{[round(x, 4) for x in losses]}, step {step_s * 1e3:.1f} ms "
            f"(({loader.current_atomic_bsz}, {loader.current_accum_steps}) x 512), peak "
            f"memory {peak / 2**30:.2f} GiB, aux {aux} (expert choice: 0), tokens no "
            f"expert took {unrouted:.4f}"
        )
        check(aux == 0.0, f"expert choice aux {aux}")
        return {"step_ms": step_s * 1e3, "peak_gib": peak / 2**30}
    finally:
        metrics.join_fit()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def options_groups(device):
    """9e: the MoE LM's trainer (full width, depth OPTIONS_GROUPS_LAYERS)
    with expert weights in group 1: GNS state of shape (2,), finite LR
    factors; everything in group 0 is bit-equal to no groups."""
    from adaptdl_tpu_torch import metrics
    from adaptdl_tpu_torch.examples.transformer_lm import synthetic_tokens
    from adaptdl_tpu_torch.models import init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale, RuleContext
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-groups-")
    try:
        config = _moe_lm_config(num_layers=OPTIONS_GROUPS_LAYERS)
        data = synthetic_tokens(32 * 3, 512, 32000)
        batches = [{"tokens": data["tokens"][i * 32:(i + 1) * 32]} for i in range(3)]

        def run(group_fn):
            model = init_transformer(config, seed=0, device=device)
            trainer = ElasticTrainer(
                lm_loss_fn, model, AdamW(model.parameters(), lr=3e-4),
                init_batch_size=32, scaling_rule=AdamScale(), precondition="adam",
                device=device, param_group_fn=group_fn,
            )
            state, step = trainer.init_state(), trainer.train_step(16, 1)
            for batch in batches:
                state, m = step(state, trainer.to_device(batch))
            factors = trainer.scaling_rule.lr_factor_groups(RuleContext(
                scale=float(m["scale"]), batch_size=32, init_batch_size=32,
                gns_state=state.gns, progress=state.progress,
            ))
            return trainer, state, factors

        def experts(name, param):
            return 1 if name.endswith(("moe.w_up", "moe.w_down")) else 0

        trainer, state, factors = run(experts)
        sqr = state.gns.sqr_biased
        check(trainer.num_param_groups == 2 and tuple(sqr.shape) == (2,)
              and torch.isfinite(factors).all().item() and factors.shape == (2,),
              f"two groups: gns {tuple(sqr.shape)}, factors {factors}")
        print(f"options: two groups (experts in group 1): LR factors "
              f"{factors.tolist()}, raw sqr {sqr.tolist()}")
        del trainer, state
        gc_cuda()
        runs = [run(fn)[:2] for fn in (None, lambda name, p: 0)]
        (t0, s0), (t1, s1) = runs
        _equal_states(t0.model, t0.optimizer, t1.model, t1.optimizer, "group 0")
        g0, g1 = s0.gns.tensors(), s1.gns.tensors()
        for key in g0:
            pairs = zip(g0[key], g1[key]) if key == "prev_grad" else [(g0[key], g1[key])]
            check(all(torch.equal(x, y) for x, y in pairs), f"group 0: gns.{key} differs")
        print("options: everything in group 0 is bit-equal to no groups "
              f"(3 steps at (16, 1), depth {OPTIONS_GROUPS_LAYERS})")
        return {"factors": factors.tolist()}
    finally:
        metrics.join_fit()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def options_tutorial(device):
    """9f: tutorial step 5 on the card: one epoch, a save, then a
    restart that restores both loaders and runs the next epoch with its
    evaluation loop."""
    from adaptdl_tpu_torch import checkpoint, epoch, guard, metrics
    from adaptdl_tpu_torch.tutorial import mnist_step_5

    ckpt_dir = _zoo_job("adaptdl-torch-smoke-tutorial-")
    try:
        first = mnist_step_5.main(["--epochs", "1"])
        checkpoint.save_all_states()
        metrics.join_fit()
        for reset in (checkpoint._reset_registry, metrics._reset_state,
                      epoch._reset_state, guard._reset_state):
            reset()
        os.environ["ADAPTDL_NUM_RESTARTS"] = "1"
        try:
            second = mnist_step_5.main(["--epochs", "2"])
        finally:
            del os.environ["ADAPTDL_NUM_RESTARTS"]
        restored = {n for n in ("adaptdl_dataloader", "eval-loader")
                    if n in checkpoint._loaded_from}
        print(f"options: tutorial step 5: {first} then, restored {sorted(restored)}: {second}")
        check([h["epoch"] for h in first] == [0] and [h["epoch"] for h in second] == [1],
              f"tutorial epochs {first} {second}")
        check(restored == {"adaptdl_dataloader", "eval-loader"}, f"restored {restored}")
        check(second[0]["acc"] > 0.5, f"tutorial accuracy {second[0]['acc']}")
        return {"acc": second[0]["acc"]}
    finally:
        metrics.join_fit()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def phase_options(kernel_rows):
    """Phase 9: the LM's one-card options, each part with the flash
    launch counts reset just before and read just after it."""
    import adaptdl_tpu_torch
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    start = time.perf_counter()
    device = adaptdl_tpu_torch.initialize_job(device="cuda")
    results = {"moe_check": options_moe_check(device)}
    parts = {
        "moe_lm": options_moe_lm, "heads": options_heads, "remat": options_remat,
        "bert_experts": options_bert_experts, "groups": options_groups,
        "tutorial": options_tutorial,
    }
    launches = {}
    for name, run in parts.items():
        part_start = time.perf_counter()
        _build.reset_launches()
        results[name] = run(device)
        launches[name] = dict(_build.LAUNCHES)
        print(f"options {name}: {time.perf_counter() - part_start:.1f} s, flash launches "
              f"{launches[name]}")
    for name in ("bert_experts", "tutorial"):
        check(not any(launches[name].values()), f"{name} launched {launches[name]}")
    check(not any(c.get(KERNEL, 0) for c in launches.values()),
          f"phase 9 launched {KERNEL}: {launches}")
    for row in kernel_rows:
        sm90 = row["name"] == KERNEL_SM90
        row["options_launches"] = {
            # The MoE LM's steps and calibration alone (9a), then each
            # part's whole count, and per bare step under each policy.
            "moe_lm_steps": results["moe_lm"]["launches"].get(row["name"], 0),
            **{n: c.get(row["name"], 0) for n, c in launches.items()},
            "remat_per_step": {
                p: r["launches_per_step"] if sm90 else 0
                for p, r in results["remat"].items()
            },
        }
    print(f"options: phase {time.perf_counter() - start:.1f} s")
    return results


# -- phase 10: the control plane ------------------------------------------------

CONTROL_JOB = "smoke/elastic-lm"
CONTROL_STEPS = 50  # the 10a LM's step budget across its incarnations
CO_LM_STEPS = 12  # 10b's LM
CO_LINEAR_STEPS = 3000  # 10b's linear regression
CONTROL_ENV = {
    "ADAPTDL_FIT_INTERVAL": "2", "ADAPTDL_HEARTBEAT_INTERVAL": "1",
    "OMP_NUM_THREADS": "4",
}


def _percentile(values, q):
    values = sorted(values)
    if not values:
        return float("nan")
    return values[min(int(math.ceil(q / 100 * len(values))) - 1, len(values) - 1)]


def _reports(report_dir):
    """Each incarnation's rank reports: {restarts: [report by rank]}."""
    out = {}
    for name in sorted(os.listdir(report_dir)):
        if name.startswith("report-") and name.endswith(".json"):
            with open(os.path.join(report_dir, name)) as f:
                report = json.load(f)
            out.setdefault(report["restarts"], []).append(report)
    for ranks in out.values():
        ranks.sort(key=lambda r: r["rank"])
    return out


def _journal(trace_dir, job):
    from adaptdl_tpu_torch import trace

    return trace.read_journal(
        os.path.join(trace_dir, f"trace-{job.replace('/', '-')}.jsonl"))


def _route_ms(records):
    """The job's hint and heartbeat round trips as its ranks saw them
    (the rpc.request spans of its span journal), ms by route, and the
    accepted hint posts per incarnation."""
    ms = {"hints": [], "heartbeat": []}
    hints_ok = {}
    for rec in records:
        if rec["name"] != "rpc.request":
            continue
        route = rec["attrs"].get("endpoint", "").split("/", 1)[0]
        if route in ms:
            ms[route].append(rec["dur"] * 1e3)
        if route == "hints" and rec["attrs"].get("status") == 200:
            hints_ok[rec["inc"]] = hints_ok.get(rec["inc"], 0) + 1
    return ms, hints_ok


def _stall(reports, restarts):
    """Seconds from the predecessor's last completed step (its slowest
    rank's) to the successor's first (its slowest rank's)."""
    return (max(r["first_step_wall"] for r in reports[restarts])
            - max(r["last_step_wall"] for r in reports[restarts - 1]))


def _step_walls(report):
    """The wall clock at the end of each of a report's steps."""
    walls, at = [], report["ready_wall"]
    for seconds in report["step_s"]:
        at += seconds
        walls.append(at)
    return walls


def _check_incarnations(reports, launches, what):
    """Every launch's reports: the launched replica count, resumed at the
    predecessor's saved step, finite losses, equal parameters across
    ranks, sm90 launches > 0 and f32 launches 0 in every incarnation."""
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    check(sorted(reports) == list(range(len(launches))),
          f"{what}: reports of incarnations {sorted(reports)}, "
          f"launches {len(launches)}")
    end = 0
    for restarts, launch in enumerate(launches):
        ranks = reports[restarts]
        check(len(ranks) == launch["replicas"]
              and all(r["replicas"] == launch["replicas"] for r in ranks),
              f"{what}: incarnation {restarts} ran {len(ranks)} ranks, "
              f"launched {launch['replicas']}")
        check(all(r["start_step"] == end for r in ranks),
              f"{what}: incarnation {restarts} resumed at "
              f"{[r['start_step'] for r in ranks]}, saved {end}")
        check(all(r["losses"] and r["losses_finite"] for r in ranks),
              f"{what}: incarnation {restarts} losses not finite")
        check(len({r["params_sha256"] for r in ranks}) == 1
              and len({r["end_step"] for r in ranks}) == 1,
              f"{what}: incarnation {restarts} ranks disagree")
        for r in ranks:
            check(r["launches"].get(KERNEL_SM90, 0) > 0
                  and r["launches"].get(KERNEL, 0) == 0,
                  f"{what}: incarnation {restarts} rank {r['rank']} launches "
                  f"{r['launches']}")
        end = ranks[0]["end_step"]
    return end


def _check_published(events, published, job, what):
    """Every launch carries out the allocation the allocator published
    last before it."""
    launches = [e for e in events if e["event"] == "launch"]
    for launch in launches:
        before = [a for at, key, a in published if key == job and at <= launch["time"]]
        check(before and before[-1] == launch["allocation"],
              f"{what}: launch {launch} is not the published {before[-1:]}")
    return launches


def _print_cycles(allocator, job, start, state):
    """Every Pollux decision: when, the allocation, the speedups scored,
    the cycle's ms."""
    from adaptdl_tpu_torch.sched.allocator import job_info_from_hints

    for cycle in allocator.cycles:
        explain = cycle["explain"] or {}
        terms = (explain.get("jobs") or {}).get(job, {})
        losers = [l["speedup"] for l in explain.get("losers") or []]
        scored = (
            f"speedup {terms.get('speedup')} (winner "
            f"{(explain.get('winner') or {}).get('speedup')}, losers {losers})"
            if terms.get("speedup") is not None
            else "nothing dirty: the allocation kept, nothing scored"
        )
        print(f"pollux t={cycle['time'] - start:7.2f} s {cycle['mode']:<11} "
              f"allocation {cycle['allocations'].get(job)} {scored} "
              f"cycle {cycle['seconds'] * 1e3:.2f} ms")
    record = state.get_job(job)
    if record.hints:
        info = job_info_from_hints(record.hints, record.spec, 0.0)
        print(f"pollux {job}: speedup at 1 / 2 replicas from its last hints "
              f"{info.speedup_fn(1, 1):.4f} / {info.speedup_fn(1, 2):.4f}")


def _clean_environ():
    """This process's environment without the ADAPTDL_* settings earlier
    phases left (the share path stays: every incarnation loads its
    kernels from the cache there)."""
    return {k: v for k, v in os.environ.items()
            if not k.startswith("ADAPTDL_") or k == "ADAPTDL_SHARE_PATH"}


def _load_promcheck():
    """``tests/promcheck.py`` (a stdlib-only exposition parser) by its
    path: the card's machine has an installed package named ``tests``
    that hides this checkout's."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "promcheck.py")
    spec = importlib.util.spec_from_file_location("smoke_promcheck", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _get_route(url, route):
    """One GET: (ms, status, content type, body)."""
    start = time.perf_counter()
    try:
        with urllib.request.urlopen(url + route, timeout=10) as r:
            status, ctype, body = r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as exc:
        with exc:
            status, ctype, body = exc.code, exc.headers.get("Content-Type", ""), exc.read()
    return (time.perf_counter() - start) * 1e3, status, ctype, body


def _get_json(url, route, what):
    ms, status, _, body = _get_route(url, route)
    check(status == 200, f"{what}: GET {route} answered {status}: {body[:200]!r}")
    return ms, json.loads(body)


def explain_after_publish(runner, job, edited, what, wait):
    """Right after the last edit's publish: ``/explain`` holds a record
    of the cycle that published the job's allocation, and its allocation
    is the published one; returns (the cycle, the allocation)."""
    url = runner.supervisor.url

    def published():
        return [(at, a) for at, key, a in list(runner.allocator.published)
                if key == job and at >= edited]

    wait(lambda: published(), f"{what}: the last edit's publish", 60.0)
    at, alloc = published()[0]
    wait(lambda: any(c["time"] >= at for c in list(runner.allocator.cycles)),
         f"{what}: the publishing cycle's end", 30.0)
    cycle = next(c["cycle"] for c in list(runner.allocator.cycles) if c["time"] >= at)

    def records():
        history = _get_json(url, f"/explain/{job}", what)[1]["history"]
        return [r for r in history if r["cycle"] == cycle]

    wait(lambda: records(), f"{what}: the explain record of cycle {cycle}", 30.0)
    record = records()[-1]
    check(record["alloc"] == alloc and not record.get("pinned"),
          f"{what}: cycle {cycle} published {alloc}, its explain record {record}")
    return cycle, alloc


def operator_reads(runner, job, root, what, wait, restarts=2):
    """After the job's last rescale, while its last incarnation trains:
    ``/watch``, ``/explain``, ``/metrics`` and ``/status`` from the live
    supervisor, then the read-only CLI verbs against it, each a process
    of its own, all at once; returns the watch line's figures."""
    from adaptdl_tpu_torch import trace
    from adaptdl_tpu_torch.watch import tenant_of

    url = runner.supervisor.url
    launch = [e["time"] for e in runner.events if e["event"] in ("launch", "cutover")][-1]

    def ready():
        # Twice a second: each poll asks the supervisor for the job's
        # spans, and a busy supervisor would answer the jobs late.
        time.sleep(0.4)
        if runner.state.get_job(job).restarts != restarts:
            return False
        view = _get_json(url, "/watch", what)[1]["jobs"].get(job) or {}
        latest = view.get("latest") or {}
        spans = _get_json(url, f"/trace/{job}", what)[1]["spans"]
        return (latest.get("measured") is not None and latest["t"] >= launch
                and view.get("drift") is not None
                and any(r.get("inc") == restarts for r in spans))

    wait(ready, f"{what}: the last incarnation's watch sample and spans", 120.0)
    ms = {}
    ms["watch"], snap = _get_json(url, "/watch", what)
    ms["explain"], explain = _get_json(url, f"/explain/{job}", what)
    ms["metrics"], status, ctype, body = _get_route(url, "/metrics")
    ms["status"], status_payload = _get_json(url, "/status", what)
    ms["hints"], hints = _get_json(url, f"/hints/{job}", what)
    # /watch: goodput samples, measuredGoodput through the hints.
    view = snap["jobs"][job]
    check(view["latest"]["measured"] is not None and view["latest"]["predicted"],
          f"{what}: /watch sample {view['latest']}")
    check(hints.get("measuredGoodput") is not None, f"{what}: hints {sorted(hints)}")
    # /explain: the last decision is the allocation the job runs on.
    allocation = runner.state.get_job(job).allocation
    check(explain["lastDecision"]["alloc"] == allocation,
          f"{what}: last decision {explain['lastDecision']} against {allocation}")
    # /metrics: a conformant exposition with drift and the tenant families.
    check(status == 200 and ctype.startswith("text/plain"),
          f"{what}: /metrics {status} {ctype}")
    text = body.decode("utf-8")
    families = _load_promcheck().validate_exposition(text)["families"]
    tenant = tenant_of(job)
    check(any(labels.get("job") == job
              for _, labels, _ in families["adaptdl_goodput_drift"]["samples"]),
          f"{what}: no adaptdl_goodput_drift sample for {job}")
    for name in ("adaptdl_tenant_goodput_share", "adaptdl_tenant_jobs",
                 "adaptdl_tenant_slo_burn_total"):
        check(any(labels.get("tenant") == tenant
                  for _, labels, _ in families[name]["samples"]),
              f"{what}: no {name} sample for tenant {tenant}")
    # /status: the job carries its watch fields.
    fields = status_payload["jobs"][job]
    missing = [k for k in ("tenant", "goodputMeasured", "goodputPredicted",
                           "goodputDrift", "reprofile", "incidents", "rollbacks",
                           "lastGoodAge") if k not in fields]
    check(not missing, f"{what}: /status lacks {missing}")
    # The read-only verbs, each a process of its own, run side by side.
    here = os.path.dirname(os.path.abspath(__file__))
    perfetto = os.path.join(root, f"trace-{what}.json")
    verbs = {
        "status": ["status"], "top": ["top"], "explain": ["explain", job],
        "trace": ["trace", job, "--perfetto", perfetto],
    }
    env = dict(os.environ, PYTHONPATH=here)
    procs, started = {}, time.perf_counter()
    for verb, argv in verbs.items():
        procs[verb] = subprocess.Popen(
            [sys.executable, "-m", "adaptdl_tpu_torch.cli", *argv, "--supervisor", url],
            cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    cli_ms, outs = {}, {}
    for verb, proc in procs.items():
        outs[verb], err = proc.communicate(timeout=60)
        cli_ms[verb] = (time.perf_counter() - started) * 1e3
        check(proc.returncode == 0, f"{what}: cli {verb} exited {proc.returncode}: {err}")
    current = trace.parse_traceparent(runner.state.get_job(job).trace_parent)[0]
    for verb, text in (("status", job), ("top", "cluster:"), ("top", job),
                       ("explain", f"job {job}"), ("trace", f"trace {current}")):
        check(text in outs[verb], f"{what}: cli {verb} printed no {text!r}: {outs[verb]}")
    with open(perfetto) as f:
        events = json.load(f)["traceEvents"]
    ids = {e["args"]["trace_id"] for e in events if e["ph"] in ("X", "i")}
    check(ids == {current}, f"{what}: the Perfetto file holds traces {ids}, "
          f"the decision's {current}")
    incs = {}
    for e in events:
        if e["name"] == "process_name" and e["pid"] != os.getpid():
            incs[e["pid"]] = int(e["args"]["name"].rsplit("inc ", 1)[1].rstrip(")"))
    check(restarts in incs.values(),
          f"{what}: no span of incarnation {restarts} in the decision's trace: {incs}")
    overhead = snap["overhead"]
    line = {
        "job": job,
        "metrics_bytes": len(body),
        "metrics_families": len(families),
        "metrics_samples": sum(len(f["samples"]) for f in families.values()),
        "route_ms": ms,
        "cli_ms": cli_ms,
        "watch_samples": snap["samples"],
        "sample_s": overhead["sampleS"],
        "cycle_s": overhead["cycleS"],
        "sample_share": overhead["sampleS"] / overhead["cycleS"],
        "measured": view["latest"]["measured"],
        "predicted": view["latest"]["predicted"],
        "drift": view["drift"],
        "rho": view["latest"]["rho"],
        "trace_incarnations": sorted(set(incs.values())),
        "trace_spans": sum(1 for e in events if e["ph"] in ("X", "i")),
    }
    print(json.dumps({"watch": dict(line, phase=what)}), flush=True)
    return line


def control_single(root):
    """10a: one LM job under the port's LocalElasticRunner, 1 -> 2 -> 1."""
    from adaptdl_tpu_torch.sched.local_runner import LocalElasticRunner
    from adaptdl_tpu_torch.sched.validator import validate_job_spec

    here = os.path.dirname(os.path.abspath(__file__))
    reports_dir = os.path.join(root, "reports")
    trace_dir = os.path.join(root, "trace")
    runner = LocalElasticRunner(
        os.path.join(here, "adaptdl_tpu_torch", "examples", "transformer_lm.py"),
        num_chips=2, checkpoint_dir=os.path.join(root, "ckpt"),
        job_name=CONTROL_JOB, max_replicas=1, allocator_interval=2.0,
        extra_env=dict(CONTROL_ENV, ADAPTDL_TRACE_DIR=trace_dir),
        term_grace_period=120.0,
        script_args=["--flash", "--steps", str(CONTROL_STEPS),
                     "--report-dir", reports_dir],
    )
    edits, errors, degraded, operator = [], [], [], {}
    start = time.time()
    done = threading.Event()

    def edit(**bounds):
        record = runner.state.get_job(CONTROL_JOB)
        spec = dict(record.spec, **bounds)
        validate_job_spec(spec)
        runner.state.update(CONTROL_JOB, spec=spec)
        edits.append((time.time(), bounds))

    def wait(predicate, what, timeout=300.0):
        deadline = time.monotonic() + timeout
        while not predicate():
            if done.is_set() or time.monotonic() > deadline:
                raise RuntimeError(f"10a: gave up waiting for {what}")
            if runner.state.get_job(CONTROL_JOB).degraded:
                degraded.append(time.time())
            time.sleep(0.1)

    def drive():
        try:
            hints = lambda: runner.state.get_job(CONTROL_JOB).hints or {}  # noqa: E731
            wait(lambda: hints(), "the first incarnation's hints")
            edit(min_replicas=2, max_replicas=2)
            wait(lambda: hints().get("maxProfiledReplicas", 0) >= 2,
                 "the two-rank incarnation's hints")
            edit(min_replicas=1, max_replicas=1)
            operator["publish"] = explain_after_publish(
                runner, CONTROL_JOB, edits[-1][0], "10a", wait)
            operator.update(operator_reads(runner, CONTROL_JOB, root, "10a", wait))
            wait(lambda: runner.state.get_job(CONTROL_JOB).status
                 in ("Succeeded", "Failed"), "the end")
        except Exception as exc:  # noqa: BLE001 - checked below
            errors.append(exc)

    editor = threading.Thread(target=drive, daemon=True)
    editor.start()
    try:
        code = runner.run()
    finally:
        done.set()
        editor.join(timeout=30)
    record = runner.state.get_job(CONTROL_JOB)
    check(not errors, f"10a: {errors}")
    check(code == 0 and record.status == "Succeeded",
          f"10a: runner returned {code}, job {record.status}")
    check(not degraded and not record.degraded,
          "10a: a lease expired (the job went degraded)")
    launches = _check_published(runner.events, runner.allocator.published,
                                CONTROL_JOB, "10a")
    counts = [e["replicas"] for e in launches]
    check(counts == [1, 2, 1], f"10a: launched replica counts {counts}")
    exits = [e["code"] for e in runner.events if e["event"] == "exit"]
    check(exits == [143, 143, 0], f"10a: exit codes {exits}")
    reports = _reports(reports_dir)
    end = _check_incarnations(reports, launches, "10a")
    check(end == CONTROL_STEPS, f"10a: ended at step {end}")
    check(record.hints is not None, "10a: no hints")
    records = _journal(trace_dir, CONTROL_JOB)
    ms, hints_ok = _route_ms(records)
    check(sorted(hints_ok) == [0, 1, 2],
          f"10a: accepted hint posts per incarnation {hints_ok}")
    # The rescales: spec edit -> allocator publish -> SIGTERM -> exit 143
    # -> the successor's first step.
    signals = [e for e in runner.events if e["event"] == "signal"]
    exit_times = [e["time"] for e in runner.events if e["event"] == "exit"]
    rescales = []
    for i, (edited, bounds) in enumerate(edits):
        publish = next(at for at, key, a in runner.allocator.published
                       if key == CONTROL_JOB and at >= edited)
        successor = reports[i + 1][0]
        # The successor's start from its journal: its ranks' first
        # initialize_job (after the interpreter and imports) and its
        # slowest rank's restore.
        spans = [r for r in records if r["inc"] == i + 1]
        init = min(r["ts"] for r in spans if r["name"] == "bootstrap.init")
        restore = {}
        for r in spans:
            if r["name"] == "ckpt.restore":
                restore[r["pid"]] = restore.get(r["pid"], 0.0) + r["dur"]
        rescales.append({
            "to": counts[i + 1],
            "publish_s": publish - edited,
            "sigterm_s": signals[i]["time"] - edited,
            "exit143_s": exit_times[i] - edited,
            "initialize_s": init - edited,
            "restore_s": max(restore.values(), default=0.0),
            "ready_s": successor["ready_wall"] - edited,
            "first_step_s": successor["first_step_wall"] - edited,
            "stall_s": _stall(reports, i + 1),
        })
        r = rescales[-1]
        print(f"10a rescale {counts[i]} -> {counts[i + 1]} ({bounds}): from the "
              f"spec edit, publish {r['publish_s']:.2f} s, SIGTERM "
              f"{r['sigterm_s']:.2f} s, exit 143 {r['exit143_s']:.2f} s, the "
              f"successor's initialize_job {r['initialize_s']:.2f} s, ready "
              f"(model built, checkpoint restored in {r['restore_s']:.2f} s) "
              f"{r['ready_s']:.2f} s, its first step (calibration included) "
              f"{r['first_step_s']:.2f} s; stall (the incumbent's last step to "
              f"the successor's first) {r['stall_s']:.2f} s")
    _print_cycles(runner.allocator, CONTROL_JOB, start, runner.state)
    cycle_ms = [c["seconds"] * 1e3 for c in runner.allocator.cycles]
    step_ms = {}
    for ranks in reports.values():
        # Each incarnation's first step carries its calibration; the
        # others are keyed by (replicas, atomic batch, accumulation steps).
        for t, (atomic, accum) in list(zip(ranks[0]["step_s"],
                                           ranks[0]["step_configs"]))[1:]:
            key = f"{ranks[0]['replicas']}x({atomic},{accum})"
            step_ms.setdefault(key, []).append(t * 1e3)
    summary = {
        "rescales": rescales,
        "watch": operator,
        "pollux_cycle_ms": {"p50": _percentile(cycle_ms, 50),
                            "max": max(cycle_ms), "cycles": len(cycle_ms)},
        "route_ms": {k: {"p50": _percentile(v, 50), "p99": _percentile(v, 99),
                         "n": len(v)} for k, v in ms.items()},
        "step_ms": {k: {"p50": _percentile(v, 50), "n": len(v)}
                    for k, v in sorted(step_ms.items())},
        "launches": {str(k): [r["launches"] for r in v] for k, v in reports.items()},
        "ends": {str(k): v[0]["end_step"] for k, v in reports.items()},
    }
    print(f"10a: Pollux cycle ms p50 {summary['pollux_cycle_ms']['p50']:.2f} max "
          f"{summary['pollux_cycle_ms']['max']:.2f} over {len(cycle_ms)} cycles; "
          + "; ".join(f"{k} route ms p50 {v['p50']:.2f} p99 {v['p99']:.2f} (n {v['n']})"
                      for k, v in summary["route_ms"].items())
          + "; median step ms by replicas x (atomic batch, accum steps) "
          + ", ".join(f"{k} {v['p50']:.1f} (n {v['n']})"
                      for k, v in summary["step_ms"].items()))
    return summary


# 10c: 10a's job and edits with the warm successor, the peer handoff and
# a journaled cluster state. The warm-up deadline is set explicitly: the
# JAX package's default (20 s) is shorter than the port's successor takes
# to reach its hold on this card (see the printed spawn -> ready).
CONTROL_WARM_JOB = "smoke/warm-lm"
# The incumbent steps on through each warm-up window (at one rank about
# five steps a second), so 10c's budget is larger than 10a's: the job
# must still be training when the second edit lands.
CONTROL_WARM_STEPS = 140
WARM_ENV = {
    "ADAPTDL_WARMUP_ENABLED": "1", "ADAPTDL_HANDOFF": "1",
    "ADAPTDL_WARMUP_DEADLINE_S": "120",
}
# The restart's record fields that must survive it unchanged.
RESTART_FIELDS = (
    "spec", "allocation", "topology", "batch_config", "status", "group",
    "restarts", "committed_allocation", "committed_topology", "alloc_epoch",
    "alloc_state", "candidate_allocation", "candidate_topology",
    "candidate_batch_config", "candidate_epoch", "workers", "lease_ranks",
    "degraded", "failures",
)


def _restart_supervisor(runner, state_dir, wait):
    """Stop the runner's supervisor, allocator and cluster state while the
    job trains, recover a fresh state from the journal and serve it on the
    same port; returns what the restart did."""
    from adaptdl_tpu_torch import env
    from adaptdl_tpu_torch.sched.state import _job_to_dict

    def fields(full):
        return {k: full[k] for k in RESTART_FIELDS}

    before = fields(_job_to_dict(runner.state.get_job(CONTROL_WARM_JOB)))
    restarts = runner.restarts
    hints = dict(runner.state.get_job(CONTROL_WARM_JOB).hints)
    url, seq = runner.supervisor.url, runner.state.last_journal_seq()
    with open(os.path.join(state_dir, "journal.jsonl")) as f:
        replayed = sum(1 for _ in f)
    start = time.monotonic()
    recovered = runner.restart_control_plane()
    restart_s = time.monotonic() - start
    after = fields(recovered[CONTROL_WARM_JOB])
    info = runner.state.recovery_info()
    window = env.sched_reconcile_window()
    # A recovered lease holds a grace deadline of the window; the first
    # heartbeat after the restart renews it for the lease TTL.
    wait(lambda: runner.state.get_job(CONTROL_WARM_JOB).leases.get(0, 0.0)
         - time.monotonic() > window + 1.0, "the lease's reattach", window)
    reattach_s = time.monotonic() - start
    wait(lambda: runner.state.get_job(CONTROL_WARM_JOB).hints != hints,
         "a hint accepted after the restart", 60.0)
    hint_s = time.monotonic() - start
    record = runner.state.get_job(CONTROL_WARM_JOB)
    check(after == before, f"10c: the restart changed the job {before} -> {after}")
    check(runner.restarts == restarts and record.restarts == before["restarts"]
          and record.group == before["group"] and not record.degraded,
          f"10c: the restart moved the job: restarts {runner.restarts} "
          f"(was {restarts}), group {record.group}, degraded {record.degraded}")
    check(runner.supervisor.url == url, "10c: the supervisor moved")
    check(info["recoveries"] == 1 and info["tornRecords"] == 0,
          f"10c: recovery {info}")
    check(reattach_s < window, f"10c: reattach after {reattach_s:.2f} s")
    out = {
        "at": time.time(), "restart_s": restart_s,
        "recovery_s": info["lastRecoveryS"], "replayed_records": replayed,
        "torn_records": info["tornRecords"], "journal_seq": seq,
        "reattach_s": reattach_s, "first_hint_s": hint_s,
    }
    print(f"10c supervisor restart at one rank: down and recovered in "
          f"{restart_s * 1e3:.1f} ms (recovery {info['lastRecoveryS'] * 1e3:.2f} ms, "
          f"{replayed} journal records replayed at seq {seq}, "
          f"{info['tornRecords']} torn); the lease reattached after "
          f"{reattach_s:.2f} s (window {window:.0f} s), the first hint was "
          f"accepted after {hint_s:.2f} s; job, allocation and candidate "
          f"unchanged, restarts {runner.restarts}, group {record.group}",
          flush=True)
    return out


def _median_ms(values):
    return _percentile([v * 1e3 for v in values], 50) if values else float("nan")


def control_warm(root, single):
    """10c: the 10a job with the warm successor and a journaled state."""
    from adaptdl_tpu_torch.sched.local_runner import LocalElasticRunner
    from adaptdl_tpu_torch.sched.validator import validate_job_spec

    here = os.path.dirname(os.path.abspath(__file__))
    reports_dir = os.path.join(root, "reports")
    trace_dir = os.path.join(root, "trace")
    state_dir = os.path.join(root, "sched")
    os.environ.update(WARM_ENV, ADAPTDL_SCHED_STATE_DIR=state_dir)
    runner = LocalElasticRunner(
        os.path.join(here, "adaptdl_tpu_torch", "examples", "transformer_lm.py"),
        num_chips=2, checkpoint_dir=os.path.join(root, "ckpt"),
        job_name=CONTROL_WARM_JOB, max_replicas=1, allocator_interval=2.0,
        extra_env=dict(CONTROL_ENV, ADAPTDL_TRACE_DIR=trace_dir),
        term_grace_period=120.0,
        script_args=["--flash", "--steps", str(CONTROL_WARM_STEPS),
                     "--report-dir", reports_dir],
    )
    edits, errors, degraded, published, restart, operator = [], [], [], [], {}, {}
    start = time.time()
    done = threading.Event()

    def edit(**bounds):
        record = runner.state.get_job(CONTROL_WARM_JOB)
        spec = dict(record.spec, **bounds)
        validate_job_spec(spec)
        runner.state.update(CONTROL_WARM_JOB, spec=spec)
        edits.append((time.time(), bounds))

    def wait(predicate, what, timeout=300.0):
        deadline = time.monotonic() + timeout
        while not predicate():
            if done.is_set() or time.monotonic() > deadline:
                raise RuntimeError(f"10c: gave up waiting for {what}")
            if runner.state.get_job(CONTROL_WARM_JOB).degraded:
                degraded.append(time.time())
            time.sleep(0.1)

    def drive():
        try:
            hints = lambda: runner.state.get_job(CONTROL_WARM_JOB).hints or {}  # noqa: E731
            wait(lambda: hints(), "the first incarnation's hints")
            published.extend(runner.allocator.published)
            restart.update(_restart_supervisor(runner, state_dir, wait))
            edit(min_replicas=2, max_replicas=2)
            wait(lambda: hints().get("maxProfiledReplicas", 0) >= 2,
                 "the two-rank incarnation's hints")
            edit(min_replicas=1, max_replicas=1)
            operator["publish"] = explain_after_publish(
                runner, CONTROL_WARM_JOB, edits[-1][0], "10c", wait)
            operator.update(
                operator_reads(runner, CONTROL_WARM_JOB, root, "10c", wait))
            wait(lambda: runner.state.get_job(CONTROL_WARM_JOB).status
                 in ("Succeeded", "Failed"), "the end")
        except Exception as exc:  # noqa: BLE001 - checked below
            errors.append(exc)

    editor = threading.Thread(target=drive, daemon=True)
    editor.start()
    try:
        code = runner.run()
    finally:
        done.set()
        editor.join(timeout=30)
    published.extend(runner.allocator.published)
    record = runner.state.get_job(CONTROL_WARM_JOB)
    check(not errors, f"10c: {errors}")
    check(code == 0 and record.status == "Succeeded",
          f"10c: runner returned {code}, job {record.status}")
    check(not degraded and not record.degraded,
          "10c: a lease expired (the job went degraded)")
    launches = _check_published(runner.events, published, CONTROL_WARM_JOB, "10c")
    counts = [e["replicas"] for e in launches]
    check(counts == [1, 2, 1], f"10c: launched replica counts {counts}")
    kinds = [e["event"] for e in runner.events]
    check(kinds == ["launch"] + ["warm_spawn", "warm_ready", "signal", "exit",
                                 "launch", "cutover"] * 2 + ["exit"],
          f"10c: events {kinds} (both rescales adopted warm, no discard)")
    exits = [e["code"] for e in runner.events if e["event"] == "exit"]
    check(exits == [143, 143, 0], f"10c: exit codes {exits}")
    reports = _reports(reports_dir)
    end = _check_incarnations(reports, launches, "10c")
    check(end == CONTROL_WARM_STEPS, f"10c: ended at step {end}")
    for restarts in (1, 2):
        check(all(r["hold_verdict"] == "go" for r in reports[restarts]),
              f"10c: incarnation {restarts} was not adopted warm: hold "
              f"verdicts {[r['hold_verdict'] for r in reports[restarts]]}")
    records = _journal(trace_dir, CONTROL_WARM_JOB)
    ms, hints_ok = _route_ms(records)
    check(sorted(hints_ok) == [0, 1, 2],
          f"10c: accepted hint posts per incarnation {hints_ok}")
    after_restart = [
        r for r in records if r["name"] == "rpc.request" and r["inc"] == 0
        and r["attrs"].get("endpoint", "").startswith("hints")
        and r["attrs"].get("status") == 200 and r["ts"] > restart["at"]
    ]
    check(after_restart, "10c: no hint accepted after the supervisor restart")

    def at(kind, i):
        return [e["time"] for e in runner.events if e["event"] == kind][i]

    rescales = []
    for i, (edited, bounds) in enumerate(edits):
        publish = next(t for t, key, a in published
                       if key == CONTROL_WARM_JOB and t >= edited)
        successor, incumbent = reports[i + 1], reports[i][0]
        spans = [r for r in records if r["inc"] == i + 1]
        restore = {}
        for r in spans:
            if r["name"] in ("ckpt.restore", "handoff.fetch"):
                restore[r["pid"]] = restore.get(r["pid"], 0.0) + r["dur"]
        walls = _step_walls(incumbent)
        spawn, signal_at = at("warm_spawn", i), at("signal", i)
        before = [t for w, t in zip(walls[1:], incumbent["step_s"][1:]) if w < spawn]
        inside = [t for w, t in zip(walls, incumbent["step_s"])
                  if spawn <= w <= signal_at]
        rescales.append({
            "to": counts[i + 1],
            "publish_s": publish - edited,
            "warm_spawn_s": spawn - edited,
            "ready_s": at("warm_ready", i) - edited,
            "spawn_to_ready_s": at("warm_ready", i) - spawn,
            "sigterm_s": signal_at - edited,
            "exit143_s": at("exit", i) - edited,
            "go_s": at("cutover", i) - edited,
            "restore_s": max(restore.values(), default=0.0),
            "pulled_bytes": [r["handoff"]["bytes"] for r in successor],
            "reused_bytes": [r["handoff"]["reused"] for r in successor],
            "hold_s": [r["hold_s"] for r in successor],
            "first_step_s": max(r["first_step_wall"] for r in successor) - edited,
            "stall_s": _stall(reports, i + 1),
            "incumbent_step_ms_before": _median_ms(before),
            "incumbent_step_ms_warming": _median_ms(inside),
            "incumbent_steps": [len(before), len(inside)],
        })
        r = rescales[-1]
        print(f"10c rescale {counts[i]} -> {counts[i + 1]} ({bounds}): from the "
              f"spec edit, publish {r['publish_s']:.2f} s, warm spawn "
              f"{r['warm_spawn_s']:.2f} s, ready {r['ready_s']:.2f} s (spawn -> "
              f"ready {r['spawn_to_ready_s']:.2f} s), SIGTERM {r['sigterm_s']:.2f} s, "
              f"exit 143 {r['exit143_s']:.2f} s, go {r['go_s']:.2f} s, the "
              f"successor's restore {r['restore_s']:.2f} s (bytes pulled "
              f"{r['pulled_bytes']}, reused {r['reused_bytes']}; held "
              f"{[round(h, 2) for h in r['hold_s']]} s), its first step "
              f"{r['first_step_s']:.2f} s; stall {r['stall_s']:.2f} s against "
              f"10a's {single['rescales'][i]['stall_s']:.2f} s; the incumbent's "
              f"median step {r['incumbent_step_ms_warming']:.1f} ms while the "
              f"successor warmed against {r['incumbent_step_ms_before']:.1f} ms "
              f"before (steps {r['incumbent_steps']})", flush=True)
    _print_cycles(runner.allocator, CONTROL_WARM_JOB, start, runner.state)
    route = {k: {"p50": _percentile(v, 50), "p99": _percentile(v, 99), "n": len(v)}
             for k, v in ms.items()}
    print("10c with the journal: " + "; ".join(
        f"{k} route ms p50 {v['p50']:.2f} p99 {v['p99']:.2f} (n {v['n']}) against "
        f"10a's p50 {single['route_ms'][k]['p50']:.2f} p99 "
        f"{single['route_ms'][k]['p99']:.2f}" for k, v in route.items()))
    return {
        "rescales": rescales, "restart": restart, "route_ms": route,
        "watch": operator,
        "launches": {str(k): [r["launches"] for r in v] for k, v in reports.items()},
        "ends": {str(k): v[0]["end_step"] for k, v in reports.items()},
    }


def _reap_children(timeout):
    """Reap this process's children (orphaned shard servers come back to
    it, their subreaper) as they exit; those left after ``timeout``."""
    deadline = time.monotonic() + timeout
    while _children() and time.monotonic() < deadline:
        for pid in _children():
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
        time.sleep(0.2)
    return _children()


def _restart_causes(runner, start):
    """Each restart of each job with its cause: the Pollux cycle that
    published the allocation it was signalled for, and what that cycle
    did to every job."""
    cycles = list(runner.allocator.cycles)
    causes = []
    for name, events in runner.events.items():
        for e in events:
            if e["event"] != "signal":
                continue
            i = max(k for k, c in enumerate(cycles)
                    if c["time"] <= e["time"]
                    and c["allocations"].get(name) == e["allocation"])
            moved = {
                job: (cycles[i - 1]["allocations"].get(job, []) if i else [],
                      alloc)
                for job, alloc in cycles[i]["allocations"].items()
                if not i or cycles[i - 1]["allocations"].get(job, []) != alloc
            }
            causes.append({"job": name, "signal_s": e["time"] - start,
                           "cycle_s": cycles[i]["time"] - start,
                           "mode": cycles[i]["mode"], "moved": moved})
            print(f"10b restart of {name} (SIGTERM at t={e['time'] - start:.2f} s): "
                  f"Pollux cycle {cycles[i]['cycle']} ({cycles[i]['mode']}, "
                  f"t={cycles[i]['time'] - start:.2f} s, "
                  f"{cycles[i]['seconds'] * 1e3:.2f} ms) moved "
                  + ", ".join(f"{job} {len(old)} -> {len(new)}"
                              for job, (old, new) in moved.items()))
    return causes


def control_multi(root):
    """10b: co-scheduling that forces a decision. Linear regression holds
    both slots; the LM arrives; Pollux shrinks linear regression to place
    it."""
    from adaptdl_tpu_torch.examples.linear_regression import TRUE_W
    from adaptdl_tpu_torch.sched.allocator import job_info_from_hints
    from adaptdl_tpu_torch.sched.multi_runner import JobSpec, MultiJobRunner
    from adaptdl_tpu_torch.sched.validator import validate_job_spec

    here = os.path.dirname(os.path.abspath(__file__))
    lm, linear = "smoke/co-lm", "smoke/co-linear"
    lm_job = JobSpec(
        lm, os.path.join(here, "adaptdl_tpu_torch", "examples", "transformer_lm.py"),
        os.path.join(root, "ckpt-lm"), min_replicas=1, max_replicas=1,
        extra_env=dict(CONTROL_ENV),
        script_args=["--flash", "--steps", str(CO_LM_STEPS),
                     "--report-dir", os.path.join(root, "rep-lm")])
    linear_job = JobSpec(
        linear, os.path.join(here, "adaptdl_tpu_torch", "examples", "linear_regression.py"),
        os.path.join(root, "ckpt-linear"), min_replicas=2, max_replicas=2,
        extra_env=dict(CONTROL_ENV, ADAPTDL_FIT_INTERVAL="0.5"),
        script_args=["--epochs", "100000", "--steps", str(CO_LINEAR_STEPS),
                     "--report-dir", os.path.join(root, "rep-linear")])
    runner = MultiJobRunner([linear_job], num_chips=2, allocator_interval=1.0)
    both, errors, submitted = [], [], []
    done = threading.Event()
    start = time.time()

    def drive():
        try:
            deadline = time.monotonic() + 120
            while runner.state.get_job(linear).hints is None:
                if done.is_set() or time.monotonic() > deadline:
                    raise RuntimeError("10b: linear regression posted no hints")
                time.sleep(0.05)
            record = runner.state.get_job(linear)
            check(record.status == "Running" and len(record.allocation) == 2,
                  f"10b: linear regression {record.status} on {record.allocation}")
            spec = dict(record.spec, min_replicas=1)
            validate_job_spec(spec)
            # The submit and the edit in one step of the state: no
            # allocator cycle sees one without the other.
            with runner.state._cond:
                runner.submit(lm_job)
                runner.state.update(linear, spec=spec)
            submitted.append(time.time())
            record = runner.state.get_job(linear)
            info = job_info_from_hints(record.hints, record.spec, 0.0)
            print(f"10b: the LM submitted at t={submitted[0] - start:.2f} s; linear "
                  f"regression's speedup at 1 / 2 replicas from its hints "
                  f"{info.speedup_fn(1, 1):.4f} / {info.speedup_fn(1, 2):.4f}")
            while not done.is_set():
                allocs = [runner.state.get_allocation(j) for j in (lm, linear)]
                statuses = [runner.state.get_job(j).status for j in (lm, linear)]
                if statuses == ["Running", "Running"]:
                    both.append([len(a) for a in allocs])
                time.sleep(0.1)
        except Exception as exc:  # noqa: BLE001 - checked below
            errors.append(exc)

    driver = threading.Thread(target=drive, daemon=True)
    driver.start()
    try:
        codes = runner.run()
    finally:
        done.set()
        driver.join(timeout=30)
    check(not errors, f"10b: {errors}")
    check(codes == {lm: 0, linear: 0}, f"10b: exit codes {codes}")
    for job in (lm, linear):
        record = runner.state.get_job(job)
        check(record.status == "Succeeded" and record.hints is not None,
              f"10b: {job} {record.status}, hints {record.hints is not None}")
        _check_published(runner.events[job], runner.allocator.published,
                         job, f"10b {job}")
    causes = _restart_causes(runner, start)
    linear_launches = [e for e in runner.events[linear] if e["event"] == "launch"]
    counts = [e["replicas"] for e in linear_launches]
    exits = [e["code"] for e in runner.events[linear] if e["event"] == "exit"]
    check(counts[:2] == [2, 1] and exits == [143] * (len(counts) - 1) + [0],
          f"10b: linear regression launched at {counts}, exits {exits}")
    # The first restart is Pollux's: the cycle that shrank linear
    # regression is the one that placed the LM.
    first = next(c for c in causes if c["job"] == linear)
    check(first["moved"].get(linear) == (["local"] * 2, ["local"])
          and first["moved"].get(lm) == ([], ["local"]),
          f"10b: linear regression's first restart came from {first}")
    check(both and all(min(c) >= 1 for c in both),
          f"10b: slots while both ran {both[:3]}")
    lm_reports = _reports(os.path.join(root, "rep-lm"))
    _check_incarnations(lm_reports, [e for e in runner.events[lm]
                                     if e["event"] == "launch"], "10b LM")
    linear_reports = _reports(os.path.join(root, "rep-linear"))
    check(sorted(linear_reports) == list(range(len(counts))),
          f"10b: linear regression reports {sorted(linear_reports)}")
    end = 0
    for restarts, ranks in sorted(linear_reports.items()):
        check(len(ranks) == counts[restarts]
              and all(r["start_step"] == end and r["losses_finite"] for r in ranks)
              and len({r["params_sha256"] for r in ranks}) == 1,
              f"10b: linear regression incarnation {restarts} ran {len(ranks)} ranks "
              f"from {[r['start_step'] for r in ranks]}, saved {end}")
        end = ranks[0]["end_step"]
    check(end == CO_LINEAR_STEPS, f"10b: linear ended at {end}")
    last = linear_reports[max(linear_reports)][0]
    w_err = float(max(abs(a - b) for a, b in zip(last["small_params"]["w"], TRUE_W)))
    check(w_err < 0.05, f"10b: linear regression max|w - w*| {w_err}")
    # The forced rescale: the LM's submit -> the publish -> SIGTERM ->
    # exit 143 -> linear regression's first step at one replica.
    signal_at = next(e["time"] for e in runner.events[linear] if e["event"] == "signal")
    exit_at = next(e["time"] for e in runner.events[linear] if e["event"] == "exit")
    shrink = {
        "publish_s": start + first["cycle_s"] - submitted[0],
        "sigterm_s": signal_at - submitted[0],
        "exit143_s": exit_at - submitted[0],
        "linear_first_step_s": linear_reports[1][0]["first_step_wall"] - submitted[0],
        "lm_first_step_s": lm_reports[0][0]["first_step_wall"] - submitted[0],
    }
    step_ms = {f"{counts[k]}x": _percentile([t * 1e3 for t in v[0]["step_s"][1:]], 50)
               for k, v in sorted(linear_reports.items()) if len(v[0]["step_s"]) > 1}
    restarts = {j: runner.restart_counts[j] for j in (lm, linear)}
    print(f"10b: both Succeeded; linear regression launched at {counts}; from the LM's "
          f"submit, publish {shrink['publish_s']:.2f} s, SIGTERM {shrink['sigterm_s']:.2f} s, "
          f"exit 143 {shrink['exit143_s']:.2f} s, linear regression's first step at 1 "
          f"{shrink['linear_first_step_s']:.2f} s, the LM's first step "
          f"{shrink['lm_first_step_s']:.2f} s; slots while both ran {both[0]} "
          f"({len(both)} samples); restarts {restarts}; linear regression median step ms "
          f"{step_ms}, max|w - w*| {w_err:.4f}; LM losses "
          f"{[round(x, 4) for x in lm_reports[max(lm_reports)][0]['losses'][-3:]]}")
    return {"linear_launches": counts, "slots_while_both_ran": both[0],
            "restarts": restarts, "causes": causes, "shrink": shrink,
            "linear_step_ms": step_ms, "w_err": w_err}


# 10d: elastic tuning on the card. Three trials of the committed
# linear-regression trial script; one slot each (three trials on two
# slots would deadlock at the first rung: a trial paused at its rung gate
# keeps its slot, and the third never gets one to reach the rung).
TUNE_LRS = [0.05, 0.02, 1e-6]
TUNE_SLOTS = 3
TUNE_LOSS_BOUND = 0.1  # the best trial's last loss (tests/test_tune.py's bound)
SUBMIT_EPOCHS = 3
SUBMIT_W_TOL = 0.05  # cli submit's linear regression: weights to the true ones


def control_tune(root):
    """10d: TrialScheduler over the port's MultiJobRunner on the card, with
    halving; beside it ``cli submit`` runs linear regression to completion
    at one slot."""
    from adaptdl_tpu_torch import tune
    from adaptdl_tpu_torch.examples.linear_regression import TRUE_W

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(root)
    submit_log = os.path.join(root, "submit.log")
    start = time.time()
    submit = subprocess.Popen(
        [sys.executable, "-m", "adaptdl_tpu_torch.cli", "submit",
         os.path.join(here, "adaptdl_tpu_torch", "examples", "linear_regression.py"),
         "--chips", "1", "--checkpoint-dir", os.path.join(root, "submit"),
         "--name", "smoke/cli-linear", "--log-file", submit_log,
         "--", "--epochs", str(SUBMIT_EPOCHS)],
        cwd=here, env=dict(os.environ, PYTHONPATH=here),
    )
    try:
        sched = tune.TrialScheduler(
            os.path.join(here, "adaptdl_tpu_torch", "examples", "tune_trial.py"),
            {"lr": TUNE_LRS}, num_chips=TUNE_SLOTS, metric="loss", mode="min",
            grace_results=2, reduction_factor=2,
            checkpoint_root=os.path.join(root, "tune"),
            runner_kwargs={"allocator_interval": 2.0, "pop_size": 8,
                           "generations": 4},
            poll_interval=0.25,
        )
        best = sched.run()
        tune_s = time.time() - start
        code = submit.wait(timeout=600)
    finally:
        if submit.poll() is None:
            submit.kill()
            submit.wait()
    submit_s = time.time() - start
    check(sched.stopped_trials, "10d: early stopping never fired")
    by_lr = {t.config["lr"]: key for key, t in sched.trials.items()}
    hopeless = by_lr[1e-6]
    check(hopeless in sched.stopped_trials
          and sched.trials[hopeless].status == "STOPPED",
          f"10d: the hopeless trial {hopeless} ended "
          f"{sched.trials[hopeless].status}; stopped {sched.stopped_trials}")
    runner = sched.runner
    exits = [e["code"] for e in runner.events[hopeless] if e["event"] == "exit"]
    check(runner.exit_codes.get(hopeless) == 143 and exits and exits[-1] == 143,
          f"10d: the hopeless trial exited {exits}")
    ckpt = os.path.join(root, "tune", hopeless.split("/")[1])
    check(any(n.startswith("checkpoint-") for n in os.listdir(ckpt)),
          f"10d: the stopped trial left no checkpoint in {os.listdir(ckpt)}")
    check(best.config["lr"] in TUNE_LRS[:2] and best.status == "DONE"
          and best.last("loss") < TUNE_LOSS_BOUND,
          f"10d: best trial {best.trial_id} lr {best.config['lr']} "
          f"{best.status} loss {best.last('loss')}")
    with open(submit_log) as f:
        log = f.read()
    check(code == 0, f"10d: cli submit exited {code}: {log[-2000:]}")
    found = re.search(r"w: \[([^\]]*)\]", log)
    weights = [float(x) for x in found.group(1).split()] if found else []
    check(len(weights) == 4 and max(abs(a - b) for a, b in zip(weights, TRUE_W))
          < SUBMIT_W_TOL, f"10d: cli submit's weights {weights} against {TRUE_W}")
    trials = {}
    for key, trial in sched.trials.items():
        events = runner.events[key]
        launch = [e["time"] for e in events if e["event"] == "launch"]
        ended = [e["time"] for e in events if e["event"] == "exit"]
        trials[key] = {
            "lr": trial.config["lr"], "status": trial.status,
            "results": len(trial.results), "last_loss": trial.last("loss"),
            "launches": len(launch),
            "exits": [e["code"] for e in events if e["event"] == "exit"],
            "first_launch_s": launch[0] - start if launch else None,
            "run_s": ended[-1] - launch[0] if launch and ended else None,
        }
        t = trials[key]
        print(f"10d {key}: lr {t['lr']} {t['status']} after {t['results']} "
              f"results (last loss {t['last_loss']}), {t['launches']} launch(es), "
              f"exits {t['exits']}, first launch {t['first_launch_s']:.2f} s after "
              f"the start, ran {t['run_s']:.2f} s", flush=True)
    print(f"10d: stopped {sched.stopped_trials} (in order), best {best.trial_id} "
          f"(lr {best.config['lr']}, loss {best.last('loss'):.6f}); the tuner "
          f"{tune_s:.2f} s, cli submit (linear regression, {SUBMIT_EPOCHS} epochs, "
          f"--chips 1) beside it exit {code} after {submit_s:.2f} s, weights "
          f"{weights}", flush=True)
    return {
        "trials": trials, "stopped": list(sched.stopped_trials),
        "best": best.trial_id, "tune_s": tune_s, "submit_s": submit_s,
        "submit_weights": weights,
    }


def phase_control(kernel_rows):
    """Phase 10: the port's control plane on the card."""
    from adaptdl_tpu_torch.ops import _build

    start = time.perf_counter()
    saved = dict(os.environ)
    clean = _clean_environ()
    os.environ.clear()
    os.environ.update(clean)
    root = tempfile.mkdtemp(prefix="adaptdl-torch-smoke-cp-")
    try:
        single = control_single(os.path.join(root, "a"))
        print(f"control 10a: {time.perf_counter() - start:.1f} s")
        # 10d's trials and submit run beside 10b's two jobs: all are small
        # jobs on the card, and the script's time limit leaves no room
        # for 10d after 10c. Their jobs post hints every 2 s, as 10a's.
        os.environ["ADAPTDL_FIT_INTERVAL"] = CONTROL_ENV["ADAPTDL_FIT_INTERVAL"]
        at = time.perf_counter()
        tuned, tune_errors = {}, []

        def run_tune():
            try:
                tuned.update(control_tune(os.path.join(root, "d")))
                tuned["seconds"] = time.perf_counter() - at
            except BaseException as exc:  # noqa: BLE001 - raised below
                tune_errors.append(exc)

        tuner = threading.Thread(target=run_tune, name="smoke-10d")
        tuner.start()
        try:
            multi = control_multi(os.path.join(root, "b"))
        finally:
            tuner.join()
        if tune_errors:
            raise tune_errors[0]
        check(not _children(), f"processes left behind: {_children()}")
        print(f"control 10b beside 10d: {time.perf_counter() - at:.1f} s "
              f"(10d {tuned['seconds']:.1f} s)")
        at = time.perf_counter()
        warm = control_warm(os.path.join(root, "c"), single)
        # The rescales' shard servers exit on their successors' /done.
        left = _reap_children(60.0)
        check(not left, f"processes left behind: {left}")
        print(f"control 10c: {time.perf_counter() - at:.1f} s")
    finally:
        os.environ.clear()
        os.environ.update(saved)
        for pid in _children():
            try:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            except (ProcessLookupError, ChildProcessError):
                pass
        shutil.rmtree(root, ignore_errors=True)
    for row in kernel_rows:
        for key, part in (("control_launches", single),
                          ("control_warm_launches", warm)):
            row[key] = {
                f"incarnation_{k}": [r.get(row["name"], 0) for r in v]
                for k, v in part["launches"].items()
            }
    print(json.dumps({"control_plane": {"single": single, "multi": multi,
                                        "warm": warm, "tune": tuned}}))
    print(f"control: phase {time.perf_counter() - start:.1f} s")
    _build.reset_launches()


# -- phase 11: the ZeRO storage modes ---------------------------------------

# (name, ElasticTrainer keyword arguments, flash attention): the dense
# runs are the references, with the sm90 flash kernel for zero1/zero3 and
# with the plain attention zero3_blocks runs, as the JAX example does.
ZERO_MODES = {
    "dense": ({}, True),
    "zero1": ({"zero1": True}, True),
    "zero3": ({"zero3": True}, True),
    "dense_plain": ({}, False),
    "zero3_blocks": ({"zero3_blocks": "blocks"}, False),
}
ZERO_REFERENCE = {"zero1": "dense", "zero3": "dense", "zero3_blocks": "dense_plain"}
ZERO_SINGLE_STEPS = 4  # 11a, at (32, 0)
ZERO_PAIR_STEPS = 1  # 11b, at (16, 0) on each of two ranks
ZERO_RESCALE_STEPS = 2  # 11c: before the stop and after the restore
ZERO_RESCALES = [
    ("zero1", "trainer"), ("zero1", "sharded"),
    ("zero3_blocks", "trainer"), ("zero3_blocks", "sharded"),
]
# The held tolerance of every mode against its dense reference (same
# weights, same batches): the element arithmetic is the same, so the
# parameters and losses are expected bit-equal; held to a maximum
# parameter difference of ZERO_PARAM_TOL of the largest parameter and a
# loss difference of ZERO_LOSS_RTOL.
ZERO_PARAM_TOL = 1e-6
ZERO_LOSS_RTOL = 1e-6


# The seed-0 weights of each model kind, on the host: the first trainer of
# a kind in a process is built by init_transformer / init_zero3_lm, the
# later ones (the same weights) load them instead of drawing them again.
_ZERO_WEIGHTS: dict = {}


def zero_trainer(mode, device):
    """The full-width LM trainer of ``mode`` (ZERO_MODES), from seed 0."""
    from adaptdl_tpu_torch.examples.transformer_lm import lm_config
    from adaptdl_tpu_torch.models import (
        TransformerLM, Zero3LMParams, init_transformer, init_zero3_lm, lm_loss_fn,
        zero3_lm_loss_fn,
    )
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    kwargs, flash = ZERO_MODES[mode]
    config = lm_config(cpu=False, seq_len=512, flash=flash)
    kind = "blocks" if "zero3_blocks" in kwargs else "dense"
    cached = _ZERO_WEIGHTS.get(kind)
    if cached is None:
        if kind == "blocks":
            loss_fn, model = init_zero3_lm(config, seed=0, device=device)
        else:
            model, loss_fn = init_transformer(config, seed=0, device=device), lm_loss_fn
        _ZERO_WEIGHTS[kind] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    else:
        with torch.device("meta"):
            model = Zero3LMParams(config) if kind == "blocks" else TransformerLM(config)
        model.to_empty(device=device)
        model.load_state_dict(cached)
        loss_fn = zero3_lm_loss_fn(model) if kind == "blocks" else lm_loss_fn
    return ElasticTrainer(
        loss_fn, model, AdamW(model.parameters(), lr=3e-4), init_batch_size=32,
        scaling_rule=AdamScale(), precondition="adam", device=device, **kwargs,
    )


def zero_canonical(trainer, state):
    """The parameters as one flat float32 vector in the zero3 LM's
    canonical order (a dense LM's layers stacked), on the host."""
    from adaptdl_tpu_torch.examples.transformer_lm import lm_config
    from adaptdl_tpu_torch.models import Zero3LMParams
    from adaptdl_tpu_torch.parallel import zero3

    tree = trainer.params_tree(state)
    with torch.device("meta"):
        spec = zero3.block_spec(
            Zero3LMParams(lm_config(cpu=False, seq_len=512, flash=False)), "blocks"
        )
    if set(tree) != set(spec.names):
        tree = zero3.stack_layers(tree, spec)
    return torch.cat([tree[n].detach().reshape(-1).float().cpu() for n in spec.names])


def _bits_checksum(flat):
    return int(flat.contiguous().view(torch.int32).sum(dtype=torch.int64))


def zero_drive(mode, device, replicas, rank, steps, atomic):
    """``steps`` bare train_step runs of ``mode`` at (atomic, 0) on this
    rank's block of the same global batches of 32, the sm90 launch count
    reset just before and read just after; per-rank peak memory reset
    just before the steps. Returns the run's record and canonical
    parameters."""
    from adaptdl_tpu_torch import collective
    from adaptdl_tpu_torch.examples.transformer_lm import synthetic_tokens
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    trainer = zero_trainer(mode, device)
    state = trainer.init_state()
    tokens = synthetic_tokens(32 * steps, 512, 32000)["tokens"]
    local = 32 // replicas
    batches = [
        trainer.to_device({"tokens": tokens[i * 32 + rank * local : i * 32 + (rank + 1) * local]})
        for i in range(steps)
    ]
    step = trainer.train_step(atomic, 0)
    torch.cuda.synchronize(device)
    resident = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launches()
    collective.reset_traffic()
    losses, seconds = [], []
    for batch in batches:
        torch.cuda.synchronize(device)
        start = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - start)
        losses.append(float(m["loss"]))
    launches = {k: _build.LAUNCHES[k] for k in (KERNEL_SM90, KERNEL)}
    traffic = {k: v / steps for k, v in collective.TRAFFIC.items()}
    peak = torch.cuda.max_memory_allocated(device)
    flat = zero_canonical(trainer, state)
    check(all(math.isfinite(x) for x in losses), f"{mode}: losses {losses}")
    record = {
        "mode": mode, "losses": losses, "step_s": seconds,
        "median_step_ms": _median(seconds) * 1e3,
        "launches": launches, "traffic_bytes_per_step": traffic,
        "resident_gib": resident / 2**30,
        "peak_gib": peak / 2**30, "checksum": _bits_checksum(flat),
        "grad_sqr": float(m["grad_sqr"]), "grad_var": float(m["grad_var"]),
    }
    del trainer, state, batches, step, m
    gc_cuda()
    return record, flat


def zero_compare(records, flats):
    """Each mode against its dense reference: the largest parameter
    difference over the largest parameter and the largest relative loss
    difference (0.0 when bit-equal), added to its record."""
    for mode, ref in ZERO_REFERENCE.items():
        if mode not in records:
            continue
        a, b = flats[mode], flats[ref]
        param = float((a - b).abs().max() / b.abs().max())
        loss = max(
            abs(x - y) / abs(y)
            for x, y in zip(records[mode]["losses"], records[ref]["losses"])
        )
        records[mode].update(
            reference=ref, param_diff=param, loss_rdiff=loss,
            bit_equal=bool(torch.equal(a, b)),
        )


def zero_worker(kind, root):
    """Phase 11's processes: ``single`` (11a, one rank, NCCL at world
    size 1), ``pair`` (11b, a rank of two over gloo, then 11c's two-rank
    stop, which exits 143) and ``successor`` (11c's one rank)."""
    import socket

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import collective, env

    torch.backends.cuda.matmul.allow_tf32 = False
    if kind == "single":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        device = torch.device("cuda", 0)
        backend = collective.initialize(
            "127.0.0.1", port, rank=0, world_size=1, device=device,
            local_world_size=1,
        )
        check(backend == "nccl", f"11a backend {backend}")
        records, flats = {}, {}
        try:
            for mode in ZERO_MODES:
                records[mode], flats[mode] = zero_drive(
                    mode, device, 1, 0, ZERO_SINGLE_STEPS, 32
                )
        finally:
            collective.teardown()
        zero_compare(records, flats)
        with open(os.path.join(root, "single.json"), "w") as f:
            json.dump({"backend": backend, "records": records}, f)
        return
    device = adaptdl_tpu_torch.initialize_job(device="cuda")
    rank, replicas = env.process_rank(), env.num_replicas()
    if kind == "pair":
        import torch.distributed as dist

        records, flats = {}, {}
        for mode in ZERO_MODES:
            records[mode], flats[mode] = zero_drive(
                mode, device, replicas, rank, ZERO_PAIR_STEPS, 32 // replicas
            )
        zero_compare(records, flats)
        with open(os.path.join(root, f"pair-rank{rank}.json"), "w") as f:
            json.dump({"backend": dist.get_backend(), "records": records}, f)
        del flats
        gc_cuda()
        # 11c's two-rank half runs in the same launch and ends it (exit 143).
        kind = "stop"
    zero_rescale(kind, root, device, rank, replicas)


def zero_rescale(kind, root, device, rank, replicas):
    """11c: ``stop`` trains each scenario ZERO_RESCALE_STEPS steps at two
    ranks, saves it (blocking) and records the canonical parameters, then
    exits 143; ``successor`` restores each at one rank, holds it to the
    record and trains ZERO_RESCALE_STEPS more."""
    from adaptdl_tpu_torch import checkpoint
    from adaptdl_tpu_torch.examples.transformer_lm import synthetic_tokens
    from adaptdl_tpu_torch.sharded_checkpoint import ShardedTrainerCheckpoint

    tokens = synthetic_tokens(32 * ZERO_RESCALE_STEPS, 512, 32000)["tokens"]
    local = 32 // replicas
    report = {}
    for mode, kind_ckpt in ZERO_RESCALES:
        tag = f"{mode}-{kind_ckpt}"
        os.environ["ADAPTDL_CHECKPOINT_PATH"] = os.path.join(root, tag)
        checkpoint._reset_registry()
        trainer = zero_trainer(mode, device)
        holder = {"state": trainer.init_state()}
        args = ("zero-lm", trainer, lambda: holder["state"],
                lambda s: holder.__setitem__("state", s))
        ckpt = (ShardedTrainerCheckpoint(*args) if kind_ckpt == "sharded"
                else trainer.make_checkpoint_state(args[2], args[3], name=args[0]))
        start = time.perf_counter()
        restored = checkpoint.load_state(ckpt)
        restore_s = time.perf_counter() - start
        check(restored == (kind == "successor"), f"11c {tag}: restored={restored}")
        entry = {"restore_s": restore_s, "resumed_at": holder["state"].host_step}
        if kind == "successor":
            with open(os.path.join(root, "stop.json")) as f:
                saved = json.load(f)[tag]
            flat = zero_canonical(trainer, holder["state"])
            check(
                holder["state"].host_step == saved["step"]
                and _bits_checksum(flat) == saved["checksum"],
                f"11c {tag}: resumed at step {holder['state'].host_step} "
                f"(saved {saved['step']}), parameters "
                f"{'equal' if _bits_checksum(flat) == saved['checksum'] else 'differ'}",
            )
        step = trainer.train_step(local, 0)
        losses = []
        for i in range(ZERO_RESCALE_STEPS):
            batch = {"tokens": tokens[i * 32 + rank * local : i * 32 + (rank + 1) * local]}
            holder["state"], m = step(holder["state"], trainer.to_device(batch))
            losses.append(float(m["loss"]))
        check(all(math.isfinite(x) for x in losses), f"11c {tag}: losses {losses}")
        entry["losses"] = losses
        if kind == "stop":
            start = time.perf_counter()
            checkpoint.save_all_states()
            entry["save_s"] = time.perf_counter() - start
            entry["step"] = holder["state"].host_step
            entry["checksum"] = _bits_checksum(zero_canonical(trainer, holder["state"]))
        report[tag] = entry
        ckpt.unregister()
        del trainer, holder, ckpt, step
        gc_cuda()
    if rank == 0:
        with open(os.path.join(root, f"{kind}.json"), "w") as f:
            json.dump(report, f)
    if kind == "stop":
        raise SystemExit(143)


def phase_zero(kernel_rows):
    """Phase 11: the ZeRO storage modes on the card."""
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="adaptdl-torch-smoke-zero-")
    base = {k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")}

    def spawn(kind, replicas, restarts=0, launcher=True):
        run_env = dict(
            base, ADAPTDL_NUM_REPLICAS=str(replicas),
            ADAPTDL_NUM_RESTARTS=str(restarts),
            ADAPTDL_SHARE_PATH=os.environ["ADAPTDL_SHARE_PATH"],
        )
        cmd = [os.path.join(here, "chip_smoke.py"), "--zero-worker", kind, root]
        if launcher:
            cmd = ["-m", "adaptdl_tpu_torch.launch"] + cmd
        return subprocess.Popen(
            [sys.executable, *cmd], cwd=here, env=run_env, start_new_session=True
        )

    def finish(proc, t0, what):
        try:
            code = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            _kill_groups([proc])
            check(False, f"{what} still running after 900 s")
        return code, time.perf_counter() - t0

    def load(tag):
        with open(os.path.join(root, f"{tag}.json")) as f:
            return json.load(f)

    per_pass = 12 * 2  # the sm90 kernel: forward + remat recompute per block
    pair_proc = None
    try:
        # 11a's one rank runs beside 11b's two: neither reads the other's
        # results (each holds its modes to its own dense run).
        t0 = time.perf_counter()
        single_proc, pair_proc = spawn("single", 1, launcher=False), spawn("pair", 2)
        code, wall = finish(single_proc, t0, "11a")
        check(code == 0, f"11a exited {code}")
        single = load("single")["records"]
        for mode, rec in single.items():
            flash = ZERO_MODES[mode][1]
            want = per_pass * ZERO_SINGLE_STEPS if flash else 0
            check(
                rec["launches"][KERNEL_SM90] == want and rec["launches"][KERNEL] == 0,
                f"11a {mode}: launches {rec['launches']}, expected {want} sm90",
            )
        for mode in ZERO_REFERENCE:
            rec = single[mode]
            check(
                rec["param_diff"] <= ZERO_PARAM_TOL and rec["loss_rdiff"] <= ZERO_LOSS_RTOL,
                f"11a {mode} against {rec['reference']}: parameters "
                f"{rec['param_diff']:.3g}, losses {rec['loss_rdiff']:.3g}",
            )
        print("zero 11a (one rank, NCCL at world size 1, (32, 0), "
              f"{ZERO_SINGLE_STEPS} steps each, {wall:.1f} s, beside 11b):")
        for mode, rec in single.items():
            against = (
                f"; against {rec['reference']}: parameters {rec['param_diff']:.3g} "
                f"of the largest, losses {rec['loss_rdiff']:.3g}"
                f"{' (bit-equal)' if rec['bit_equal'] else ''}"
                if "reference" in rec else ""
            )
            print(
                f"  {mode}: losses {rec['losses']}, median step "
                f"{rec['median_step_ms']:.1f} ms, resident "
                f"{rec['resident_gib']:.2f} GiB, peak {rec['peak_gib']:.2f} GiB, "
                f"sm90 launches {rec['launches'][KERNEL_SM90]}{against}"
            )

        code, wall = finish(pair_proc, t0, "11b")
        # The launch goes on to 11c's two-rank stop, which exits 143.
        check(code == 143, f"11b and 11c's stop exited {code}, expected 143")
        pair = [load(f"pair-rank{r}") for r in (0, 1)]
        check([p["backend"] for p in pair] == ["gloo", "gloo"], "11b backends")
        print(f"zero 11b (two ranks on the one card over gloo, (16, 0) each, "
              f"{ZERO_PAIR_STEPS} steps per mode; correctness and per-rank "
              f"memory, not a scaling figure; with 11c's stop {wall:.1f} s):")
        for mode in ZERO_MODES:
            recs = [p["records"][mode] for p in pair]
            check(
                recs[0]["checksum"] == recs[1]["checksum"]
                and recs[0]["losses"] == recs[1]["losses"],
                f"11b {mode}: the two ranks' parameters differ",
            )
            flash = ZERO_MODES[mode][1]
            want = per_pass * ZERO_PAIR_STEPS if flash else 0
            check(
                all(r["launches"][KERNEL_SM90] == want and r["launches"][KERNEL] == 0
                    for r in recs),
                f"11b {mode}: launches {[r['launches'] for r in recs]}",
            )
            if mode in ZERO_REFERENCE:
                check(
                    recs[0]["param_diff"] <= ZERO_PARAM_TOL
                    and recs[0]["loss_rdiff"] <= ZERO_LOSS_RTOL,
                    f"11b {mode} against {recs[0]['reference']}: parameters "
                    f"{recs[0]['param_diff']:.3g}, losses {recs[0]['loss_rdiff']:.3g}",
                )
            against = (
                f"; against {recs[0]['reference']}: parameters "
                f"{recs[0]['param_diff']:.3g}, losses {recs[0]['loss_rdiff']:.3g}"
                f"{' (bit-equal)' if recs[0]['bit_equal'] else ''}"
                if mode in ZERO_REFERENCE else ""
            )
            traffic = ", ".join(
                f"{k} {v / 1e6:.1f}"
                for k, v in recs[0]["traffic_bytes_per_step"].items()
            )
            print(
                f"  {mode}: ranks bit-equal; collectives per step (MB) {traffic}; "
                f"losses {recs[0]['losses']}; per-rank "
                f"resident {recs[0]['resident_gib']:.2f} / {recs[1]['resident_gib']:.2f} "
                f"GiB, peak {recs[0]['peak_gib']:.2f} / {recs[1]['peak_gib']:.2f} GiB; "
                f"median step {recs[0]['median_step_ms']:.1f} / "
                f"{recs[1]['median_step_ms']:.1f} ms; sm90 launches "
                f"{[r['launches'][KERNEL_SM90] for r in recs]}{against}"
            )

        code, wall_succ = finish(spawn("successor", 1, restarts=1),
                                 time.perf_counter(), "11c")
        check(code == 0, f"11c: the one-rank successor exited {code}")
        stop, succ = load("stop"), load("successor")
        print(f"zero 11c (2 ranks -> exit 143 -> 1 rank; successor "
              f"{wall_succ:.1f} s):")
        for tag in stop:
            print(
                f"  {tag}: saved at step {stop[tag]['step']} in "
                f"{stop[tag]['save_s']:.2f} s; restored at step "
                f"{succ[tag]['resumed_at']} in {succ[tag]['restore_s']:.2f} s, "
                f"parameters equal to the saved ones; losses after "
                f"{succ[tag]['losses']}"
            )
        for row in kernel_rows:
            name = row["name"]
            row["zero_launches"] = {
                "single": {m: r["launches"][name] for m, r in single.items()},
                "pair": {m: [p["records"][m]["launches"][name] for p in pair]
                         for m in ZERO_MODES},
            }
        print(json.dumps({"zero": {
            "single": single,
            "pair": [p["records"] for p in pair],
            "rescale": {"stop": stop, "successor": succ},
        }}))
    finally:
        if pair_proc is not None and pair_proc.poll() is None:
            _kill_groups([pair_proc])
        shutil.rmtree(root, ignore_errors=True)
    print(f"zero: phase {time.perf_counter() - start:.1f} s")


SEQ_MODES = ("ulysses", "ring")  # ulysses runs the flash forward inside
SEQ_STEPS = 1  # 12a, each mode, at (8, 0)
SEQ_ATOMIC = 8
SEQ_LONG = 4096  # 12b's long sequence, at atomic 2
SEQ_CKPT_STEPS = 2  # 12c: the one-rank steps before its save
# 12a's bounds against the one-rank run. Same weights and batches; the
# two runs differ by bf16 rounding (the projections over half the
# positions, the gradients summed over two halves) and by f32 summation
# order. The loss is a mean over 4096 positions: a relative difference
# of 2^-8 (one bf16 ulp) would be an error no rounding explains. Adam
# moves a parameter by about lr whatever its gradient's size, so where a
# gradient is at rounding level the two runs may step it either way:
# the parameters are held in L2, the difference against the one-rank
# run's own update.
SEQ_LOSS_RTOL = 2.0**-8
SEQ_PARAM_RL2 = 0.1


def seq_trainer(mode, device, sp, seq_len):
    """The full-width LM trainer of 12 in ``mode`` at ``sp`` seq shards
    (sp 1: the one-rank counterpart, flash attention for ulysses, plain
    attention for ring), from the seed-0 weights."""
    from adaptdl_tpu_torch.examples.transformer_lm import lm_config
    from adaptdl_tpu_torch.models import TransformerLM, init_transformer, lm_pair_loss_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    config = lm_config(
        cpu=False, seq_len=seq_len, flash=mode == "ulysses", seq_shards=sp,
        seq_mode=mode,
    )
    cached = _ZERO_WEIGHTS.get("dense")
    if cached is None:
        model = init_transformer(config, seed=0, device=device)
        _ZERO_WEIGHTS["dense"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    else:
        with torch.device("meta"):
            model = TransformerLM(config)
        model.to_empty(device=device)
        model.load_state_dict(cached)
    return ElasticTrainer(
        lm_pair_loss_fn, model, AdamW(model.parameters(), lr=3e-4), init_batch_size=32,
        scaling_rule=AdamScale(), precondition="adam", device=device,
    )


def seq_batches(steps, seq_len, rows):
    from adaptdl_tpu_torch.examples.transformer_lm import synthetic_tokens

    tokens = synthetic_tokens(rows * steps, seq_len, 32000)["tokens"]
    return [
        {"inputs": tokens[i * rows : (i + 1) * rows, :-1].copy(),
         "targets": tokens[i * rows : (i + 1) * rows, 1:].copy()}
        for i in range(steps)
    ]


def _flat_params(model):
    return torch.cat([p.detach().reshape(-1).float().cpu() for p in model.parameters()])


def seq_drive(mode, device, sp, seq_len, atomic, steps):
    """``steps`` bare train_step runs of ``mode`` at (atomic, 0) on the
    same global batches of ``atomic`` rows (each rank's seq block under
    sp 2); returns the record and the flat parameters before and after."""
    from adaptdl_tpu_torch import collective
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    trainer = seq_trainer(mode, device, sp, seq_len)
    state = trainer.init_state()
    before = _flat_params(trainer.model)
    batches = [trainer.to_device(b) for b in seq_batches(steps, seq_len, atomic)]
    step = trainer.train_step(atomic, 0)
    gc_cuda()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launches()
    collective.reset_traffic()
    losses, seconds = [], []
    for batch in batches:
        torch.cuda.synchronize(device)
        start = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - start)
        losses.append(float(m["loss"]))
    launches = {k: _build.LAUNCHES[k] for k in (KERNEL_SM90, KERNEL)}
    traffic = {k: v / steps for k, v in collective.TRAFFIC.items()}
    peak = torch.cuda.max_memory_allocated(device)
    after = _flat_params(trainer.model)
    check(all(math.isfinite(x) for x in losses), f"12 {mode} sp {sp}: losses {losses}")
    record = {
        "mode": mode, "sp": sp, "seq_len": seq_len, "atomic": atomic,
        "mesh": dict(trainer.mesh.shape), "losses": losses, "step_s": seconds,
        "median_step_ms": _median(seconds) * 1e3, "launches": launches,
        "traffic_bytes_per_step": traffic, "peak_gib": peak / 2**30,
        "checksum": _bits_checksum(after),
        "grad_sqr": float(m["grad_sqr"]), "grad_var": float(m["grad_var"]),
    }
    del trainer, state, batches, step, m
    gc_cuda()
    return record, before, after


def seq_checkpoint(root, device, sp, steps, expect=None):
    """12c: restore the ulysses trainer from ``root/ckpt`` (the step and
    parameter checksum in ``expect``; nothing when None), take ``steps``
    steps, save. Returns the resumed and saved step and checksum."""
    from adaptdl_tpu_torch import checkpoint

    os.environ["ADAPTDL_CHECKPOINT_PATH"] = os.path.join(root, "ckpt")
    checkpoint._reset_registry()
    trainer = seq_trainer("ulysses", device, sp, 512)
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s), name="seq-lm"
    )
    start = time.perf_counter()
    restored = checkpoint.load_state(ckpt)
    entry = {"restore_s": time.perf_counter() - start, "restored": restored,
             "resumed_at": holder["state"].host_step,
             "resumed_checksum": _bits_checksum(_flat_params(trainer.model))}
    if expect is None:
        check(not restored, "12c: the first incarnation found a checkpoint")
    else:
        check(
            restored and entry["resumed_at"] == expect["step"]
            and entry["resumed_checksum"] == expect["checksum"],
            f"12c sp {sp}: resumed at step {entry['resumed_at']} (saved "
            f"{expect['step']}), parameters "
            f"{'equal' if entry['resumed_checksum'] == expect['checksum'] else 'differ'}",
        )
    batches = seq_batches(steps, 512, SEQ_ATOMIC)
    step = trainer.train_step(SEQ_ATOMIC, 0)
    for batch in batches:
        holder["state"], _ = step(holder["state"], trainer.to_device(batch))
    if steps:
        start = time.perf_counter()
        checkpoint.save_all_states()
        entry["save_s"] = time.perf_counter() - start
    entry["step"] = holder["state"].host_step
    entry["checksum"] = _bits_checksum(_flat_params(trainer.model))
    ckpt.unregister()
    del trainer, holder, ckpt, step
    gc_cuda()
    return entry


def _publish_json(path, obj):
    """Write ``obj`` as JSON to ``path`` so that a process waiting for the
    file (:func:`_wait_file`) never reads it half written."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _publish_tensors(obj, path):
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _wait_file(path, what, timeout=600.0):
    """Block until a concurrently running process of the same phase has
    published ``path``; fail after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        check(time.monotonic() < deadline, f"{what}: {path} did not appear in {timeout:.0f} s")
        time.sleep(0.2)
    return path


def seq_worker(kind, root):
    """Phase 12's processes, run side by side: ``single`` (one rank:
    12a's and 12b's one-rank runs, 12c's first save, then, once the pair
    has saved, 12c's one-rank restore) and ``pair`` (a rank of two over
    gloo at dp 1 x sp 2: 12a, 12b, 12c's middle). Each waits for the
    files the other publishes."""
    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import env

    torch.backends.cuda.matmul.allow_tf32 = False
    device = adaptdl_tpu_torch.initialize_job(device="cuda")
    rank = env.process_rank()
    sp = 1
    if kind == "pair":
        import torch.distributed as dist

        sp = env.seq_shards()
        check(dist.get_backend() == "gloo", f"12 pair backend {dist.get_backend()}")
        # The example's rewrite: chips at launch -> data-parallel replicas.
        os.environ["ADAPTDL_NUM_REPLICAS"] = str(env.data_parallel_replicas())
    records = {}
    seconds = {"12a": 0.0, "12b": 0.0}
    for mode in SEQ_MODES:
        t0 = time.perf_counter()
        rec, before, after = seq_drive(mode, device, sp, 512, SEQ_ATOMIC, SEQ_STEPS)
        flat_path = os.path.join(root, f"single-{mode}.pt")
        if kind == "single":
            _publish_tensors({"before": before, "after": after}, flat_path)
        else:
            one = torch.load(_wait_file(flat_path, f"12a {mode}"))
            check(torch.equal(one["before"], before), f"12a {mode}: initial weights differ")
            update = (one["after"] - one["before"]).norm().item()
            rec["param_rl2"] = (after - one["after"]).norm().item() / update
            rec["param_max_abs"] = (after - one["after"]).abs().max().item()
        records[mode] = rec
        t1 = time.perf_counter()
        long, _, _ = seq_drive(mode, device, sp, SEQ_LONG, 2, 1)
        records[f"{mode}_{SEQ_LONG}"] = long
        seconds["12a"] += t1 - t0
        seconds["12b"] += time.perf_counter() - t1
    t0 = time.perf_counter()
    if kind == "single":
        records["ckpt"] = seq_checkpoint(root, device, 1, SEQ_CKPT_STEPS)
        _publish_json(os.path.join(root, "single-ckpt.json"), records["ckpt"])
    else:
        with open(_wait_file(os.path.join(root, "single-ckpt.json"), "12c")) as f:
            saved = json.load(f)
        records["ckpt"] = seq_checkpoint(root, device, sp, 1, saved)
    seconds["12c"] = time.perf_counter() - t0
    records["seconds"] = seconds
    if kind == "pair" and rank == 0:
        _publish_json(os.path.join(root, "pair-ckpt.json"), records["ckpt"])
    if kind == "single":
        with open(_wait_file(os.path.join(root, "pair-ckpt.json"), "12c")) as f:
            expect = json.load(f)
        records["back"] = seq_checkpoint(root, device, 1, 0, expect)
    name = "single" if kind == "single" else f"pair-rank{rank}"
    _publish_json(os.path.join(root, f"{name}.json"), records)


def _kill_groups(procs):
    """Kill each process's whole group (a launcher and its ranks)."""
    for proc in procs:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def _run_side_by_side(phase, procs, timeout=900.0):
    """Wait for a phase's worker processes, started together, each the
    leader of its own process group; each must exit 0 (a failure kills
    the others' groups). Returns each one's wall s."""
    start, walls = time.perf_counter(), {}
    deadline = time.monotonic() + timeout
    pending = dict(procs)
    while pending:
        for name, proc in list(pending.items()):
            code = proc.poll()
            if code is None:
                continue
            del pending[name]
            walls[name] = time.perf_counter() - start
            if code != 0:
                _kill_groups(pending.values())
                check(False, f"{phase} {name} exited {code}")
        if pending and time.monotonic() > deadline:
            _kill_groups(pending.values())
            check(False, f"{phase}: {sorted(pending)} still running after {timeout:.0f} s")
        time.sleep(0.2)
    return walls


def phase_seq(kernel_rows, after_timing=None):
    """Phase 12: the sequence axis on the card. ``after_timing`` is called
    once the in-process kernel timing is done (smoke() starts phase 11
    beside the rest of it there)."""
    import torch.nn.functional as F

    from adaptdl_tpu_torch.ops.flash_attention import (
        KERNEL, KERNEL_SM90, _launch, flash_attention_reference,
    )

    start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="adaptdl-torch-smoke-seq-")
    base = _clean_environ()

    def spawn(kind, replicas, restarts, launcher):
        run_env = dict(
            base, ADAPTDL_NUM_REPLICAS=str(replicas),
            ADAPTDL_SEQ_SHARDS=str(replicas), ADAPTDL_NUM_RESTARTS=str(restarts),
        )
        cmd = [os.path.join(here, "chip_smoke.py"), "--seq-worker", kind, root]
        if launcher:
            cmd = ["-m", "adaptdl_tpu_torch.launch"] + cmd
        return subprocess.Popen(
            [sys.executable, *cmd], cwd=here, env=run_env, start_new_session=True
        )

    def load(tag):
        with open(os.path.join(root, f"{tag}.json")) as f:
            return json.load(f)

    per_pass = 12 * 2  # the sm90 kernel: forward + remat recompute per block
    try:
        # The sm90 kernel at the shape ulysses gives it: 8 rows x 6 heads
        # of the gathered 512 positions.
        gen = torch.Generator(device="cuda").manual_seed(12)
        shape = (SEQ_ATOMIC * 6, 512, 64)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        bh, seq, d = shape
        flops = 4 * d * bh * seq * (seq + 1) / 2
        nbytes = 4 * bh * seq * d * 2 + bh * seq * 4
        by_flops = flops / PEAK_BF16_FLOPS * 1e3
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        a, b, c = (t.reshape(SEQ_ATOMIC, 6, seq, d) for t in (q, k, v))
        gathered = {
            "shape": list(shape),
            "ms": cuda_ms(lambda: _launch(KERNEL_SM90, q, k, v, True, None), 50),
            "plain_ms": cuda_ms(lambda: flash_attention_reference(q, k, v, True), 5),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(a, b, c, is_causal=True), 50
            ),
            "bound_ms": max(by_flops, by_bytes),
            "bound_by": "operations" if by_flops > by_bytes else "bytes",
        }
        out, lse = _launch(KERNEL_SM90, q, k, v, True, None)
        ref, ref_lse = flash_attention_reference(q, k, v, True)
        ratio = ((out.float() - ref.float()).abs()
                 / sm90_bound(q, k, v, True, ref, ref_lse)).max().item()
        check(ratio <= 1, f"12: sm90 at {shape} exceeds its bound ({ratio:.3g})")
        gathered["max_err_over_bound"] = ratio
        print(f"seq 12a: {KERNEL_SM90} at the gathered shape {shape} (causal): {gathered}")
        del q, k, v, a, b, c, out, lse, ref, ref_lse
        gc_cuda()
        if after_timing is not None:
            after_timing()

        walls = _run_side_by_side(
            "12", {"single": spawn("single", 1, 0, launcher=False),
                   "pair": spawn("pair", 2, 1, launcher=True)},
        )
        single = load("single")
        pair = [load(f"pair-rank{r}") for r in (0, 1)]
        back = single["back"]
        print(f"seq 12 (one rank {walls['single']:.1f} s beside two ranks over gloo on "
              f"the one card, dp 1 x sp 2, {walls['pair']:.1f} s; correctness and "
              "per-rank memory, not the seq axis's speed; seconds of 12a / 12b / 12c "
              f"inside them: one rank {single['seconds']}, two ranks "
              f"{pair[0]['seconds']}, the last restore {back['restore_s']:.2f}):")
        for mode in SEQ_MODES:
            recs = [p[mode] for p in pair]
            one = single[mode]
            check(
                recs[0]["checksum"] == recs[1]["checksum"]
                and recs[0]["losses"] == recs[1]["losses"],
                f"12a {mode}: the two ranks' parameters differ",
            )
            check(recs[0]["mesh"] == {"data": 1, "seq": 2}, f"12a mesh {recs[0]['mesh']}")
            want = per_pass * SEQ_STEPS if mode == "ulysses" else 0
            check(
                all(r["launches"][KERNEL_SM90] == want and r["launches"][KERNEL] == 0
                    for r in recs),
                f"12a {mode}: launches {[r['launches'] for r in recs]}, expected "
                f"{want} sm90 per rank",
            )
            want_one = per_pass * SEQ_STEPS if mode == "ulysses" else 0
            check(one["launches"][KERNEL_SM90] == want_one,
                  f"12a one-rank {mode}: launches {one['launches']}")
            loss_rdiff = max(abs(x - y) / abs(y) for x, y in zip(recs[0]["losses"], one["losses"]))
            recs[0]["loss_rdiff"] = loss_rdiff
            check(
                loss_rdiff <= SEQ_LOSS_RTOL and recs[0]["param_rl2"] <= SEQ_PARAM_RL2,
                f"12a {mode} against one rank: losses {loss_rdiff:.3g} (bound "
                f"{SEQ_LOSS_RTOL:.3g}), parameters {recs[0]['param_rl2']:.3g} of the "
                f"update (bound {SEQ_PARAM_RL2})",
            )
            traffic = ", ".join(
                f"{k} {v / 1e6:.2f}" for k, v in recs[0]["traffic_bytes_per_step"].items() if v
            )
            print(
                f"  {mode}: ranks bit-equal; losses {recs[0]['losses']} (one rank "
                f"{one['losses']}, max rel diff {loss_rdiff:.3g}); parameters against "
                f"one rank: L2 {recs[0]['param_rl2']:.3g} of its update, max abs "
                f"{recs[0]['param_max_abs']:.3g}; sm90 launches "
                f"{[r['launches'][KERNEL_SM90] for r in recs]}; collectives per step "
                f"(MB) {traffic}; median step {recs[0]['median_step_ms']:.1f} / "
                f"{recs[1]['median_step_ms']:.1f} ms (one rank "
                f"{one['median_step_ms']:.1f} ms)"
            )
            for seq_len, tag in ((512, mode), (SEQ_LONG, f"{mode}_{SEQ_LONG}")):
                print(
                    f"  {mode} seq {seq_len} (atomic {single[tag]['atomic']}): per-rank "
                    f"peak {pair[0][tag]['peak_gib']:.2f} / {pair[1][tag]['peak_gib']:.2f} "
                    f"GiB at sp 2, {single[tag]['peak_gib']:.2f} GiB at one rank"
                )
        ckpt = [single["ckpt"], pair[0]["ckpt"], back]
        check(back["resumed_at"] == pair[0]["ckpt"]["step"] == SEQ_CKPT_STEPS + 1,
              f"12c: steps {[c.get('step') for c in ckpt]}")
        print(
            f"seq 12c: sp 1 saved at step {ckpt[0]['step']} ({ckpt[0]['save_s']:.2f} s); "
            f"sp 2 resumed at step {ckpt[1]['resumed_at']} with its parameters "
            f"({ckpt[1]['restore_s']:.2f} s), saved at step {ckpt[1]['step']}; sp 1 "
            f"resumed at step {back['resumed_at']} with those ({back['restore_s']:.2f} s)"
        )
        for row in kernel_rows:
            name = row["name"]
            row["seq_launches"] = {
                mode: [p[mode]["launches"][name] for p in pair] for mode in SEQ_MODES
            }
            if name == KERNEL_SM90:
                row["seq_gathered"] = gathered
        print(json.dumps({"seq": {"single": single, "pair": pair, "back": back,
                                  "gathered": gathered}}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"seq: phase {time.perf_counter() - start:.1f} s")


AXES_STEPS = 2  # 13a-13c, each run at (AXES_ATOMIC, 0)
AXES_ATOMIC = 8
AXES_ZERO_MODES = ("zero1", "zero3", "zero3_blocks")
# 13's bounds against the one-rank run (same weights, same batches): the
# runs differ by bf16 rounding (the row-parallel products summed over two
# partial products, the experts over another grouping of their rows)
# and f32 summation order; parameters in L2 against the one-rank
# update, as 12a holds them (SEQ_PARAM_RL2).
AXES_LOSS_RTOL = 1e-3
AXES_PARAM_RL2 = 0.1


def axes_trainer(kind, device, mesh, zero=None):
    """A full-width LM trainer of 13 on ``mesh`` (current): ``dense`` the
    flash LM (13a, cut to this rank's model shards), ``moe`` the flash MoE
    LM (13b: at one rank dense_switch_moe over 2 slices, at ep 2 this
    rank's experts), ``zero`` the LM with ring attention over the mesh's
    seq axis under ``zero`` (13c; zero3_blocks: the zero3 LM). Weights
    from seed 0, drawn once per process and kind."""
    import dataclasses as dc

    from adaptdl_tpu_torch.examples.transformer_lm import lm_config
    from adaptdl_tpu_torch.models import (
        TransformerLM, Zero3LMParams, init_transformer, lm_pair_loss_fn, zero3_lm_loss_fn,
    )
    from adaptdl_tpu_torch.models.transformer import shard_for_mesh
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    sp, tp, ep = (mesh.axis_size(a) for a in ("seq", "model", "expert"))
    config = lm_config(
        cpu=False, seq_len=512, flash=kind != "zero",
        moe_experts=8 if kind == "moe" else 0, moe_top_k=2, seq_shards=sp,
        seq_mode="ring", tp_shards=tp, expert_shards=ep,
    )
    if kind == "moe" and ep == 1:
        config = dc.replace(config, moe_dense_slices=2)
    weights = "moe" if kind == "moe" else "dense"
    full = _ZERO_WEIGHTS.get(weights)
    if full is None:
        drawn = init_transformer(
            dc.replace(config, model_axis=None, moe_axis=None), seed=0, device="cpu"
        )
        full = _ZERO_WEIGHTS[weights] = {k: v.detach().clone() for k, v in drawn.state_dict().items()}
        del drawn
    kwargs = {}
    if zero == "zero3_blocks":
        with torch.device("meta"):
            model = Zero3LMParams(config)
        model.to_empty(device=device)
        with torch.device("meta"):
            dense = TransformerLM(dc.replace(config, seq_axis=None))
        dense.to_empty(device="cpu")
        dense.load_state_dict(full)
        model.load_state_dict(Zero3LMParams.from_transformer(dense).state_dict())
        loss_fn = zero3_lm_loss_fn(model)
        kwargs["zero3_blocks"] = "blocks"
    else:
        with torch.device("meta"):
            model = TransformerLM(config)
        model.to_empty(device="cpu")
        model.load_state_dict(full)
        model = shard_for_mesh(model).to(device)
        loss_fn = lm_pair_loss_fn
        if zero is not None:
            kwargs[zero] = True
    return ElasticTrainer(
        loss_fn, model, AdamW(model.parameters(), lr=3e-4), init_batch_size=32,
        scaling_rule=AdamScale(), precondition="adam", device=device, mesh=mesh,
        **kwargs,
    )


def axes_mesh(sp=1, tp=1, ep=1):
    """The launcher's chips as dp 1 x (sp, tp, ep), the example's rewrite."""
    from adaptdl_tpu_torch import env
    from adaptdl_tpu_torch.parallel.mesh import create_mesh_from_topology

    os.environ["ADAPTDL_SEQ_SHARDS"] = str(sp)
    os.environ["ADAPTDL_MODEL_SHARDS"] = str(tp)
    os.environ["ADAPTDL_EXPERT_SHARDS"] = str(ep)
    os.environ["ADAPTDL_NUM_REPLICAS"] = str(env.data_parallel_replicas())
    return create_mesh_from_topology()


def axes_flat(trainer, state):
    """The full logical parameters as one flat float32 vector on the host
    (a collective under the model, expert and ZeRO-3 layouts)."""
    if trainer.zero_mode in ("zero3", "zero3_blocks"):
        return zero_canonical(trainer, state)
    tree = trainer.params_tree(state)
    return torch.cat([tree[name].reshape(-1).float().cpu() for name in trainer._names])


def axes_replicated_checksum(trainer):
    """The bits checksum of the parameters no axis splits (this rank's)."""
    parts = [p.detach().reshape(-1).float().cpu()
             for p, spec in zip(trainer.model.parameters(), trainer._shard_specs)
             if spec is None]
    return _bits_checksum(torch.cat(parts))


def axes_drive(trainer, device, steps, zero3_lm_one_rank=False):
    """``steps`` bare train_step runs at (AXES_ATOMIC, 0) on 13's global
    batches (this rank's seq block under a seq axis); returns the record
    and the flat logical parameters before and after."""
    import numpy as np

    from adaptdl_tpu_torch import collective
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    state = trainer.init_state()
    before = axes_flat(trainer, state)
    host = seq_batches(steps, 512, AXES_ATOMIC)
    if zero3_lm_one_rank:
        # The zero3 LM at one rank reads raw token rows.
        host = [{"tokens": np.concatenate([b["inputs"], b["targets"][:, -1:]], axis=1)}
                for b in host]
    batches = [trainer.to_device(b) for b in host]
    step = trainer.train_step(AXES_ATOMIC, 0)
    gc_cuda()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launches()
    collective.reset_traffic()
    losses, seconds = [], []
    for batch in batches:
        torch.cuda.synchronize(device)
        start = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - start)
        losses.append(float(m["loss"]))
    launches = {k: _build.LAUNCHES[k] for k in (KERNEL_SM90, KERNEL)}
    traffic = {k: v / steps for k, v in collective.TRAFFIC.items()}
    peak = torch.cuda.max_memory_allocated(device)
    after = axes_flat(trainer, state)
    check(all(math.isfinite(x) for x in losses), f"13: losses {losses}")
    record = {
        "mesh": dict(trainer.mesh.shape), "losses": losses, "step_s": seconds,
        "median_step_ms": _median(seconds) * 1e3, "launches": launches,
        "traffic_bytes_per_step": traffic, "peak_gib": peak / 2**30,
        "checksum": _bits_checksum(after), "step": state.host_step,
    }
    if trainer.zero_mode is None:
        record["replicated_checksum"] = axes_replicated_checksum(trainer)
    return record, before, after, state


def axes_save(trainer, state, root, tag):
    """13d: save ``trainer``'s state to ``root/ckpt-<tag>`` (every rank
    joins the gather in sync()); returns the saved step and checksum."""
    from adaptdl_tpu_torch import checkpoint

    os.environ["ADAPTDL_CHECKPOINT_PATH"] = os.path.join(root, f"ckpt-{tag}")
    checkpoint._reset_registry()
    holder = {"state": state}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s), name="axes-lm"
    )
    start = time.perf_counter()
    checkpoint.save_all_states()
    entry = {"save_s": time.perf_counter() - start, "step": state.host_step,
             "checksum": _bits_checksum(axes_flat(trainer, state))}
    ckpt.unregister()
    del os.environ["ADAPTDL_CHECKPOINT_PATH"]
    return entry


def axes_restore(root, tag, kind, device, expect):
    """13d: one rank restores ``root/ckpt-<tag>`` into a one-rank trainer
    of ``kind``: the resumed step and parameter checksum must equal the
    saved ones."""
    from adaptdl_tpu_torch import checkpoint

    os.environ["ADAPTDL_CHECKPOINT_PATH"] = os.path.join(root, f"ckpt-{tag}")
    checkpoint._reset_registry()
    trainer = axes_trainer(kind, device, axes_mesh())
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s), name="axes-lm"
    )
    start = time.perf_counter()
    restored = checkpoint.load_state(ckpt)
    entry = {"restore_s": time.perf_counter() - start, "restored": restored,
             "resumed_at": holder["state"].host_step,
             "resumed_checksum": _bits_checksum(axes_flat(trainer, holder["state"]))}
    check(
        restored and entry["resumed_at"] == expect["step"]
        and entry["resumed_checksum"] == expect["checksum"],
        f"13d {tag}: resumed at step {entry['resumed_at']} (saved {expect['step']}), "
        f"parameters {'equal' if entry['resumed_checksum'] == expect['checksum'] else 'differ'}",
    )
    ckpt.unregister()
    del os.environ["ADAPTDL_CHECKPOINT_PATH"], trainer, holder, ckpt
    gc_cuda()
    return entry


AXES_RUNS = [("13a", "dense", {"tp": 2}), ("13b", "moe", {"ep": 2})] + [
    ("13c", "zero", {"sp": 2, "zero": mode}) for mode in AXES_ZERO_MODES
]


def axes_worker(kind, root):
    """Phase 13's processes, run side by side: ``single`` (one rank: every
    run's one-rank counterpart, then, once the pair has saved them, 13d's
    one-rank restores) and ``pair`` (a rank of two over gloo: 13a-13c, and
    13d's saves of 13a's and 13b's trainers). Each waits for the files
    the other publishes."""
    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import env

    torch.backends.cuda.matmul.allow_tf32 = False
    device = adaptdl_tpu_torch.initialize_job(device="cuda")
    rank = env.process_rank()
    if kind == "pair":
        import torch.distributed as dist

        check(dist.get_backend() == "gloo", f"13 pair backend {dist.get_backend()}")
    records, saved, seconds = {}, {}, {}
    for part, model_kind, axes in AXES_RUNS:
        t0 = time.perf_counter()
        zero = axes.get("zero")
        tag = f"{part}-{zero}" if zero else part
        shards = {k: axes.get(k, 1) if kind == "pair" else 1 for k in ("sp", "tp", "ep")}
        trainer = axes_trainer(model_kind, device, axes_mesh(**shards), zero)
        rec, before, after, state = axes_drive(
            trainer, device, AXES_STEPS,
            zero3_lm_one_rank=zero == "zero3_blocks" and kind == "single",
        )
        flat_path = os.path.join(root, f"single-{tag}.pt")
        if kind == "single":
            _publish_tensors({"before": before, "after": after}, flat_path)
        else:
            one = torch.load(_wait_file(flat_path, tag))
            check(torch.equal(one["before"], before), f"{tag}: initial weights differ")
            update = (one["after"] - one["before"]).norm().item()
            rec["param_rl2"] = (after - one["after"]).norm().item() / update
            rec["param_max_abs"] = (after - one["after"]).abs().max().item()
            if part in ("13a", "13b"):
                ckpt = "tp" if part == "13a" else "ep"
                saved[ckpt] = axes_save(trainer, state, root, ckpt)
                if rank == 0:
                    _publish_json(os.path.join(root, f"saved-{ckpt}.json"), saved[ckpt])
        records[tag] = rec
        del trainer, state, before, after
        gc_cuda()
        seconds[tag] = time.perf_counter() - t0
    records["seconds"] = seconds
    records["saved"] = saved
    if kind == "single":
        back = {}
        for ckpt, model_kind in (("tp", "dense"), ("ep", "moe")):
            with open(_wait_file(os.path.join(root, f"saved-{ckpt}.json"), f"13d {ckpt}")) as f:
                back[ckpt] = axes_restore(root, ckpt, model_kind, device, json.load(f))
        records["back"] = back
    name = "single" if kind == "single" else f"pair-rank{rank}"
    _publish_json(os.path.join(root, f"{name}.json"), records)


def phase_axes(kernel_rows, after_timing=None):
    """Phase 13: the model and expert axes, and seq x ZeRO, on the card.
    ``after_timing`` is called once the in-process kernel timing is done
    (smoke() starts phase 14 beside the rest of it there)."""
    import torch.nn.functional as F

    from adaptdl_tpu_torch.ops.flash_attention import (
        KERNEL, KERNEL_SM90, _launch, flash_attention_reference,
    )

    start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="adaptdl-torch-smoke-axes-")
    base = _clean_environ()

    def spawn(kind, replicas, restarts, launcher):
        run_env = dict(
            base, ADAPTDL_NUM_REPLICAS=str(replicas), ADAPTDL_NUM_RESTARTS=str(restarts),
        )
        cmd = [os.path.join(here, "chip_smoke.py"), "--axes-worker", kind, root]
        if launcher:
            cmd = ["-m", "adaptdl_tpu_torch.launch"] + cmd
        return subprocess.Popen(
            [sys.executable, *cmd], cwd=here, env=run_env, start_new_session=True
        )

    def load(tag):
        with open(os.path.join(root, f"{tag}.json")) as f:
            return json.load(f)

    try:
        # The sm90 kernel at the shape tensor parallelism gives it: 8 rows
        # x each rank's 6 of 12 heads x 512 positions.
        gen = torch.Generator(device="cuda").manual_seed(13)
        shape = (AXES_ATOMIC * 6, 512, 64)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        bh, seq, d = shape
        flops = 4 * d * bh * seq * (seq + 1) / 2
        nbytes = 4 * bh * seq * d * 2 + bh * seq * 4
        by_flops = flops / PEAK_BF16_FLOPS * 1e3
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        a, b, c = (t.reshape(AXES_ATOMIC, 6, seq, d) for t in (q, k, v))
        local = {
            "shape": list(shape),
            "ms": cuda_ms(lambda: _launch(KERNEL_SM90, q, k, v, True, None), 50),
            "plain_ms": cuda_ms(lambda: flash_attention_reference(q, k, v, True), 5),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(a, b, c, is_causal=True), 50
            ),
            "bound_ms": max(by_flops, by_bytes),
            "bound_by": "operations" if by_flops > by_bytes else "bytes",
        }
        out, lse = _launch(KERNEL_SM90, q, k, v, True, None)
        ref, ref_lse = flash_attention_reference(q, k, v, True)
        ratio = ((out.float() - ref.float()).abs()
                 / sm90_bound(q, k, v, True, ref, ref_lse)).max().item()
        check(ratio <= 1, f"13a: sm90 at {shape} exceeds its bound ({ratio:.3g})")
        local["max_err_over_bound"] = ratio
        print(f"axes 13a: {KERNEL_SM90} at the tensor-parallel local shape {shape} "
              f"(causal): {local}")
        del q, k, v, a, b, c, out, lse, ref, ref_lse
        if after_timing is not None:
            after_timing()
        gc_cuda()

        walls = _run_side_by_side(
            "13", {"single": spawn("single", 1, 0, launcher=False),
                   "pair": spawn("pair", 2, 1, launcher=True)},
        )
        single = load("single")
        pair = [load(f"pair-rank{r}") for r in (0, 1)]
        back = single["back"]
        print(f"axes 13 (one rank {walls['single']:.1f} s beside two ranks over gloo on "
              f"the one card {walls['pair']:.1f} s; correctness and per-rank memory, not "
              "the axes' speed; seconds of each run inside them: one rank "
              f"{single['seconds']}, two ranks {pair[0]['seconds']}):")
        for part, model_kind, axes in AXES_RUNS:
            zero = axes.get("zero")
            tag = f"{part}-{zero}" if zero else part
            recs, one = [p[tag] for p in pair], single[tag]
            want_mesh = {"data": 1, **{
                {"sp": "seq", "tp": "model", "ep": "expert"}[k]: v
                for k, v in axes.items() if k != "zero"
            }}
            check(recs[0]["mesh"] == want_mesh, f"{tag} mesh {recs[0]['mesh']}")
            if zero is None:
                check(recs[0]["replicated_checksum"] == recs[1]["replicated_checksum"]
                      and recs[0]["checksum"] == recs[1]["checksum"],
                      f"{tag}: the ranks' replicated leaves (or full parameters) differ")
            else:
                check(recs[0]["checksum"] == recs[1]["checksum"]
                      and recs[0]["losses"] == recs[1]["losses"],
                      f"{tag}: the two ranks' parameters differ")
            layers = 0 if model_kind == "zero" else 12
            want = 2 * layers * AXES_STEPS
            check(
                all(r["launches"][KERNEL_SM90] == want and r["launches"][KERNEL] == 0
                    for r in recs + [one]),
                f"{tag}: launches {[r['launches'] for r in recs]} (one rank "
                f"{one['launches']}), expected {want} sm90 per rank",
            )
            loss_rdiff = max(abs(x - y) / abs(y) for x, y in zip(recs[0]["losses"], one["losses"]))
            recs[0]["loss_rdiff"] = loss_rdiff
            check(
                loss_rdiff <= AXES_LOSS_RTOL and recs[0]["param_rl2"] <= AXES_PARAM_RL2,
                f"{tag} against one rank: losses {loss_rdiff:.3g} (bound "
                f"{AXES_LOSS_RTOL:.3g}), parameters {recs[0]['param_rl2']:.3g} of the "
                f"update (bound {AXES_PARAM_RL2})",
            )
            traffic = ", ".join(
                f"{k} {v / 1e6:.2f}" for k, v in recs[0]["traffic_bytes_per_step"].items() if v
            )
            print(
                f"  {tag} {recs[0]['mesh']}: ranks agree; losses {recs[0]['losses']} "
                f"(one rank {one['losses']}, max rel diff {loss_rdiff:.3g}); parameters "
                f"against one rank: L2 {recs[0]['param_rl2']:.3g} of its update, max abs "
                f"{recs[0]['param_max_abs']:.3g}; sm90 launches "
                f"{[r['launches'][KERNEL_SM90] for r in recs]}; collectives per step "
                f"(MB) {traffic}; per-rank peak {recs[0]['peak_gib']:.2f} / "
                f"{recs[1]['peak_gib']:.2f} GiB (one rank {one['peak_gib']:.2f}); median "
                f"step {recs[0]['median_step_ms']:.1f} / {recs[1]['median_step_ms']:.1f} "
                f"ms (one rank {one['median_step_ms']:.1f} ms)"
            )
        for tag in ("tp", "ep"):
            saved = pair[0]["saved"][tag]
            check(pair[1]["saved"][tag] == {**saved, "save_s": pair[1]["saved"][tag]["save_s"]},
                  f"13d {tag}: the ranks saved different states")
            print(f"axes 13d {tag} 2 -> 1: saved at step {saved['step']} "
                  f"({saved['save_s']:.2f} s); one rank resumed at step "
                  f"{back[tag]['resumed_at']} with its parameters "
                  f"({back[tag]['restore_s']:.2f} s)")
        for row in kernel_rows:
            name = row["name"]
            row["tp_launches"] = {
                part: [p[part]["launches"][name] for p in pair] for part in ("13a", "13b")
            }
            if name == KERNEL_SM90:
                row["tp_local"] = local
        print(json.dumps({"axes": {"single": single, "pair": pair, "back": back,
                                   "local": local}}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"axes: phase {time.perf_counter() - start:.1f} s")


PIPE_STEPS = 2  # 14a-14c, each run at (PIPE_ATOMIC, 0)
PIPE_ATOMIC = 8
PIPE_MICRO = 4  # the LM example's default M under a stage axis
# 14's pipelined runs: (part, tp, schedule); "interleaved" is the LM
# example's choice, at 12 layers over ss 2 and M 4 the interleaved
# schedule with v 6.
PIPE_RUNS = [("14a", 1, "gpipe"), ("14b", 1, "interleaved"), ("14c", 2, "interleaved")]
PIPE_REPLICATED = ("embed.weight", "ln_f.scale")


def pipe_mesh(tp=1, ss=1):
    """The launcher's chips as dp 1 x tp x ss, the example's rewrite."""
    from adaptdl_tpu_torch import env
    from adaptdl_tpu_torch.parallel.mesh import create_mesh_from_topology

    os.environ["ADAPTDL_SEQ_SHARDS"] = "1"
    os.environ["ADAPTDL_EXPERT_SHARDS"] = "1"
    os.environ["ADAPTDL_MODEL_SHARDS"] = str(tp)
    os.environ["ADAPTDL_STAGE_SHARDS"] = str(ss)
    os.environ["ADAPTDL_NUM_REPLICAS"] = str(env.data_parallel_replicas())
    return create_mesh_from_topology()


def pipe_trainer(device, mesh, schedule="gpipe"):
    """A full-width LM trainer of 14 on ``mesh`` (current), plain
    attention (the pipelined blocks' own): the dense LM at ss 1, else
    this rank's PipelineLM (GPipe, or the example's interleaved schedule,
    at M PIPE_MICRO, cut to its model shards under tp). Weights from
    seed 0, drawn once per process."""
    import dataclasses as dc

    from adaptdl_tpu_torch.examples.transformer_lm import lm_config, pipeline_interleave
    from adaptdl_tpu_torch.models import (
        PipelineLM, TransformerLM, init_transformer, lm_loss_fn, pipeline_lm_loss_fn,
    )
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.parallel.tensor_parallel import shard_transformer
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    tp, ss = mesh.axis_size("model"), mesh.axis_size("stage")
    config = lm_config(cpu=False, seq_len=512, flash=False, tp_shards=tp)
    full = _ZERO_WEIGHTS.get("pipe")
    if full is None:
        drawn = init_transformer(dc.replace(config, model_axis=None), seed=0, device="cpu")
        full = _ZERO_WEIGHTS["pipe"] = {k: v.detach().clone() for k, v in drawn.state_dict().items()}
        del drawn
    interleave = 1
    if schedule == "interleaved":
        interleave = pipeline_interleave(config.num_layers, ss, PIPE_MICRO)
    if ss == 1:
        with torch.device("meta"):
            model = TransformerLM(config)
        model.to_empty(device="cpu")
        model.load_state_dict(full)
        loss_fn = lm_loss_fn
    else:
        with torch.device("meta"):
            model = PipelineLM(config, ss, PIPE_MICRO, interleave, mesh.index("stage"))
        model.to_empty(device="cpu")
        model.load_state_dict({n: full[n] for n in model.state_dict()})
        if tp > 1:
            model = shard_transformer(model, (mesh.index("model"), tp))
        loss_fn = pipeline_lm_loss_fn
    model = model.to(device)
    return ElasticTrainer(
        loss_fn, model, AdamW(model.parameters(), lr=3e-4), init_batch_size=32,
        scaling_rule=AdamScale(), precondition="adam", device=device, mesh=mesh,
        pipeline_micro=PIPE_MICRO if ss > 1 else None,
    )


def pipe_flat(trainer, state):
    """The full logical parameters in the dense LM's order as one flat
    float32 vector on the host (a collective under a stage or model axis)."""
    tree = trainer.params_tree(state)
    names = trainer.model.dense_names() if trainer.stage_shards > 1 else trainer._names
    return torch.cat([tree[name].reshape(-1).float().cpu() for name in names])


def pipe_drive(trainer, device, steps):
    """``steps`` bare train_step runs at (PIPE_ATOMIC, 0) on 14's global
    batches of raw token rows (every rank of a stage group reads the
    replica's whole block); returns the record and the flat logical
    parameters before and after."""
    import numpy as np

    from adaptdl_tpu_torch import collective
    from adaptdl_tpu_torch.ops import _build
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    state = trainer.init_state()
    before = pipe_flat(trainer, state)
    host = [{"tokens": np.concatenate([b["inputs"], b["targets"][:, -1:]], axis=1)}
            for b in seq_batches(steps, 512, PIPE_ATOMIC)]
    batches = [trainer.to_device(b) for b in host]
    step = trainer.train_step(PIPE_ATOMIC, 0)
    gc_cuda()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launches()
    collective.reset_traffic()
    losses, seconds = [], []
    for batch in batches:
        torch.cuda.synchronize(device)
        start = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - start)
        losses.append(float(m["loss"]))
    launches = {k: _build.LAUNCHES[k] for k in (KERNEL_SM90, KERNEL)}
    traffic = {k: v / steps for k, v in collective.TRAFFIC.items()}
    peak = torch.cuda.max_memory_allocated(device)
    after = pipe_flat(trainer, state)
    check(all(math.isfinite(x) for x in losses), f"14: losses {losses}")
    named = dict(trainer.model.named_parameters())
    replicated = torch.cat([named[n].detach().reshape(-1).float().cpu() for n in PIPE_REPLICATED])
    record = {
        "mesh": dict(trainer.mesh.shape), "losses": losses, "step_s": seconds,
        "median_step_ms": _median(seconds) * 1e3, "launches": launches,
        "traffic_bytes_per_step": traffic, "peak_gib": peak / 2**30,
        "checksum": _bits_checksum(after), "step": state.host_step,
        "replicated_checksum": _bits_checksum(replicated),
        "local_params": sum(p.numel() for p in trainer.model.parameters()),
    }
    return record, before, after, state


def pipe_save(trainer, state, root, tag):
    """14d: save ``trainer``'s state to ``root/ckpt-<tag>`` (every rank
    joins the gather in sync()); returns the saved step and checksum."""
    from adaptdl_tpu_torch import checkpoint

    os.environ["ADAPTDL_CHECKPOINT_PATH"] = os.path.join(root, f"ckpt-{tag}")
    checkpoint._reset_registry()
    holder = {"state": state}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s), name="pipe-lm"
    )
    start = time.perf_counter()
    checkpoint.save_all_states()
    entry = {"save_s": time.perf_counter() - start, "step": state.host_step,
             "checksum": _bits_checksum(pipe_flat(trainer, state))}
    ckpt.unregister()
    del os.environ["ADAPTDL_CHECKPOINT_PATH"]
    return entry


def pipe_restore(root, tag, device, mesh, expect):
    """14d: restore ``root/ckpt-<tag>`` into a fresh trainer on ``mesh``:
    the resumed step and parameter checksum must equal the saved ones."""
    from adaptdl_tpu_torch import checkpoint

    os.environ["ADAPTDL_CHECKPOINT_PATH"] = os.path.join(root, f"ckpt-{tag}")
    checkpoint._reset_registry()
    trainer = pipe_trainer(device, mesh)
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s), name="pipe-lm"
    )
    start = time.perf_counter()
    restored = checkpoint.load_state(ckpt)
    entry = {"restore_s": time.perf_counter() - start, "restored": restored,
             "resumed_at": holder["state"].host_step,
             "resumed_checksum": _bits_checksum(pipe_flat(trainer, holder["state"]))}
    check(
        restored and entry["resumed_at"] == expect["step"]
        and entry["resumed_checksum"] == expect["checksum"],
        f"14d {tag} into {dict(mesh.shape)}: resumed at step {entry['resumed_at']} "
        f"(saved {expect['step']}), parameters "
        f"{'equal' if entry['resumed_checksum'] == expect['checksum'] else 'differ'}",
    )
    ckpt.unregister()
    del os.environ["ADAPTDL_CHECKPOINT_PATH"], trainer, holder, ckpt
    gc_cuda()
    return entry


def pipe_worker(kind, root):
    """Phase 14's processes, run side by side: ``single`` (one rank: the
    dense LM's steps, its save, then, once the pair has saved them, 14d's
    one-rank restores of 14a and 14b), ``pair`` (a rank of two over gloo:
    14a, 14b, their saves, then 14d's restore of the dense save at ss 2)
    and ``quad`` (a rank of four: 14c). Each waits for the files the
    others publish."""
    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import env

    torch.backends.cuda.matmul.allow_tf32 = False
    device = adaptdl_tpu_torch.initialize_job(device="cuda")
    rank = env.process_rank()
    if kind != "single":
        import torch.distributed as dist

        check(dist.get_backend() == "gloo", f"14 {kind} backend {dist.get_backend()}")
    records, saved, seconds = {}, {}, {}
    if kind == "single":
        t0 = time.perf_counter()
        trainer = pipe_trainer(device, pipe_mesh())
        rec, before, after, state = pipe_drive(trainer, device, PIPE_STEPS)
        _publish_tensors({"before": before, "after": after, "losses": rec["losses"]},
                         os.path.join(root, "single-flat.pt"))
        saved["dense"] = pipe_save(trainer, state, root, "dense")
        _publish_json(os.path.join(root, "saved-dense.json"), saved["dense"])
        records["dense"] = rec
        del trainer, state, before, after
        gc_cuda()
        seconds["dense"] = time.perf_counter() - t0
        back = {}
        for part in ("14a", "14b"):
            with open(_wait_file(os.path.join(root, f"saved-{part}.json"), f"14d {part}")) as f:
                back[part] = pipe_restore(root, part, device, pipe_mesh(), json.load(f))
        records["back"] = back
    else:
        runs = [r for r in PIPE_RUNS if (r[1] > 1) == (kind == "quad")]
        for part, tp, schedule in runs:
            t0 = time.perf_counter()
            trainer = pipe_trainer(device, pipe_mesh(tp=tp, ss=2), schedule)
            rec, before, after, state = pipe_drive(trainer, device, PIPE_STEPS)
            one = torch.load(_wait_file(os.path.join(root, "single-flat.pt"), part))
            check(torch.equal(one["before"], before), f"{part}: initial weights differ")
            update = (one["after"] - one["before"]).norm().item()
            rec["param_rl2"] = (after - one["after"]).norm().item() / update
            rec["param_max_abs"] = (after - one["after"]).abs().max().item()
            rec["one_losses"] = one["losses"]
            rec["interleave"] = trainer.model.interleave
            if kind == "pair":
                saved[part] = pipe_save(trainer, state, root, part)
                if rank == 0:
                    _publish_json(os.path.join(root, f"saved-{part}.json"), saved[part])
            records[part] = rec
            del trainer, state, before, after
            gc_cuda()
            seconds[part] = time.perf_counter() - t0
        if kind == "pair":
            with open(_wait_file(os.path.join(root, "saved-dense.json"), "14d dense")) as f:
                records["back"] = pipe_restore(root, "dense", device, pipe_mesh(ss=2),
                                               json.load(f))
    records["seconds"] = seconds
    records["saved"] = saved
    name = kind if kind == "single" else f"{kind}-rank{rank}"
    _publish_json(os.path.join(root, f"{name}.json"), records)


def phase_pipeline(kernel_rows):
    """Phase 14: the stage axis on the card."""
    from adaptdl_tpu_torch.ops.flash_attention import KERNEL, KERNEL_SM90

    start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="adaptdl-torch-smoke-pipe-")
    base = _clean_environ()

    def spawn(kind, replicas):
        run_env = dict(base, ADAPTDL_NUM_REPLICAS=str(replicas), ADAPTDL_NUM_RESTARTS="0")
        cmd = [os.path.join(here, "chip_smoke.py"), "--pipe-worker", kind, root]
        if replicas > 1:
            cmd = ["-m", "adaptdl_tpu_torch.launch"] + cmd
        return subprocess.Popen(
            [sys.executable, *cmd], cwd=here, env=run_env, start_new_session=True
        )

    def load(tag):
        with open(os.path.join(root, f"{tag}.json")) as f:
            return json.load(f)

    try:
        walls = _run_side_by_side(
            "14", {"single": spawn("single", 1), "pair": spawn("pair", 2),
                   "quad": spawn("quad", 4)},
        )
        single = load("single")
        groups = {"pair": [load(f"pair-rank{r}") for r in range(2)],
                  "quad": [load(f"quad-rank{r}") for r in range(4)]}
        one = single["dense"]
        print(f"pipeline 14 (one rank {walls['single']:.1f} s beside two ranks "
              f"{walls['pair']:.1f} s and four ranks {walls['quad']:.1f} s over gloo on "
              "the one card; correctness, per-rank memory and bytes, not the stage "
              f"axis's speed; seconds of each run inside them: one rank "
              f"{single['seconds']}, two ranks {groups['pair'][0]['seconds']}, four "
              f"ranks {groups['quad'][0]['seconds']}):")
        print(f"  one rank (dense LM, plain attention): losses {one['losses']}, launches "
              f"{one['launches']}, peak {one['peak_gib']:.2f} GiB, median step "
              f"{one['median_step_ms']:.1f} ms")
        check(one["launches"][KERNEL_SM90] == 0 and one["launches"][KERNEL] == 0,
              f"14 one rank: flash launches {one['launches']}")
        launches = {}
        for part, tp, _ in PIPE_RUNS:
            recs = [g[part] for g in groups["quad" if tp > 1 else "pair"]]
            interleave = recs[0]["interleave"]
            want_mesh = {"data": 1, **({"model": tp} if tp > 1 else {}), "stage": 2}
            check(recs[0]["mesh"] == want_mesh, f"{part} mesh {recs[0]['mesh']}")
            check(len({r["replicated_checksum"] for r in recs}) == 1
                  and len({r["checksum"] for r in recs}) == 1
                  and all(r["losses"] == recs[0]["losses"] for r in recs),
                  f"{part}: the ranks' replicated leaves, losses or gathered parameters differ")
            launches[part] = [r["launches"][KERNEL_SM90] + r["launches"][KERNEL] for r in recs]
            check(all(n == 0 for n in launches[part]),
                  f"{part}: flash launches {[r['launches'] for r in recs]}, expected 0")
            loss_rdiff = max(abs(x - y) / abs(y) for x, y in zip(recs[0]["losses"], one["losses"]))
            recs[0]["loss_rdiff"] = loss_rdiff
            check(
                loss_rdiff <= AXES_LOSS_RTOL and recs[0]["param_rl2"] <= AXES_PARAM_RL2,
                f"{part} against one rank: losses {loss_rdiff:.3g} (bound "
                f"{AXES_LOSS_RTOL:.3g}), parameters {recs[0]['param_rl2']:.3g} of the "
                f"update (bound {AXES_PARAM_RL2})",
            )
            traffic = ", ".join(
                f"{k} {v / 1e6:.2f}" for k, v in recs[0]["traffic_bytes_per_step"].items() if v
            )
            schedule = "GPipe" if interleave == 1 else f"interleaved v {interleave}"
            print(
                f"  {part} {recs[0]['mesh']} {schedule} M {PIPE_MICRO}: ranks agree "
                f"(replicated leaves bit-equal); losses {recs[0]['losses']} (max rel diff "
                f"{loss_rdiff:.3g}); parameters against one rank: L2 "
                f"{recs[0]['param_rl2']:.3g} of its update, max abs "
                f"{recs[0]['param_max_abs']:.3g}; flash launches {launches[part]}; "
                f"collectives per step (MB) {traffic}; per-rank peak "
                f"{[round(r['peak_gib'], 2) for r in recs]} GiB, local parameters "
                f"{[r['local_params'] for r in recs]}; median step "
                f"{[round(r['median_step_ms'], 1) for r in recs]} ms"
            )
        pair = groups["pair"]
        for part in ("14a", "14b"):
            saved = pair[0]["saved"][part]
            check(pair[1]["saved"][part] == {**saved, "save_s": pair[1]["saved"][part]["save_s"]},
                  f"14d {part}: the ranks saved different states")
            back = single["back"][part]
            print(f"pipeline 14d {part} ss 2 -> 1: saved at step {saved['step']} "
                  f"({saved['save_s']:.2f} s); one rank resumed at step "
                  f"{back['resumed_at']} with its parameters ({back['restore_s']:.2f} s)")
        dense = single["saved"]["dense"]
        for r in pair:
            check(r["back"]["resumed_at"] == dense["step"]
                  and r["back"]["resumed_checksum"] == dense["checksum"],
                  "14d dense -> ss 2: a rank resumed another state")
        print(f"pipeline 14d dense 1 -> ss 2: saved at step {dense['step']} "
              f"({dense['save_s']:.2f} s); both ranks resumed at step "
              f"{pair[0]['back']['resumed_at']} with its parameters "
              f"({pair[0]['back']['restore_s']:.2f} s)")
        for row in kernel_rows:
            row["pipeline_launches"] = launches
        print(json.dumps({"pipeline": {"single": single, **groups}}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"pipeline: phase {time.perf_counter() - start:.1f} s")


def main():
    if sys.argv[1:2] == ["--replica-worker"]:
        mode, root = sys.argv[2:4]
        replica_run(root, successor=mode == "successor")
        return
    if sys.argv[1:2] == ["--rescale-worker"]:
        rescale_run(*sys.argv[2:4])
        return
    if sys.argv[1:] == ["--nccl-check"]:
        nccl_world_one()
        return
    if sys.argv[1:2] == ["--zero-worker"]:
        zero_worker(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["--seq-worker"]:
        seq_worker(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["--axes-worker"]:
        axes_worker(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["--pipe-worker"]:
        pipe_worker(*sys.argv[2:4])
        return
    # The kernel cache lives on the share path (ops/_build.py): phase 2
    # builds into it, and every later process (phase 5's ranks, phase 8's
    # incarnations) loads from it.
    share = tempfile.mkdtemp(prefix="adaptdl-torch-smoke-share-")
    os.environ["ADAPTDL_SHARE_PATH"] = share
    try:
        smoke()
    finally:
        shutil.rmtree(share, ignore_errors=True)


def _beside(name, phase, kernel_rows):
    """``phase(kernel_rows)`` in a thread of its own, to run beside another
    phase's worker processes: returns (start, finish); ``finish`` waits
    for it and raises what it raised."""
    state = {"thread": None, "errors": []}

    def run():
        at = time.perf_counter()
        try:
            phase(kernel_rows)
        except BaseException as exc:  # noqa: BLE001 - raised by finish
            state["errors"].append(exc)
        print(f"phase {name}: {time.perf_counter() - at:.1f} s (beside)", flush=True)

    def start():
        state["thread"] = threading.Thread(target=run, name=f"smoke-phase-{name}")
        state["thread"].start()

    def finish():
        if state["thread"] is not None:
            state["thread"].join()
        if state["errors"]:
            raise state["errors"][0]

    return start, finish


def timed(name, fn, *args):
    """``fn(*args)``, printing its seconds."""
    start = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - start:.1f} s", flush=True)
    return out


def smoke():
    start = time.perf_counter()
    smi = timed("1 device", phase_device)
    timed("2 build", phase_build)
    kernel_rows = timed("3 flash", phase_flash)
    main_step_s = timed("4 main path", phase_main_path, kernel_rows)
    recorder = SupervisorRecorder({
        PAIR_JOB: ["slot-0"] * 2, SUPERVISED_JOB: ["slot-0"],
        RESCALE_JOB: ["slot-0"],
    })
    recorder.start()
    try:
        timed("5 multi replica", phase_multi_replica, kernel_rows, recorder)
        timed("6 supervised", phase_supervised, kernel_rows, recorder, main_step_s)
        timed("7 zoo", phase_zoo, kernel_rows)
        timed("8 rescale", phase_rescale, kernel_rows, recorder)
    finally:
        recorder.stop()
    timed("9 options", phase_options, kernel_rows)
    timed("10 control", phase_control, kernel_rows)
    # Phase 11 runs beside phase 12's worker processes and phase 14 beside
    # phase 13's, each started once the other phase has timed its kernel
    # in this process: all four phases' work is in worker processes of
    # their own, and none reads another's results.
    start_zero, finish_zero = _beside("11 zero", phase_zero, kernel_rows)
    try:
        timed("12 seq", phase_seq, kernel_rows, start_zero)
    finally:
        finish_zero()
    start_pipe, finish_pipe = _beside("14 pipeline", phase_pipeline, kernel_rows)
    try:
        timed("13 axes", phase_axes, kernel_rows, start_pipe)
    finally:
        finish_pipe()
    print(f"smoke: whole run {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
