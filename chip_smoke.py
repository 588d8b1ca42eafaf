"""Smoke run of adaptdl_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. device: versions, the card's name and power limit; CUDA required.
2. build: every kernel under adaptdl_tpu_torch/csrc, compiled in
   parallel (adaptdl_tpu_torch/ops/_build.py); ptxas registers, spills
   and each sm90 instance's shared memory.
3. kernels vs plain: both flash forward kernels against their plain
   PyTorch version on the card -- the sm90 kernel (bf16, head_dim 64
   and 128) at the main path's shape, head_dim 128 and a ragged seq;
   the f32 kernel at f32 and head_dim 40 -- with stated tolerances (a
   per-element bound for the sm90 kernel, see sm90_bound) and a check of
   which kernel each input reached; the flash gradient
   (autograd Function) against dense autograd in f32 and bf16; times of
   both kernels on the main path's bf16 input, the plain version and
   one PyTorch library call computing the same function.
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
   seconds and the phase's median step time against phase 4's.
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
8. result: the kernels line, the card line, then the device line. Each
   kernel row's "launches" is its count in the main path's steps (0 for
   the f32 kernel, which the bf16 path does not run); "check_launches"
   is its count in the flash-vs-dense model check; "multi_replica_
   launches" its count on each rank of 5a, "rescaled_launches" in 5c,
   "supervised_launches" in phase 6 and "zoo_launches" in each path of
   phase 7.
"""

import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM tensor cores, dense


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
    main = [r for n, r in registers.items() if "13__nv_bfloat16Li64E" in n]
    print(
        f"build: {KERNEL}: {len(report)} kernel instances, "
        f"{sum(r['spill_bytes'] > 0 for r in report.values())} spill; "
        f"registers per thread {min(registers.values())}-"
        f"{max(registers.values())}, bf16 head_dim 64: {main}"
    )
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
    # f32 kernel: f32 at the main and a small shape, bf16 head_dim 40.
    for shape, dtype, block in (
        (main_shape, torch.float32, 128), ((8, 128, 64), torch.float32, 64),
        ((3, 100, 40), torch.bfloat16, 100),
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

    # Times at the main path's shape (bf16, causal), all in this run.
    q, k, v = qkv(main_shape, torch.bfloat16)
    ms = cuda_ms(lambda: _launch(KERNEL_SM90, q, k, v, True, None), 50)
    f32_kernel_ms = cuda_ms(lambda: _launch(KERNEL, q, k, v, True, None), 20)
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, True), 5)
    q4, k4, v4 = (t.reshape(32, 12, 512, 64) for t in (q, k, v))
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 50
    )
    noncausal_ms = cuda_ms(
        lambda: _launch(KERNEL_SM90, q, k, v, False, None), 50
    )
    bh, seq, head_dim = main_shape
    # Visible (query, key) pairs under the causal mask; two products of
    # 2*D operations each.
    flops = 4 * head_dim * bh * seq * (seq + 1) / 2
    nbytes = 4 * bh * seq * head_dim * 2 + bh * seq * 4
    bound_flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(
        f"flash fwd times (bf16 causal {main_shape}): {KERNEL_SM90} "
        f"{ms:.4f} ms, non-causal {noncausal_ms:.4f} ms; {KERNEL} "
        f"{f32_kernel_ms:.4f} ms; plain {plain_ms:.4f} ms; sdpa "
        f"{library_ms:.4f} ms; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB"
    )
    common = {
        "route": "cuda",
        "replaces": "adaptdl_tpu/ops/flash_attention.py:57",
        "launches": None,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_flops_ms, bound_bytes_ms),
        "bound_by": (
            "operations" if bound_flops_ms > bound_bytes_ms else "bytes"
        ),
        "library_ms": library_ms,
    }
    return [
        {"name": KERNEL_SM90,
         "source": f"adaptdl_tpu_torch/csrc/{KERNEL_SM90}.cu",
         "max_abs_err": errs[KERNEL_SM90], "ms": ms, **common},
        {"name": KERNEL, "source": f"adaptdl_tpu_torch/csrc/{KERNEL}.cu",
         "max_abs_err": errs[KERNEL], "ms": f32_kernel_ms, **common},
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
    it refuses), ``GET /config`` (the job's allocation, and its
    batchConfig once :meth:`serve_batch_config` was called) and
    ``POST /incident``. Jobs are ``{job_id: allocation}``."""

    def __init__(self, jobs):
        self.jobs = dict(jobs)
        self.cond = threading.Condition()
        self.requests = []  # guarded-by: cond
        self.workers = {}  # (job, group) -> {rank: address}; guarded-by: cond
        self.batch_config = {}  # job -> batchConfig; guarded-by: cond
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
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

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
                    }
            elif (method, route) == ("POST", "incident"):
                if not (body or {}).get("kind"):
                    status, reply = 400, {"error": "kind required"}
            elif (method, route) != ("PUT", "heartbeat"):
                status, reply = 404, {"error": "no such route"}
        elif route in ("register", "discover", "heartbeat", "hints",
                       "config", "incident"):
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
                # A save lands after a step, before the next batch: the
                # state here is the state it saved.
                for name in os.listdir(ckpt_dir):
                    path = os.path.join(ckpt_dir, name)
                    if name.startswith("checkpoint-") and path not in saved:
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


def main():
    if sys.argv[1:2] == ["--replica-worker"]:
        mode, root = sys.argv[2:4]
        replica_run(root, successor=mode == "successor")
        return
    if sys.argv[1:] == ["--nccl-check"]:
        nccl_world_one()
        return
    smi = phase_device()
    phase_build()
    kernel_rows = phase_flash()
    main_step_s = phase_main_path(kernel_rows)
    recorder = SupervisorRecorder({PAIR_JOB: ["slot-0"] * 2, SUPERVISED_JOB: ["slot-0"]})
    recorder.start()
    try:
        phase_multi_replica(kernel_rows, recorder)
        phase_supervised(kernel_rows, recorder, main_step_s)
    finally:
        recorder.stop()
    phase_zoo(kernel_rows)
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
