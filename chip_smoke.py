"""Smoke run of adaptdl_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. device: versions, the card's name and power limit; CUDA required.
2. build: every kernel under adaptdl_tpu_torch/csrc, compiled in
   parallel (adaptdl_tpu_torch/ops/_build.py); ptxas registers and spills.
3. kernels vs plain: each kernel's wrapper against its plain PyTorch
   version on the card, at the main path's shapes and one small shape,
   with stated tolerances; the flash gradient (autograd Function)
   against dense autograd; times of the kernel, the plain version and
   one PyTorch library call computing the same function.
4. main path: the full-width transformer LM (12 x 768, 12 heads, seq
   512, vocab 32000, bf16) through initialize_job ->
   AdaptiveDataLoader -> ElasticTrainer.run_step, 10 steps at
   accum_steps 0 and 4 at accum_steps 1; launch counts reset just
   before and read just after, and held to the expected count per
   step; loss falls, statistics finite; the flash model agrees with the
   dense-attention model on a small input; a checkpoint restores bit
   for bit into a fresh trainer.
5. result: the kernels line, the card line, then the device line.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

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


def phase_build():
    from adaptdl_tpu_torch.ops import _build

    start = time.perf_counter()
    built = _build.build_all()
    print(f"build: {sorted(built)} in {time.perf_counter() - start:.1f} s")
    for name in built:
        # ptxas reports per kernel instance: its entry name, then its
        # spills and registers.
        entry, registers, spilling = None, {}, set()
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry is None:
                continue
            elif "spill stores" in line and not line.strip().startswith("0 bytes"):
                spilling.add(entry)
            elif "Used" in line and "registers" in line:
                registers[entry] = int(line.split("Used")[1].split()[0])
        main = [n for n in registers if "13__nv_bfloat16Li64E" in n]
        print(
            f"build: {name}: {len(registers)} kernel instances, "
            f"{len(spilling)} spill; registers per thread "
            f"{min(registers.values())}-{max(registers.values())}, "
            f"bf16 head_dim 64: {[registers[n] for n in main]}"
        )


def phase_flash():
    """Flash forward kernel vs its plain version, gradients, times."""
    import torch.nn.functional as F

    from adaptdl_tpu_torch.models.transformer import causal_attention
    from adaptdl_tpu_torch.ops.flash_attention import (
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

    main_shape = (32 * 12, 512, 64)  # B*H, S, D of the main path
    small_shape = (8, 128, 64)
    main_err = None
    for shape, block in ((main_shape, 128), (small_shape, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = qkv(shape, dtype)
                out, lse = flash_attention_fwd(q, k, v, causal, None, block, block)
                torch.cuda.synchronize()
                ref, ref_lse = flash_attention_reference(
                    q, k, v, causal, None, block, block
                )
                err = (out.float() - ref.float()).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                # f32: summation order only. bf16: both round one f32
                # result to bf16, so they differ by at most one ulp at
                # the output's scale.
                tol = (
                    2e-5 if dtype == torch.float32
                    else bf16_ulp(ref.float().abs().max().item())
                )
                print(
                    f"flash fwd {tuple(shape)} {str(dtype)[6:]} "
                    f"causal={causal}: max|out-plain|={err:.3g} "
                    f"(tol {tol:.3g}), max|lse-plain|={lse_err:.3g} (tol 1e-4)"
                )
                check(err <= tol and lse_err <= 1e-4, "flash forward disagrees")
                if shape == main_shape and dtype == torch.bfloat16 and causal:
                    main_err = err

    # Gradient through the autograd Function vs dense autograd, f32.
    for shape, block, atol, rtol in (
        ((2, 4, 128, 64), 64, 5e-5, 5e-4),
        # 512-term sums instead of 128: a looser bound.
        ((32, 12, 512, 64), 128, 1e-4, 1e-3),
    ):
        q, k, v = (
            t.reshape(shape).requires_grad_()
            for t in qkv((shape[0] * shape[1],) + shape[2:], torch.float32)
        )
        flash_out = flash_attention(q, k, v, True, None, block, block)
        got = torch.autograd.grad(
            (flash_out * torch.cos(flash_out)).sum(), (q, k, v)
        )
        dense_out = causal_attention(q, k, v, causal=True)
        want = torch.autograd.grad(
            (dense_out * torch.cos(dense_out)).sum(), (q, k, v)
        )
        for g, w, name in zip(got, want, "qkv"):
            bad = (g - w).abs() > atol + rtol * w.abs()
            print(
                f"flash grad d{name} {shape}: max err "
                f"{(g - w).abs().max().item():.3g} "
                f"(atol {atol}, rtol {rtol})"
            )
            check(not bad.any().item(), f"flash gradient d{name} disagrees")

    # Times at the main path's shape (bf16, causal).
    q, k, v = qkv(main_shape, torch.bfloat16)
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, True), 20)
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, True), 5)
    q4, k4, v4 = (t.reshape(32, 12, 512, 64) for t in (q, k, v))
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20
    )
    noncausal_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, False), 20)
    bh, seq, head_dim = main_shape
    # Visible (query, key) pairs under the causal mask; two products of
    # 2*D operations each.
    flops = 4 * head_dim * bh * seq * (seq + 1) / 2
    nbytes = 4 * bh * seq * head_dim * 2 + bh * seq * 4
    bound_flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(
        f"flash fwd times (bf16 causal {main_shape}): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
        f"non-causal kernel {noncausal_ms:.4f} ms; "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB"
    )
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "adaptdl_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "adaptdl_tpu/ops/flash_attention.py:57",
        "launches": None,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_flops_ms, bound_bytes_ms),
        "bound_by": (
            "operations" if bound_flops_ms > bound_bytes_ms else "bytes"
        ),
        "library_ms": library_ms,
    }


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
                before = _build.LAUNCHES["flash_attention_fwd"]
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
                got = _build.LAUNCHES["flash_attention_fwd"] - before
                check(
                    got == expected,
                    f"step {i}: {got} flash launches, expected {expected}",
                )
                losses.append(float(m["loss"]))
                if i + 1 == 10:
                    loader.apply_retune(16, 1)
                if i + 1 == len(plan):
                    break
        launches = dict(_build.LAUNCHES)
        peak_mem = torch.cuda.max_memory_allocated()

        for row in kernel_rows:
            row["launches"] = launches.get(row["name"], 0)
            check(row["launches"] > 0, f"{row['name']} never launched")
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

        # The flash model against the dense-attention model, f32, on a
        # small input: logits agree to f32 accumulation-order error.
        f32_config = dataclasses.replace(config, dtype=torch.float32)
        dense_config = dataclasses.replace(f32_config, attention_fn=None)
        tokens = torch.as_tensor(dataset["tokens"][:2, :-1], device=device)
        with torch.no_grad():
            logits = {}
            for name, cfg in (("flash", f32_config), ("dense", dense_config)):
                twin = TransformerLM(cfg).to(device)
                twin.load_state_dict(model.state_dict())
                logits[name] = twin(tokens)
            err = (logits["flash"] - logits["dense"]).abs().max().item()
        print(f"model: max|logits flash - dense| (f32) = {err:.3g} (tol 1e-3)")
        check(
            logits["flash"].shape == (2, seq_len, config.vocab_size)
            and torch.isfinite(logits["flash"]).all().item()
            and err <= 1e-3,
            "flash model disagrees with the dense model",
        )

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
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def main():
    smi = phase_device()
    phase_build()
    kernel_rows = [phase_flash()]
    phase_main_path(kernel_rows)
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
