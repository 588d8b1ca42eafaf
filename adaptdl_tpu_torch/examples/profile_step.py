"""Where a training step's time goes on the card.

Builds the full-width transformer LM of ``transformer_lm.py`` (flash
attention on), runs warm-up steps, times steps with CUDA events, then
traces a few more with ``torch.profiler`` and prints one JSON line:
step time and tokens/s, the device's busy and idle share over the
traced window, kernel time by phase of the step (the trainer's
``adaptdl.*`` ranges), the flash forward kernels' (either of the two)
and the flash backward's kernel time, and the kernels that take the
most time.

Run on the card:  python -m adaptdl_tpu_torch.examples.profile_step
Options: --accum-steps A (0 or more; atomic batch 32 / (A + 1)); the LM
example's --moe-experts, --moe-top-k, --chunked-xent, --remat-policy and
its ZeRO flags --zero1, --zero3, --zero3-blocks (dense attention, as the
example runs it). The line also gives the peak device memory of the
timed steps (``torch.cuda.max_memory_allocated``, reset before them)
and the bytes of this rank's collectives per step (``collective.TRAFFIC``).
One rank of a multi-rank job: ``python -m adaptdl_tpu_torch.launch -m
adaptdl_tpu_torch.examples.profile_step --zero3`` with
ADAPTDL_NUM_REPLICAS set; each rank prints its line.
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess

import torch


# Device names of the flash forward kernels (csrc/flash_attention_fwd.cu
# and csrc/flash_attention_fwd_sm90.cu).
FLASH_FORWARD_KERNELS = ("flash_fwd_kernel", "flash_fwd_sm90_kernel")


def _timeline(prof, phases, nested):
    """Attribute the traced kernels on the GPU timeline: each kernel
    belongs to the phase of the last phase range (GPU-side annotation;
    ``phases`` maps range names to phase names) that began before it,
    and to ``nested`` when it lies inside such a range. A range's host
    thread does not matter: the stream orders the work."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, marks, inner = [], [], []
    for e in prof.events():
        if e.device_type != cuda:
            continue
        span = (e.time_range.start, e.time_range.end)
        if getattr(e, "is_user_annotation", False):
            if e.name in phases:
                marks.append((span[0], phases[e.name]))
            elif e.name == nested:
                inner.append(span)
        else:
            kernels.append((*span, e.name))
    kernels.sort()
    marks.sort()
    inner.sort()
    starts = [m[0] for m in marks]
    inner_starts = [i[0] for i in inner]
    by_phase = {name: 0.0 for name in phases.values()}
    by_name: dict[str, list] = {}
    nested_us = busy_us = 0.0
    frontier = None
    for start, end, name in kernels:
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0:
            by_phase[marks[i][1]] += end - start
        j = bisect.bisect_right(inner_starts, start) - 1
        if j >= 0 and start < inner[j][1]:
            nested_us += end - start
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += end - start
        entry[1] += 1
        # Busy time: the union of kernel intervals.
        if frontier is None or start >= frontier:
            busy_us += end - start
            frontier = end
        elif end > frontier:
            busy_us += end - frontier
            frontier = end
    window_us = kernels[-1][1] - kernels[0][0] if kernels else 0.0
    return by_phase, nested_us, busy_us, window_us, by_name


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--accum-steps", type=int, default=0)
    parser.add_argument("--moe-experts", type=int, default=0)
    parser.add_argument("--moe-top-k", type=int, default=1)
    parser.add_argument("--chunked-xent", type=int, default=0)
    parser.add_argument("--remat-policy", type=str, default=None)
    parser.add_argument("--zero1", action="store_true")
    parser.add_argument("--zero3", action="store_true")
    parser.add_argument("--zero3-blocks", action="store_true")
    args = parser.parse_args(argv)
    steps = 5  # timed, then traced

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import trainer as trainer_mod
    from adaptdl_tpu_torch import collective, env
    from adaptdl_tpu_torch.examples.transformer_lm import (
        check_zero_flags,
        lm_config,
        synthetic_tokens,
    )
    from adaptdl_tpu_torch.models import init_transformer, init_zero3_lm, lm_loss_fn
    from adaptdl_tpu_torch.ops.chunked_xent import chunked_lm_loss_fn
    from adaptdl_tpu_torch.ops.flash_attention import RANGE_BACKWARD
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale

    args.flash = not args.zero3_blocks
    check_zero_flags(args)
    device = adaptdl_tpu_torch.initialize_job(device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq_len, global_batch = 512, 32
    replicas, rank = env.num_replicas(), env.replica_rank()
    atomic = global_batch // (args.accum_steps + 1) // replicas
    config = lm_config(
        cpu=False, seq_len=seq_len, flash=args.flash, remat_policy=args.remat_policy,
        moe_experts=args.moe_experts, moe_top_k=args.moe_top_k,
    )
    if args.zero3_blocks:
        loss_fn, model = init_zero3_lm(config, seed=0, device=device)
    else:
        model = init_transformer(config, seed=0, device=device)
        loss_fn = (
            chunked_lm_loss_fn(args.chunked_xent) if args.chunked_xent > 0
            else lm_loss_fn
        )
    trainer = trainer_mod.ElasticTrainer(
        loss_fn, model, AdamW(model.parameters(), lr=3e-4), init_batch_size=32,
        scaling_rule=AdamScale(), precondition="adam", device=device,
        zero1=args.zero1, zero3=args.zero3,
        zero3_blocks="blocks" if args.zero3_blocks else None,
    )
    state = trainer.init_state()
    tokens = synthetic_tokens(
        global_batch * 4, seq_len, config.vocab_size
    )["tokens"]
    local = global_batch // replicas
    batches = [
        trainer.to_device({"tokens": tokens[i + rank * local : i + (rank + 1) * local]})
        for i in range(0, len(tokens), global_batch)
    ]
    step = trainer.train_step(atomic, args.accum_steps)

    def run(n):
        nonlocal state
        for i in range(n):
            state, _ = step(state, batches[i % len(batches)])

    run(3)  # warm-up: allocator, kernel library, cuBLAS heuristics
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    collective.reset_traffic()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run(steps)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    traffic = {k: v / steps for k, v in collective.TRAFFIC.items()}

    activities = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=activities) as prof:
        run(steps)
        torch.cuda.synchronize()
    phases = {
        trainer_mod.RANGE_MICROBATCHES: "microbatches",
        trainer_mod.RANGE_STATISTICS: "statistics",
        trainer_mod.RANGE_OPTIMIZER: "optimizer",
        # On the GPU timeline the optimizer's own range, which spans the
        # same kernels, can stand in for the trainer's.
        "Optimizer.step#AdamW.step": "optimizer",
    }
    by_phase, flash_bwd_us, busy_us, window_us, by_name = _timeline(
        prof, phases, RANGE_BACKWARD
    )
    per_step = 1e-3 / steps  # profiler microseconds -> ms per step
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:16]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi,
        "config": {"layers": config.num_layers, "d_model": config.d_model,
                   "seq_len": seq_len, "global_batch": global_batch,
                   "accum_steps": args.accum_steps, "dtype": "bfloat16",
                   "moe_experts": args.moe_experts, "moe_top_k": args.moe_top_k,
                   "chunked_xent": args.chunked_xent,
                   "remat_policy": args.remat_policy,
                   "zero": trainer.zero_mode, "replicas": replicas,
                   "rank": rank},
        "step_ms": step_ms,
        "peak_memory_gib": peak_gib,
        "collective_bytes_per_step": traffic,
        "tokens_per_s": global_batch * seq_len / (step_ms * 1e-3),
        "traced_window_ms_per_step": window_us * per_step,
        "device_busy_ms_per_step": busy_us * per_step,
        "device_idle_share": 1.0 - busy_us / window_us,
        "kernel_ms_per_step_by_phase": {
            name: us * per_step for name, us in by_phase.items()
        },
        "flash_forward_kernel_ms_per_step": sum(
            us for name, (us, _) in by_name.items()
            if any(k in name for k in FLASH_FORWARD_KERNELS)
        ) * per_step,
        "flash_backward_kernel_ms_per_step": flash_bwd_us * per_step,
        "top_kernels_ms_per_step": [
            [name[:90], us * per_step, count // steps]
            for name, (us, count) in top
        ],
    }))


if __name__ == "__main__":
    main()
