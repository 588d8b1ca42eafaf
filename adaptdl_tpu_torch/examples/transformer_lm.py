"""Transformer language model on the elastic stack (PyTorch port).

The dense ``--flash`` path of ``examples/transformer_lm.py``: the
flagship LM (12 x 768, 12 heads, seq 512, vocab 32000, bf16 compute,
float32 params, per-block remat) trained with AdamW(3e-4) under
AdamScale, Adam-preconditioned noise statistics and the adaptive batch
size, on synthetic arithmetic token sequences.

Run on the card:   python -m adaptdl_tpu_torch.examples.transformer_lm
On the CPU (tiny): python -m adaptdl_tpu_torch.examples.transformer_lm --cpu --epochs 1

Flash attention (the sm_90a kernel) is on by default on the card and
off on the CPU, where it would run its plain version. As in the JAX
example: ``--chunked-xent N`` streams the output head in vocab chunks
of N (``ops/chunked_xent.py``; under ``--seq-shards`` each rank over its
own block of positions), ``--remat-policy`` names a
jax.checkpoint_policies policy, and ``--moe-experts E --moe-top-k K``
makes every second block a mixture of E experts (one expert shard).
``--steps`` and ``--report-dir`` bound a run under an elastic runner and
report each incarnation (``examples/_report.py``).

ZeRO storage modes, as in the JAX example: ``--zero1`` shards the Adam
moments over the replicas, ``--zero3`` the parameters too (it implies
``--zero1``), and ``--zero3-blocks`` trains the per-layer ZeRO-3 LM
(``models/zero3_lm.py``: one block gathered at a time, dense attention,
so not with ``--flash``, MoE or ``--chunked-xent``). Two ranks on the
CPU:

    ADAPTDL_NUM_REPLICAS=2 python -m adaptdl_tpu_torch.launch \
        -m adaptdl_tpu_torch.examples.transformer_lm --cpu --epochs 1 --zero3

Sequence parallelism, as in the JAX example: ``--seq-shards k`` (default
``ADAPTDL_SEQ_SHARDS``) splits every sequence across k chips, one process
each, with ring attention (``--seq-mode ring``, the default) or
``--seq-mode ulysses`` (two all-to-all head exchanges around one
full-sequence attention; with ``--flash`` the sm90 kernel runs on the
gathered sequence). ``ADAPTDL_NUM_REPLICAS`` counts the chips at launch;
the example rewrites it to the data-parallel replicas. Two ranks, one
replica, on the card:

    ADAPTDL_NUM_REPLICAS=2 ADAPTDL_SEQ_SHARDS=2 python -m adaptdl_tpu_torch.launch \
        -m adaptdl_tpu_torch.examples.transformer_lm --seq-shards 2 \
        --seq-mode ulysses --flash

The ZeRO flags compose with ``--seq-shards`` as in the JAX example (the
rows split over the data group; ``--zero3-blocks`` then trains on
inputs and targets aligned on the host).

Tensor and expert parallelism, as in the JAX example: ``--tp-shards k``
(default ``ADAPTDL_MODEL_SHARDS``) splits every block over k chips by
the Megatron table (``parallel/tensor_parallel.py``; with ``--flash``
the sm90 kernel runs on each rank's ``num_heads / k`` heads), and under
``--moe-experts E`` the experts split over ``ADAPTDL_EXPERT_SHARDS``
chips (``switch_moe``: an all-to-all each way). The mesh is data x seq x
model x expert, one process per chip. Two ranks, one replica, on the
card:

    ADAPTDL_NUM_REPLICAS=2 python -m adaptdl_tpu_torch.launch \
        -m adaptdl_tpu_torch.examples.transformer_lm --tp-shards 2 --flash
    ADAPTDL_NUM_REPLICAS=2 ADAPTDL_EXPERT_SHARDS=2 python -m adaptdl_tpu_torch.launch \
        -m adaptdl_tpu_torch.examples.transformer_lm --flash --moe-experts 8 --moe-top-k 2

Pipeline parallelism, as in the JAX example: ``--stage-shards k``
(default ``ADAPTDL_STAGE_SHARDS``) splits the blocks over k chips, one
process each (``models/pipeline_lm.py``), at ``--pipeline-micro M``
pipeline microbatches (default ``ADAPTDL_PIPELINE_MICRO``, 4 under a
stage axis): the interleaved schedule with ``v = L / k`` chunks per chip
when ``L / k > 1`` and ``M >= k``, else GPipe. The loss takes raw token
rows. ``--pipeline`` puts the job in the pipeline family at any k: the
hints advertise the stage axis (``max_stage_shards`` the largest power
of two dividing L, ``pipeline_chunks`` L) beside tensor parallelism, and
sp and ep as 1. The checkpoint is the dense LM's at any k, so a job
moves between ss 1 and 2 across a restart. The pipelined blocks run
plain attention (not with ``--flash``, sequence sharding, MoE or
``--chunked-xent``). Two ranks, one replica, on the CPU or the card:

    ADAPTDL_NUM_REPLICAS=2 python -m adaptdl_tpu_torch.launch \
        -m adaptdl_tpu_torch.examples.transformer_lm --pipeline --stage-shards 2
"""

from __future__ import annotations

import argparse
import os

from adaptdl_tpu_torch.examples._data import synthetic_tokens


def lm_config(
    cpu: bool, seq_len: int, flash: bool, remat_policy: str | None = None,
    moe_experts: int = 0, moe_top_k: int = 1, seq_shards: int = 1,
    seq_mode: str = "ring", tp_shards: int = 1, expert_shards: int = 1,
):
    """The example's model: full width on the card, tiny on the CPU.
    Under ``seq_shards`` > 1 attention crosses the ``"seq"`` axis as
    ``seq_mode`` says; ``flash`` then runs inside ulysses, on the
    gathered sequence. ``tp_shards`` > 1 splits the blocks over the
    ``"model"`` axis, ``expert_shards`` > 1 the experts over the
    ``"expert"`` axis."""
    import torch

    from adaptdl_tpu_torch.models import TransformerConfig
    from adaptdl_tpu_torch.ops import make_flash_attention
    from adaptdl_tpu_torch.parallel.ulysses import make_ulysses_attention

    block = min(128, seq_len)
    attention_fn = make_flash_attention(block_q=block, block_k=block) if flash else None
    if flash and seq_shards > 1:
        assert seq_mode == "ulysses", (
            "--flash composes with sequence sharding only under "
            "--seq-mode ulysses (full sequence gathered per head slice); "
            "ring attention owns its blocked softmax"
        )
        attention_fn = make_ulysses_attention("seq", inner_attention=attention_fn)
    return TransformerConfig(
        vocab_size=256 if cpu else 32000,
        num_layers=2 if cpu else 12,
        num_heads=2 if cpu else 12,
        d_model=64 if cpu else 768,
        d_ff=128 if cpu else 3072,
        dtype=torch.float32 if cpu else torch.bfloat16,
        remat=True,
        remat_policy=remat_policy,
        attention_fn=attention_fn,
        seq_axis="seq" if seq_shards > 1 else None,
        seq_attention=seq_mode,
        moe_every_n=2 if moe_experts > 0 else 0,
        moe_num_experts=moe_experts,
        moe_top_k=moe_top_k,
        model_axis="model" if tp_shards > 1 else None,
        moe_axis="expert" if expert_shards > 1 else None,
    )


def check_zero_flags(args) -> None:
    """The JAX example's composition rules for the ZeRO flags: zero3
    implies zero1; zero3_blocks is a storage mode of its own, without
    flash attention, MoE, tensor parallelism, the pipeline or the
    chunked head; zero1 without MoE, tensor parallelism or the pipeline.
    All compose with ``--seq-shards``."""
    tp = getattr(args, "tp_shards", None) or 1
    pipeline = pipeline_family(args)
    if args.zero3_blocks:
        assert not (args.zero1 or args.zero3), (
            "--zero3-blocks is a storage mode of its own; drop "
            "--zero1/--zero3"
        )
        assert (
            not pipeline and args.moe_experts == 0 and tp <= 1 and not args.flash
            and args.chunked_xent == 0
        ), (
            "--zero3-blocks shards parameter storage over the data "
            "axis and composes with data and sequence parallelism "
            "only"
        )
    if args.zero3:
        args.zero1 = True  # zero3 implies the zero1 constraints below
    if args.zero1:
        assert not pipeline and args.moe_experts == 0 and tp <= 1, (
            "--zero1 shards optimizer state over the data axis and "
            "composes with dp/seq only; stage/expert/tensor axes "
            "manage their own optimizer layouts"
        )


def pipeline_family(args) -> bool:
    """Whether the job runs (or may be moved to) a stage axis: the JAX
    example's ``--pipeline`` or a stage count above one."""
    return bool(getattr(args, "pipeline", False)) or (
        getattr(args, "stage_shards", None) or 1
    ) > 1


def check_pipeline_flags(args, seq_shards: int) -> None:
    """The JAX example's rule for the pipeline family: the stage axis
    composes with dp and tensor parallelism; ring or ulysses attention,
    MoE, flash and the chunked head own their axes or loss head."""
    if pipeline_family(args):
        assert (
            seq_shards <= 1 and args.moe_experts == 0 and not args.flash
            and args.chunked_xent == 0
        ), (
            "this example composes the stage axis with dp and tensor "
            "parallelism (ring attention / MoE / flash / chunked-xent "
            "own their axes or loss head); drop "
            "--pipeline/--stage-shards to use them"
        )


def pipeline_interleave(num_layers: int, stage_shards: int, micro: int) -> int:
    """The JAX example's schedule choice: the interleaved schedule with
    ``v = L / ss`` chunks per stage when ``L`` divides into more than one
    chunk per stage and ``M >= ss``, else GPipe (``v = 1``)."""
    if (
        stage_shards > 1 and num_layers % stage_shards == 0
        and num_layers // stage_shards > 1 and micro >= stage_shards
    ):
        return num_layers // stage_shards
    return 1


def max_seq_shards(args, seq_len: int, num_heads: int) -> int:
    """How far this job can shard a sequence, by the JAX example's rule:
    the largest power of two up to 8 dividing ``seq_len``, under ulysses
    also dividing ``num_heads``; 1 under ``--flash`` with ring attention
    (the flash path refuses ring sharding)."""
    max_sp = 1
    if not args.flash or args.seq_mode == "ulysses":
        while max_sp * 2 <= 8 and seq_len % (max_sp * 2) == 0:
            max_sp *= 2
    if args.seq_mode == "ulysses":
        while max_sp > 1 and num_heads % max_sp != 0:
            max_sp //= 2
    return max_sp


def max_model_shards(args, num_heads: int) -> int:
    """The JAX example's tensor-parallel hint: up to the head count (8 at
    most); 1 under ``--flash`` (the reference's reason is GSPMD's: a
    Pallas kernel is opaque to it) and under ``--zero1`` /
    ``--zero3-blocks``, which refuse a model axis."""
    if args.flash or args.zero1 or args.zero3_blocks:
        return 1
    return min(num_heads, 8)


def max_expert_shards(args) -> int:
    """The largest power of two dividing the expert count: a shard owns
    whole experts and the scheduler picks powers of two."""
    return args.moe_experts & -args.moe_experts if args.moe_experts > 0 else 1


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--seq-len", type=int, default=None)
    parser.add_argument(
        "--flash", action=argparse.BooleanOptionalAction, default=None
    )
    parser.add_argument("--chunked-xent", type=int, default=0)
    parser.add_argument("--remat-policy", type=str, default=None)
    parser.add_argument("--moe-experts", type=int, default=0)
    parser.add_argument("--moe-top-k", type=int, default=1)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--report-dir", type=str, default=None)
    parser.add_argument("--zero1", action="store_true")
    parser.add_argument("--zero3", action="store_true")
    parser.add_argument("--zero3-blocks", action="store_true")
    # Default: the scheduler's factorization (ADAPTDL_SEQ_SHARDS).
    parser.add_argument("--seq-shards", type=int, default=None)
    parser.add_argument("--seq-mode", choices=("ring", "ulysses"), default="ring")
    # Default: the scheduler's factorization (ADAPTDL_MODEL_SHARDS).
    parser.add_argument("--tp-shards", type=int, default=None)
    # Defaults: ADAPTDL_STAGE_SHARDS / ADAPTDL_PIPELINE_MICRO.
    parser.add_argument("--pipeline", action="store_true")
    parser.add_argument("--stage-shards", type=int, default=None)
    parser.add_argument("--pipeline-micro", type=int, default=None)
    args, unported = parser.parse_known_args(argv)
    if unported:
        raise NotImplementedError(
            f"flags not ported to adaptdl_tpu_torch yet: {unported}"
        )
    from adaptdl_tpu_torch import env

    seq_shards = args.seq_shards if args.seq_shards is not None else env.seq_shards()
    args.seq_shards = seq_shards
    tp_shards = args.tp_shards if args.tp_shards is not None else env.model_shards()
    args.tp_shards = tp_shards
    # Expert shards: the scheduler's choice, only for a model with experts.
    expert_shards = env.expert_shards() if args.moe_experts > 0 else 1
    stage_shards = args.stage_shards if args.stage_shards is not None else env.stage_shards()
    args.stage_shards = stage_shards
    if pipeline_family(args) and args.flash is None:
        args.flash = False  # the pipelined blocks run plain attention
    check_zero_flags(args)
    check_pipeline_flags(args, seq_shards)
    if stage_shards > 1:
        # Now: env.pipeline_micro()'s default and the trainer read it.
        os.environ["ADAPTDL_STAGE_SHARDS"] = str(stage_shards)
    chips = env.num_replicas()
    group = seq_shards * tp_shards * expert_shards * stage_shards
    if group > 1 and (chips % group or env.num_processes() != chips):
        raise ValueError(
            f"--seq-shards {seq_shards} runs one process per chip, as do "
            f"--tp-shards {tp_shards}, --stage-shards {stage_shards} and "
            f"{expert_shards} expert shards (python -m adaptdl_tpu_torch.launch): "
            f"ADAPTDL_NUM_REPLICAS={chips} chips over "
            f"ADAPTDL_NUM_PROCESSES={env.num_processes()}"
        )

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import checkpoint, epoch, metrics
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.examples._report import RunReport
    from adaptdl_tpu_torch.models import (
        init_pipeline_lm, init_transformer, init_zero3_lm, lm_loss_fn, lm_pair_loss_fn,
    )
    from adaptdl_tpu_torch.ops.chunked_xent import (
        chunked_lm_loss_fn, chunked_lm_pair_loss_fn,
    )
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.parallel.mesh import create_mesh_from_topology
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    device = adaptdl_tpu_torch.initialize_job(
        device="cpu" if args.cpu else "cuda"
    )
    seq_len = args.seq_len or (32 if args.cpu else 512)
    assert seq_len % seq_shards == 0, (
        f"--seq-len {seq_len} does not split into {seq_shards} shards"
    )
    flash = (
        args.flash if args.flash is not None
        else not (args.cpu or args.zero3_blocks)
        and (seq_shards == 1 or args.seq_mode == "ulysses")
    )
    args.flash = flash
    config = lm_config(
        args.cpu, seq_len, flash, args.remat_policy, args.moe_experts,
        args.moe_top_k, seq_shards, args.seq_mode, tp_shards, expert_shards,
    )
    if group > 1:
        # ADAPTDL_NUM_REPLICAS counts chips at launch; a seq, tensor,
        # stage or expert group of chips is one data-parallel replica.
        os.environ["ADAPTDL_SEQ_SHARDS"] = str(seq_shards)
        os.environ["ADAPTDL_MODEL_SHARDS"] = str(tp_shards)
        os.environ["ADAPTDL_STAGE_SHARDS"] = str(stage_shards)
        os.environ["ADAPTDL_EXPERT_SHARDS"] = str(expert_shards)
        os.environ["ADAPTDL_NUM_REPLICAS"] = str(env.data_parallel_replicas())
    # The mesh first: the model takes this rank's shards from it.
    mesh = create_mesh_from_topology()
    pipeline_micro = 1
    if stage_shards > 1:
        pipeline_micro = (
            args.pipeline_micro if args.pipeline_micro is not None
            else env.pipeline_micro()
        )
        loss_fn, model = init_pipeline_lm(
            config, stage_shards, pipeline_micro,
            pipeline_interleave(config.num_layers, stage_shards, pipeline_micro),
            seed=0, device=device,
        )
    elif args.zero3_blocks:
        # Raw token rows through the per-block-gather layer loop.
        loss_fn, model = init_zero3_lm(config, seed=0, device=device)
    else:
        model = init_transformer(config, seed=0, device=device)
        if seq_shards > 1:
            loss_fn = (
                chunked_lm_pair_loss_fn(args.chunked_xent)
                if args.chunked_xent > 0 else lm_pair_loss_fn
            )
        else:
            loss_fn = (
                chunked_lm_loss_fn(args.chunked_xent)
                if args.chunked_xent > 0 else lm_loss_fn
            )

    trainer = ElasticTrainer(
        loss_fn,
        model,
        AdamW(model.parameters(), lr=3e-4),
        init_batch_size=32,
        scaling_rule=AdamScale(),
        precondition="adam",
        device=device,
        zero1=args.zero1,
        zero3=args.zero3,
        zero3_blocks="blocks" if args.zero3_blocks else None,
        mesh=mesh,
        # The M the pipelined loss was built with.
        pipeline_micro=pipeline_micro if stage_shards > 1 else None,
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()

    dataset = synthetic_tokens(
        4096 if args.cpu else 65536, seq_len, config.vocab_size
    )
    if seq_shards > 1:
        # Inputs and targets aligned on the host: each rank's block of
        # positions carries its own targets.
        raw = dataset["tokens"]
        dataset = {"inputs": raw[:, :-1].copy(), "targets": raw[:, 1:].copy()}
    loader = AdaptiveDataLoader(dataset, batch_size=32)
    loader.autoscale_batch_size(
        1024, local_bsz_bounds=(4, 128), gradient_accumulation=True
    )
    # The pipeline family advertises only what it runs: the stage axis
    # (the largest power of two dividing L, with the interleaved
    # schedule's chunk pool, L) beside tensor parallelism, sp and ep 1.
    # The flag is stable across restarts, so an ss 1 incarnation keeps
    # advertising the stage axis.
    stage_mode = pipeline_family(args)
    metrics.set_topology_config(
        max_seq_shards=1 if stage_mode else max_seq_shards(args, seq_len, config.num_heads),
        max_model_shards=max_model_shards(args, config.num_heads),
        max_stage_shards=(config.num_layers & -config.num_layers) if stage_mode else 1,
        max_expert_shards=1 if stage_mode else max_expert_shards(args),
        pipeline_microbatches=max(pipeline_micro, 1),
        pipeline_chunks=config.num_layers if stage_mode else 0,
    )
    report = RunReport(
        args.report_dir, args.steps,
        trainer.params_tree if trainer.zero_mode or trainer.sharded else model,
    )
    report.begin(holder["state"])
    try:
        for e in epoch.remaining_epochs_until(args.epochs):
            if report.done():
                break
            # A successor resumed at an epoch's end steps none of it.
            m = None
            for batch in loader:
                holder["state"], m = trainer.run_step(
                    holder["state"], batch, loader
                )
                if report.note(holder["state"], m, loader):
                    break
            if m is not None:
                print(
                    f"epoch {e}: loss={float(m['loss']):.4f} "
                    f"batch_size={loader.current_batch_size} "
                    f"mesh={trainer.mesh.shape}",
                    flush=True,
                )
    finally:
        report.write()
    metrics.join_fit()


if __name__ == "__main__":
    main()
