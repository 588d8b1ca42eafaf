"""BERT-class masked-LM pretraining with gradient accumulation (PyTorch
port).

The port of ``examples/bert_mlm.py``: a bidirectional transformer
encoder (``TransformerConfig(causal=False)``; dense attention, as the
JAX example runs it) at 12 x 768 x 3072, 12 heads, seq 512, vocab 30522
(BERT-base), bf16 compute, per-block remat; the MLM objective with a
fresh 15% mask per step drawn from the microbatch's generator, scored on
the masked positions only; AdamW(3e-4) under AdamScale with
Adam-preconditioned statistics, initial batch 32, and
``autoscale_batch_size(2048, local_bsz_bounds=(8, 32),
gradient_accumulation=True)``: the per-replica bound is small, so a
larger batch comes from stacked accumulation steps. The data are stride
walks over the vocabulary, so a masked token follows from its context.

Run on the card:   python -m adaptdl_tpu_torch.examples.bert_mlm
On the CPU (tiny): python -m adaptdl_tpu_torch.examples.bert_mlm --cpu --epochs 1

``--moe-experts E`` makes every second block a mixture of E experts
(one expert shard), routed by ``--moe-router``: ``tokens`` (top-1 token
choice) or ``experts`` (expert choice, valid here because the encoder
is bidirectional), as the JAX example.
"""

from __future__ import annotations

import argparse

from adaptdl_tpu_torch.examples._data import stride_walks

INIT_BATCH = 32


def bert_config(cpu: bool, moe_experts: int = 0, moe_router: str = "tokens"):
    import torch

    from adaptdl_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        vocab_size=64 if cpu else 30522,
        num_layers=2 if cpu else 12,
        num_heads=2 if cpu else 12,
        d_model=64 if cpu else 768,
        d_ff=128 if cpu else 3072,
        dtype=torch.float32 if cpu else torch.bfloat16,
        remat=True,
        causal=False,
        moe_every_n=2 if moe_experts > 0 else 0,
        moe_num_experts=moe_experts,
        moe_router=moe_router,
    )


def make_trainer(
    device, cpu: bool, seed: int = 0, moe_experts: int = 0,
    moe_router: str = "tokens",
):
    """(trainer, holder, checkpoint state) of a fresh encoder on
    ``device``; the checkpoint state is not loaded yet."""
    from adaptdl_tpu_torch.models import init_transformer, mlm_loss_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    config = bert_config(cpu, moe_experts, moe_router)
    model = init_transformer(config, seed=seed, device=device)
    trainer = ElasticTrainer(
        mlm_loss_fn(mask_token=config.vocab_size - 1), model,
        AdamW(model.parameters(), lr=3e-4), init_batch_size=INIT_BATCH,
        scaling_rule=AdamScale(), precondition="adam", device=device,
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    return trainer, holder, ckpt


def make_loader(cpu: bool, seq_len: int | None = None):
    from adaptdl_tpu_torch.data import AdaptiveDataLoader

    n = 4096 if cpu else 65536
    dataset = stride_walks(n, seq_len or (32 if cpu else 512), bert_config(cpu).vocab_size)
    loader = AdaptiveDataLoader(dataset, batch_size=INIT_BATCH)
    loader.autoscale_batch_size(
        2048, local_bsz_bounds=(8, 32), gradient_accumulation=True
    )
    return loader


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--seq-len", type=int, default=None)
    parser.add_argument("--moe-experts", type=int, default=0)
    parser.add_argument(
        "--moe-router", choices=("tokens", "experts"), default="tokens"
    )
    args = parser.parse_args(argv)

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import checkpoint, epoch, metrics

    device = adaptdl_tpu_torch.initialize_job(device="cpu" if args.cpu else "cuda")
    trainer, holder, ckpt = make_trainer(
        device, args.cpu, moe_experts=args.moe_experts, moe_router=args.moe_router
    )
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()
    loader = make_loader(args.cpu, args.seq_len)
    for e in epoch.remaining_epochs_until(args.epochs):
        # A successor resumed at an epoch's end steps none of it.
        m = None
        for batch in loader:
            holder["state"], m = trainer.run_step(holder["state"], batch, loader)
        if m is not None:
            print(
                f"epoch {e}: mlm_loss={float(m['loss']):.4f} "
                f"batch={loader.current_batch_size} "
                f"(atomic={loader.current_atomic_bsz}, "
                f"accum={loader.current_accum_steps})",
                flush=True,
            )
    metrics.join_fit()
    return holder["state"]


if __name__ == "__main__":
    main()
