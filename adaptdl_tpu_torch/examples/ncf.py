"""Neural collaborative filtering (NeuMF) with elastic training and a
ranked evaluation (PyTorch port).

The port of ``examples/ncf.py`` at its defaults: 256 users, 512 items,
8 positives per user and 4 sampled negatives each (resampled every
epoch), ``Adam(1e-3)`` under AdamScale with Adam-preconditioned noise
statistics, initial batch 256, ``autoscale_batch_size(4096,
local_bsz_bounds=(64, 2048), gradient_accumulation=True)``, and after
every epoch each user's held-out positive ranked against 99 sampled
negatives (hit rate and NDCG at 10).

Run on the card:   python -m adaptdl_tpu_torch.examples.ncf
On the CPU (tiny): python -m adaptdl_tpu_torch.examples.ncf --cpu --epochs 1
"""

from __future__ import annotations

import argparse

import numpy as np

from adaptdl_tpu_torch.examples._data import (
    make_training_pairs,
    synthetic_interactions,
)

INIT_BATCH = 256
PER_USER = 8
NEGATIVES = 4


def make_trainer(device, users: int, items: int, seed: int = 0):
    """(trainer, holder, checkpoint state) of a fresh NeuMF on
    ``device``; the checkpoint state is not loaded yet."""
    from adaptdl_tpu_torch.models import init_ncf, ncf_loss_fn
    from adaptdl_tpu_torch.optim import Adam
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    model = init_ncf(users, items, seed=seed, device=device)
    trainer = ElasticTrainer(
        ncf_loss_fn, model, Adam(model.parameters(), lr=1e-3),
        init_batch_size=INIT_BATCH, scaling_rule=AdamScale(),
        precondition="adam", device=device,
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    return trainer, holder, ckpt


def make_data(users: int, items: int):
    """(training pairs of epoch 0, train positives, held-out positives)."""
    train_pos, held_out = synthetic_interactions(users, items, per_user=PER_USER)
    data = make_training_pairs(train_pos, items, num_negatives=NEGATIVES, seed=1)
    return data, train_pos, held_out


def make_loader(data):
    from adaptdl_tpu_torch.data import AdaptiveDataLoader

    loader = AdaptiveDataLoader(data, batch_size=INIT_BATCH)
    loader.autoscale_batch_size(
        4096, local_bsz_bounds=(64, 2048), gradient_accumulation=True
    )
    return loader


def ranked_eval(model, held_out, items: int, negatives: int = 99):
    """(HR@10, NDCG@10): each user's held-out positive ranked among
    ``negatives`` sampled items, on the model's device."""
    import torch

    users = held_out.shape[0]
    neg = np.random.default_rng(2).integers(0, items, size=(users, negatives))
    cand = np.concatenate([held_out[:, None], neg], axis=1).astype(np.int32)
    device = next(model.parameters()).device
    with torch.no_grad():
        scores = model(
            torch.as_tensor(np.repeat(np.arange(users, dtype=np.int32), cand.shape[1]),
                            device=device),
            torch.as_tensor(cand.reshape(-1), device=device),
        ).float().cpu().numpy().reshape(cand.shape)
    rank = (scores > scores[:, :1]).sum(axis=1)  # column 0 is the positive
    hits = rank < 10
    ndcg = np.where(hits, 1.0 / np.log2(rank + 2.0), 0.0)
    return float(hits.mean()), float(ndcg.mean())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--users", type=int, default=256)
    parser.add_argument("--items", type=int, default=512)
    parser.add_argument("--eval-negatives", type=int, default=99)
    args = parser.parse_args(argv)

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import checkpoint, epoch, metrics
    from adaptdl_tpu_torch.accumulator import Accumulator

    device = adaptdl_tpu_torch.initialize_job(device="cpu" if args.cpu else "cuda")
    trainer, holder, ckpt = make_trainer(device, args.users, args.items)
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()
    data, train_pos, held_out = make_data(args.users, args.items)
    loader = make_loader(data)
    accum = Accumulator()
    for e in epoch.remaining_epochs_until(args.epochs):
        # Per-epoch negatives, in place: the loader keeps these arrays.
        fresh = make_training_pairs(
            train_pos, args.items, num_negatives=NEGATIVES, seed=1 + e
        )
        for key in data:
            data[key][:] = fresh[key]
        for batch in loader:
            holder["state"], m = trainer.run_step(holder["state"], batch, loader)
            accum["loss_sum"] += float(m["loss"])
            accum["steps"] += 1
        hr, ndcg = ranked_eval(trainer.model, held_out, args.items, args.eval_negatives)
        with accum.synchronized():
            print(
                f"epoch {e}: "
                f"loss={accum['loss_sum'] / max(accum['steps'], 1):.4f} "
                f"HR@10={hr:.4f} NDCG@10={ndcg:.4f} "
                f"batch_size={loader.current_batch_size}",
                flush=True,
            )
        accum.reset()
    metrics.join_fit()
    return holder["state"], (hr, ndcg)


if __name__ == "__main__":
    main()
