"""Minimal elastic job: linear regression under plain SGD and AdaScale
(PyTorch port).

The port of ``examples/linear_regression.py``: four weights and a bias,
``SGD(0.05)`` (no momentum) with AdaScale over the unpreconditioned
noise statistics, initial batch 32, ``autoscale_batch_size(512,
local_bsz_bounds=(8, 128), gradient_accumulation=True)``, on 4096
noisy samples of known weights: the smallest drive of the noise
estimator and the scaling rule, and one whose answer is known.

Run on the card:   python -m adaptdl_tpu_torch.examples.linear_regression
On the CPU:        python -m adaptdl_tpu_torch.examples.linear_regression --cpu

``--steps`` and ``--report-dir`` bound a run under an elastic runner and
report each incarnation (``examples/_report.py``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

TRUE_W = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
INIT_BATCH = 32


class Linear(nn.Module):
    """``x @ w + b`` from zeros, as the JAX example's parameters."""

    def __init__(self, features: int = 4):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(features))
        self.b = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return x @ self.w + self.b


def mse_loss_fn(model, batch, generator=None):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def make_data(n: int = 4096, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = x @ TRUE_W + 0.1 * rng.normal(size=n).astype(np.float32)
    return {"x": x, "y": y}


def make_trainer(device):
    """(trainer, holder, checkpoint state) on ``device``; the checkpoint
    state is not loaded yet."""
    from adaptdl_tpu_torch.optim import SGD
    from adaptdl_tpu_torch.scaling_rules import AdaScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    model = Linear().to(device)
    trainer = ElasticTrainer(
        mse_loss_fn, model, SGD(model.parameters(), lr=0.05),
        init_batch_size=INIT_BATCH, scaling_rule=AdaScale(), device=device,
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    return trainer, holder, ckpt


def make_loader():
    from adaptdl_tpu_torch.data import AdaptiveDataLoader

    loader = AdaptiveDataLoader(make_data(), batch_size=INIT_BATCH)
    loader.autoscale_batch_size(
        512, local_bsz_bounds=(8, 128), gradient_accumulation=True
    )
    return loader


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--report-dir", type=str, default=None)
    args = parser.parse_args(argv)

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import checkpoint, epoch, metrics
    from adaptdl_tpu_torch.examples._report import RunReport

    device = adaptdl_tpu_torch.initialize_job(device="cpu" if args.cpu else "cuda")
    trainer, holder, ckpt = make_trainer(device)
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()
    loader = make_loader()
    report = RunReport(args.report_dir, args.steps, trainer.model)
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
                print(f"epoch {e}: loss={float(m['loss']):.5f}", flush=True)
    finally:
        report.write()
    w = trainer.model.w.detach().cpu().numpy()
    print("w:", w, "target:", TRUE_W)
    metrics.join_fit()
    return w, float(trainer.model.b.detach())


if __name__ == "__main__":
    main()
