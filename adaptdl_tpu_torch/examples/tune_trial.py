"""One trial of elastic tuning: linear regression at the tuner's ``lr``.

The training script a :class:`adaptdl_tpu_torch.tune.TrialScheduler`
runs as each trial: four weights from zeros fitted to 64 exact samples
of known weights under ``SGD(lr)`` (``lr`` from
``tune.get_trial_config()``) and AdaScale, at batch 16 for ``--epochs``
epochs, reporting the last step's loss once per epoch through
``tune.report`` (where the trial waits at its rung until the tuner
promotes or stops it). Outside a tuner it runs at ``lr`` 0.05 and
reports nothing.

    python -m adaptdl_tpu_torch.examples.tune_trial [--cpu]

and in the tuning program::

    tune.TrialScheduler(
        "adaptdl_tpu_torch/examples/tune_trial.py",
        {"lr": [0.05, 0.02, 1e-6]}, num_chips=3, metric="loss",
        mode="min", grace_results=2).run()
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

BATCH = 16


class Weights(nn.Module):
    def __init__(self, features: int = 4):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x @ self.w


def mse_loss_fn(model, batch, generator=None):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def make_data(seed: int = 0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=4).astype(np.float32)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    return {"x": x, "y": (x @ w_true).astype(np.float32)}


def main(argv=None) -> float | None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=8)
    args = parser.parse_args(argv)

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import checkpoint, epoch, metrics, tune
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.optim import SGD
    from adaptdl_tpu_torch.scaling_rules import AdaScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    device = adaptdl_tpu_torch.initialize_job(device="cpu" if args.cpu else "cuda")
    lr = float(tune.get_trial_config().get("lr", 0.05))
    model = Weights().to(device)
    trainer = ElasticTrainer(
        mse_loss_fn, model, SGD(model.parameters(), lr=lr),
        init_batch_size=BATCH, scaling_rule=AdaScale(), device=device,
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()
    loader = AdaptiveDataLoader(make_data(), batch_size=BATCH)
    loss = None
    for e in epoch.remaining_epochs_until(args.epochs):
        m = None
        for batch in loader:
            holder["state"], m = trainer.run_step(holder["state"], batch, loader)
        if m is not None:
            loss = float(m["loss"])
            print(f"epoch {e}: lr={lr} loss={loss:.6f}", flush=True)
            tune.report(loss=loss)
    metrics.join_fit()
    return loss


if __name__ == "__main__":
    main()
