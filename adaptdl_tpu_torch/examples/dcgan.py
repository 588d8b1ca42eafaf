"""DCGAN: elastic adversarial training with TensorBoard sample grids
(PyTorch port).

The port of ``examples/dcgan.py`` at its settings off the CPU: 64
features, latent 32, batch 64, 50,000 synthetic 32x32x3 images squashed
to [-1, 1]. The discriminator trains under ``ElasticTrainer(has_aux=
True)``, its gradient noise driving the adaptive batch size, with the
current generator reaching its loss as ``aux``; the generator steps
beside it on the same batch's latent noise (one all-reduce of its
gradients across replicas, so every replica keeps the same generator).
Both register a checkpoint state, so the pair restores together after a
preemption or a rescale. Rank 0 writes the epoch's losses and a 4x4 grid
of samples from fixed noise to TensorBoard.

Run on the card:   python -m adaptdl_tpu_torch.examples.dcgan
On the CPU (tiny): python -m adaptdl_tpu_torch.examples.dcgan --cpu --epochs 1
The event files go to --logdir, else $ADAPTDL_TENSORBOARD_LOGDIR/dcgan,
else dcgan/ in the temp directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from adaptdl_tpu_torch import checkpoint
from adaptdl_tpu_torch.examples._data import synthetic_images

INIT_BATCH = 64
LR = 2e-4
B1 = 0.5


def make_pair(device, cpu: bool, latent_dim: int = 32,
              features: int | None = None, seed: int = 0):
    """(d_trainer, d_holder, d_ckpt, g_step, g_ckpt) on ``device``: the
    discriminator's trainer and checkpoint state, and the generator's
    step and checkpoint state (the generator is ``g_ckpt.generator``);
    neither state is loaded yet."""
    from adaptdl_tpu_torch.models import (
        discriminator_loss_fn,
        init_dcgan,
        make_generator_step,
    )
    from adaptdl_tpu_torch.optim import Adam
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    generator, discriminator = init_dcgan(
        seed=seed, device=device, latent_dim=latent_dim,
        base_features=features or (16 if cpu else 64),
    )
    d_trainer = ElasticTrainer(
        discriminator_loss_fn, discriminator,
        Adam(discriminator.parameters(), lr=LR, b1=B1),
        init_batch_size=INIT_BATCH, has_aux=True, device=device,
    )
    d_holder = {"state": d_trainer.init_state()}
    d_ckpt = d_trainer.make_checkpoint_state(
        lambda: d_holder["state"], lambda s: d_holder.__setitem__("state", s),
        name="dcgan_discriminator",
    )
    g_optimizer = Adam(generator.parameters(), lr=LR, b1=B1)
    g_ckpt = GeneratorState("dcgan_generator", generator, g_optimizer)
    g_step = make_generator_step(generator, discriminator, g_optimizer)
    return d_trainer, d_holder, d_ckpt, g_step, g_ckpt


class GeneratorState(checkpoint.State):
    """The generator's checkpoint state: its parameters and Adam
    moments."""

    def __init__(self, name, generator, optimizer):
        super().__init__(name)
        self.generator, self.optimizer = generator, optimizer

    def save(self, fileobj):
        torch.save(
            {"model": self.generator.state_dict(),
             "optimizer": self.optimizer.state_dict()},
            fileobj,
        )

    def load(self, fileobj):
        payload = torch.load(fileobj, map_location="cpu", weights_only=True)
        self.generator.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])


def make_loader(cpu: bool, latent_dim: int = 32):
    """The loader over tanh images and, per sample, its latent noise
    (stable across a replay, like the JAX example's)."""
    from adaptdl_tpu_torch.data import AdaptiveDataLoader

    n = 1024 if cpu else 50000
    images = np.tanh(synthetic_images(n, 32, 3, 10)["image"]).astype(np.float32)
    zs = np.random.default_rng(0).normal(size=(n, latent_dim)).astype(np.float32)
    loader = AdaptiveDataLoader({"image": images, "z": zs}, batch_size=INIT_BATCH)
    loader.autoscale_batch_size(
        512, local_bsz_bounds=(16, 256), gradient_accumulation=True
    )
    return loader


def sample_grid(generator, fixed_z) -> np.ndarray:
    """[16, 32, 32, 3] tanh samples -> one [128, 128, 3] uint8 grid."""
    with torch.no_grad():
        fakes = generator(fixed_z).float().cpu().numpy()
    fakes = ((fakes + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    rows = [np.concatenate(list(fakes[r * 4:(r + 1) * 4]), axis=1) for r in range(4)]
    return np.concatenate(rows, axis=0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--latent-dim", type=int, default=32)
    parser.add_argument("--features", type=int, default=None)
    parser.add_argument("--logdir", type=str, default=None)
    args = parser.parse_args(argv)

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import env, epoch, metrics
    from adaptdl_tpu_torch.accumulator import Accumulator
    from adaptdl_tpu_torch.tensorboard import EventFileWriter

    device = adaptdl_tpu_torch.initialize_job(device="cpu" if args.cpu else "cuda")
    d_trainer, holder, d_ckpt, g_step, g_ckpt = make_pair(
        device, args.cpu, args.latent_dim, args.features
    )
    checkpoint.load_state(d_ckpt)
    checkpoint.load_state(g_ckpt)
    metrics.ensure_checkpoint_registered()
    loader = make_loader(args.cpu, args.latent_dim)

    writer = None
    if env.replica_rank() == 0:
        logdir = args.logdir or os.path.join(
            env.tensorboard_logdir() or tempfile.gettempdir(), "dcgan"
        )
        writer = EventFileWriter(logdir)
    fixed_z = torch.as_tensor(
        np.random.default_rng(1).normal(size=(16, args.latent_dim)).astype(np.float32),
        device=device,
    )
    accum = Accumulator()
    try:
        for e in epoch.remaining_epochs_until(args.epochs):
            for batch in loader:
                # D under the elastic trainer (aux = the current G), then
                # G against the updated D on this replica's noise.
                holder["state"], m = d_trainer.run_step(
                    holder["state"], batch, loader, g_ckpt.generator
                )
                g_loss = g_step(d_trainer.to_device({"z": batch["z"]})["z"])
                accum["d_loss"] += float(m["loss"])
                accum["g_loss"] += float(g_loss)
                accum["steps"] += 1
            with accum.synchronized():
                # Read inside the block: on exit the pending updates clear.
                steps = max(accum["steps"], 1)
                d_avg, g_avg = accum["d_loss"] / steps, accum["g_loss"] / steps
                print(
                    f"epoch {e}: d_loss={d_avg:.4f} g_loss={g_avg:.4f} "
                    f"batch_size={loader.current_batch_size}",
                    flush=True,
                )
            if writer is not None:
                writer.add_scalars(e, {"dcgan/d_loss": d_avg, "dcgan/g_loss": g_avg})
                writer.add_image(e, "dcgan/samples", sample_grid(g_ckpt.generator, fixed_z))
                writer.flush()
            accum.reset()
    finally:
        if writer is not None:
            writer.close()
    metrics.join_fit()
    return holder["state"], g_ckpt.generator, writer.path if writer else None


if __name__ == "__main__":
    main()
