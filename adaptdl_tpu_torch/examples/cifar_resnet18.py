"""CIFAR-10-class ResNet-18 with the adaptive batch size (PyTorch port).

The port of ``examples/cifar_resnet18.py``, at its settings off the CPU:
the GroupNorm ResNet-18 at width 64 (about 11 M parameters) with bf16
compute and float32 parameters, ``SGD(0.1, momentum=0.9)`` under
AdaScale (the unpreconditioned gradient-noise statistics), initial batch
128, ``autoscale_batch_size(4096, local_bsz_bounds=(32, 1024),
gradient_accumulation=True)``, 50,000 synthetic 32x32x3 images of 10
classes, and per-epoch loss averages through an ``Accumulator``.

Run on the card:   python -m adaptdl_tpu_torch.examples.cifar_resnet18
On the CPU (tiny): python -m adaptdl_tpu_torch.examples.cifar_resnet18 --cpu --epochs 1
Several replicas:  ADAPTDL_NUM_REPLICAS=2 python -m adaptdl_tpu_torch.launch \\
                       -m adaptdl_tpu_torch.examples.cifar_resnet18
"""

from __future__ import annotations

import argparse

from adaptdl_tpu_torch.examples._data import synthetic_images

INIT_BATCH = 128


def make_trainer(device, cpu: bool, width: int | None = None, seed: int = 0):
    """(trainer, holder, checkpoint state) of a fresh model on
    ``device``; the checkpoint state is not loaded yet."""
    import torch

    from adaptdl_tpu_torch.models import init_resnet18, resnet_loss_fn
    from adaptdl_tpu_torch.optim import SGD
    from adaptdl_tpu_torch.scaling_rules import AdaScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    model = init_resnet18(
        seed=seed, device=device, width=width or (16 if cpu else 64),
        dtype=torch.float32 if cpu else torch.bfloat16,
    )
    trainer = ElasticTrainer(
        resnet_loss_fn, model, SGD(model.parameters(), lr=0.1, momentum=0.9),
        init_batch_size=INIT_BATCH, scaling_rule=AdaScale(), device=device,
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    return trainer, holder, ckpt


def make_loader(cpu: bool):
    from adaptdl_tpu_torch.data import AdaptiveDataLoader

    n = 2048 if cpu else 50000
    loader = AdaptiveDataLoader(synthetic_images(n, 32, 3, 10), batch_size=INIT_BATCH)
    loader.autoscale_batch_size(
        4096, local_bsz_bounds=(32, 1024), gradient_accumulation=True
    )
    return loader


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--width", type=int, default=None)
    args = parser.parse_args(argv)

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import checkpoint, epoch, metrics
    from adaptdl_tpu_torch.accumulator import Accumulator

    device = adaptdl_tpu_torch.initialize_job(device="cpu" if args.cpu else "cuda")
    trainer, holder, ckpt = make_trainer(device, args.cpu, args.width)
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()
    loader = make_loader(args.cpu)
    accum = Accumulator()
    for e in epoch.remaining_epochs_until(args.epochs):
        for batch in loader:
            holder["state"], m = trainer.run_step(holder["state"], batch, loader)
            accum["loss_sum"] += float(m["loss"])
            accum["steps"] += 1
        with accum.synchronized():
            print(
                f"epoch {e}: "
                f"loss={accum['loss_sum'] / max(accum['steps'], 1):.4f} "
                f"batch_size={loader.current_batch_size} "
                f"(atomic={loader.current_atomic_bsz}, "
                f"accum={loader.current_accum_steps})",
                flush=True,
            )
        accum.reset()
    metrics.join_fit()
    return holder["state"]


if __name__ == "__main__":
    main()
