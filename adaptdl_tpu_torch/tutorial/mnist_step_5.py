"""Step 5: the complete elastic program with replay-safe metrics.

Adds the ``Accumulator``, so aggregated statistics (train loss, eval
accuracy) are summed across replicas and replayed exactly across
restarts, and a second loader for evaluation (``shuffle=False``, its
own checkpoint ``name``).

Run:  python -m adaptdl_tpu_torch.tutorial.mnist_step_5 [--cpu]
"""

import argparse

from adaptdl_tpu_torch.examples._data import synthetic_images


def main(argv=None):
    """Trains and evaluates; returns one ``{"epoch", "loss", "acc",
    "batch_size"}`` per epoch this incarnation ran."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=4)
    args = parser.parse_args(argv)

    import torch

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import checkpoint, epoch, metrics
    from adaptdl_tpu_torch.accumulator import Accumulator
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.models import cnn_loss_fn, init_cnn
    from adaptdl_tpu_torch.optim import Adam
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    device = adaptdl_tpu_torch.initialize_job(device="cpu" if args.cpu else "cuda")
    model = init_cnn(device=device, image_size=16, channels=1)
    trainer = ElasticTrainer(
        cnn_loss_fn, model, Adam(model.parameters(), lr=1e-3),
        init_batch_size=64, scaling_rule=AdamScale(), device=device,
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()

    # One draw, split: the JAX tutorial draws its eval set from another
    # seed, whose class templates differ, so its accuracy stays at chance.
    data = synthetic_images(2048 + 512, 16, 1, 10, seed=0)
    train_data = {k: v[:2048] for k, v in data.items()}
    eval_data = {k: v[2048:] for k, v in data.items()}
    loader = AdaptiveDataLoader(train_data, batch_size=64)
    loader.autoscale_batch_size(
        1024, local_bsz_bounds=(32, 128), gradient_accumulation=True
    )
    eval_loader = AdaptiveDataLoader(
        eval_data, batch_size=128, shuffle=False, name="eval-loader"
    )
    accum = Accumulator()

    @torch.no_grad()
    def count_correct(batch):
        logits = model(torch.as_tensor(batch["image"], device=device))
        labels = torch.as_tensor(batch["label"], device=device)
        return int((logits.argmax(-1) == labels).sum())

    history = []
    for e in epoch.remaining_epochs_until(args.epochs):
        for batch in loader:
            holder["state"], m = trainer.run_step(holder["state"], batch, loader)
            accum["train_loss_sum"] += float(m["loss"])
            accum["train_steps"] += 1
        for batch in eval_loader:
            accum["correct"] += count_correct(batch)
            accum["seen"] += len(batch["label"])
        with accum.synchronized():
            history.append({
                "epoch": e,
                "loss": accum["train_loss_sum"] / max(accum["train_steps"], 1),
                "acc": accum["correct"] / max(accum["seen"], 1),
                "batch_size": loader.current_batch_size,
            })
            print(
                f"epoch {e}: loss={history[-1]['loss']:.4f} "
                f"acc={history[-1]['acc']:.3f} "
                f"batch_size={loader.current_batch_size}"
            )
        accum.reset()
    return history


if __name__ == "__main__":
    main()
