"""Step 4: adaptive batch size + replay-safe epochs.

``autoscale_batch_size`` hands the global batch size (and gradient
accumulation) to the goodput model; ``remaining_epochs_until`` makes the
epoch loop resume at the interrupted epoch after a restart.

Run:  python -m adaptdl_tpu_torch.tutorial.mnist_step_4 [--cpu]
"""

import argparse

from adaptdl_tpu_torch.examples._data import synthetic_images


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=4)
    args = parser.parse_args(argv)

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import checkpoint, epoch, metrics
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

    loader = AdaptiveDataLoader(synthetic_images(2048, 16, 1, 10), batch_size=64)
    loader.autoscale_batch_size(
        1024, local_bsz_bounds=(32, 128), gradient_accumulation=True
    )
    losses = []
    for e in epoch.remaining_epochs_until(args.epochs):
        for batch in loader:
            holder["state"], m = trainer.run_step(holder["state"], batch, loader)
        losses.append(float(m["loss"]))
        print(
            f"epoch {e}: loss={losses[-1]:.4f} "
            f"batch_size={loader.current_batch_size}"
        )
    return losses


if __name__ == "__main__":
    main()
