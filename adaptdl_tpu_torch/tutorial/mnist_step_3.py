"""Step 3: AdaptiveDataLoader, elastic and checkpoint-restart-safe input.

The loader partitions each epoch across replicas, checkpoints its
position, resumes mid-epoch after a rescale, and exits gracefully (143)
when the scheduler stops the job.

Run:  python -m adaptdl_tpu_torch.tutorial.mnist_step_3 [--cpu]
"""

import argparse

from adaptdl_tpu_torch.examples._data import synthetic_images


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=3)
    args = parser.parse_args(argv)

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import checkpoint
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

    loader = AdaptiveDataLoader(synthetic_images(2048, 16, 1, 10), batch_size=64)
    losses = []
    for epoch in range(args.epochs):
        for batch in loader:
            holder["state"], metrics = trainer.run_step(
                holder["state"], batch, loader
            )
        losses.append(float(metrics["loss"]))
        print(f"epoch {epoch}: loss={losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
