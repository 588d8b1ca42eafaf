"""Step 2: initialize_job + ElasticTrainer.

The model now trains data-parallel over the job's replicas, with
gradient averaging, gradient-noise-scale statistics and AdamScale LR
scaling in one step; batches are still cut by hand.

Run:  python -m adaptdl_tpu_torch.tutorial.mnist_step_2 [--cpu]
"""

import argparse

from adaptdl_tpu_torch.examples._data import synthetic_images


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=3)
    args = parser.parse_args(argv)

    import numpy as np

    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import env
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
    state = trainer.init_state()
    data = synthetic_images(2048, 16, 1, 10)
    atomic_bsz = max(64 // trainer.num_replicas, 1)
    step = trainer.train_step(atomic_bsz)
    global_bsz = atomic_bsz * trainer.num_replicas
    rank = env.replica_rank()

    rng = np.random.default_rng(0)
    losses = []
    for epoch in range(args.epochs):
        perm = rng.permutation(2048)
        for start in range(0, 2048 - global_bsz + 1, global_bsz):
            # This replica's block of the global batch.
            idx = perm[start + rank * atomic_bsz : start + (rank + 1) * atomic_bsz]
            batch = trainer.to_device({k: v[idx] for k, v in data.items()})
            state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        print(
            f"epoch {epoch}: loss={losses[-1]:.4f} "
            f"gain={float(metrics['gain']):.2f}"
        )
    return losses


if __name__ == "__main__":
    main()
