"""Step 1: a plain, non-elastic PyTorch training script.

The starting point of the adoption path: an ordinary training loop with
``torch.optim.Adam`` and nothing from the elastic framework yet. Steps
2-5 convert it incrementally.

Run:  python -m adaptdl_tpu_torch.tutorial.mnist_step_1 [--cpu]
"""

import argparse

from adaptdl_tpu_torch.examples._data import synthetic_images


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=3)
    args = parser.parse_args(argv)

    import torch

    from adaptdl_tpu_torch.models import cnn_loss_fn, init_cnn

    device = torch.device("cpu" if args.cpu else "cuda")
    model = init_cnn(device=device, image_size=16, channels=1)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    data = synthetic_images(2048, 16, 1, 10)
    generator = torch.Generator(device=device).manual_seed(0)
    losses = []
    for epoch in range(args.epochs):
        for start in range(0, 2048, 64):
            batch = {
                k: torch.as_tensor(v[start : start + 64], device=device)
                for k, v in data.items()
            }
            loss = cnn_loss_fn(model, batch, generator)
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
        losses.append(loss.item())
        print(f"epoch {epoch}: loss={losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
