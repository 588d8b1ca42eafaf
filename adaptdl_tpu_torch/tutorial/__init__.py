"""The adoption path of ``tutorial/mnist_step_1..5.py`` on the port: a
plain PyTorch loop made elastic one step at a time, on the port's
SmallCNN and synthetic 16 x 16 images. Run a step as
``python -m adaptdl_tpu_torch.tutorial.mnist_step_N [--cpu]``."""
