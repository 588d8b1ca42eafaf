"""adaptdl_tpu_torch: the elastic training framework in PyTorch for CUDA.

The port of ``adaptdl_tpu`` (JAX, TPU) to PyTorch on NVIDIA Hopper. It
imports nothing of the JAX package; the JAX package stays the reference
it is tested against. It covers the elastic data-parallel training path:
``initialize_job`` -> ``data.AdaptiveDataLoader`` ->
``trainer.ElasticTrainer.run_step``, at one replica or at several (one
process each, started by ``python -m adaptdl_tpu_torch.launch``), for the
transformer LM (flash attention as a hand-written sm_90a CUDA kernel,
``ops``) and the model zoo (``models``: ResNet-18, SmallCNN, NeuMF,
DCGAN, the BERT-style MLM encoder) under SGD, Adam or AdamW.
"""

__all__ = ["initialize_job"]


def __getattr__(name):
    # Imported on first use, so the launcher (which only starts the
    # replicas) does not pay for importing torch.
    if name == "initialize_job":
        from adaptdl_tpu_torch.bootstrap import initialize_job

        return initialize_job
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
