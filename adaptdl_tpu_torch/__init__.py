"""adaptdl_tpu_torch: the elastic training framework in PyTorch for CUDA.

The port of ``adaptdl_tpu`` (JAX, TPU) to PyTorch on NVIDIA Hopper. It
imports nothing of the JAX package; the JAX package stays the reference
it is tested against. This slice covers the elastic data-parallel
training path of the transformer LM: ``initialize_job`` ->
``data.AdaptiveDataLoader`` -> ``trainer.ElasticTrainer.run_step``, with
flash attention as a hand-written sm_90a CUDA kernel (``ops``).
"""

from adaptdl_tpu_torch.bootstrap import initialize_job

__all__ = ["initialize_job"]
