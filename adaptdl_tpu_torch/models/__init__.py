"""Models of the port: the transformer LM and the model zoo (SmallCNN,
ResNet18, NeuMF, DCGAN), the per-layer ZeRO-3 LM and the pipelined LM, each with an init helper and a loss of the
trainer's ``loss_fn(model, batch, generator)`` form."""

from adaptdl_tpu_torch.models.cnn import SmallCNN, cnn_loss_fn, init_cnn
from adaptdl_tpu_torch.models.dcgan import (
    Discriminator,
    Generator,
    discriminator_loss_fn,
    init_dcgan,
    make_generator_step,
)
from adaptdl_tpu_torch.models.ncf import NeuMF, init_ncf, ncf_loss_fn
from adaptdl_tpu_torch.models.pipeline_lm import (
    PipelineLM,
    init_pipeline_lm,
    pipeline_lm_loss_fn,
)
from adaptdl_tpu_torch.models.resnet import ResNet18, init_resnet18, resnet_loss_fn
from adaptdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    init_transformer,
    lm_loss_fn,
    lm_pair_loss_fn,
    mlm_loss_fn,
)
from adaptdl_tpu_torch.models.zero3_lm import (
    Zero3LMParams,
    init_zero3_lm,
    zero3_lm_loss_fn,
    zero3_lm_metric_fn,
)

__all__ = [
    "Discriminator",
    "Generator",
    "NeuMF",
    "PipelineLM",
    "ResNet18",
    "SmallCNN",
    "TransformerConfig",
    "TransformerLM",
    "Zero3LMParams",
    "cnn_loss_fn",
    "discriminator_loss_fn",
    "init_cnn",
    "init_dcgan",
    "init_ncf",
    "init_pipeline_lm",
    "init_resnet18",
    "init_transformer",
    "init_zero3_lm",
    "lm_loss_fn",
    "lm_pair_loss_fn",
    "make_generator_step",
    "mlm_loss_fn",
    "ncf_loss_fn",
    "pipeline_lm_loss_fn",
    "resnet_loss_fn",
    "zero3_lm_loss_fn",
    "zero3_lm_metric_fn",
]
