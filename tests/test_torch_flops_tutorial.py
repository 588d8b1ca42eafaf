"""The port's ``flops`` against the JAX package's, and its tutorial.

``transformer_train_flops`` counts what the JAX one counts (exactly: the
same integer arithmetic) for the dense LM, the MoE LM and the encoder;
``device_peak_flops`` knows no peak off the card and ``mfu`` is None
there. Each tutorial step runs end to end on the CPU for one epoch;
step 5 also restarts from its checkpoint with both loaders restored.
"""

import numpy as np
import pytest
import torch

from adaptdl_tpu import flops as jflops
from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu_torch import _signal, checkpoint, epoch, flops, metrics
from adaptdl_tpu_torch.models import TransformerConfig
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401



@pytest.fixture(autouse=True)
def _port_state():
    def reset():
        metrics.join_fit()
        checkpoint._reset_registry()
        metrics._reset_state()
        epoch._reset_state()
        _signal.set_exit_flag(False)

    reset()
    yield
    reset()


@pytest.mark.parametrize(
    "config",
    [
        {},
        dict(moe_every_n=2, moe_num_experts=8, moe_top_k=2),
        dict(moe_every_n=1, moe_num_experts=4, moe_top_k=1, causal=False),
        dict(num_layers=3, d_model=64, num_heads=4, d_ff=96, vocab_size=500),
    ],
)
@pytest.mark.parametrize("batch, seq", [(32, 512), (3, 17)])
def test_transformer_train_flops_match_jax(config, batch, seq):
    router = {"moe_router": "experts"} if not config.get("causal", True) else {}
    got = flops.transformer_train_flops(TransformerConfig(**config, **router), batch, seq)
    want = jflops.transformer_train_flops(JaxConfig(**config, **router), batch, seq)
    assert (got.matmul, got.attention, got.total) == (want.matmul, want.attention, want.total)


def test_moe_counts_top_k_experts_and_the_router():
    dense = flops.transformer_train_flops(TransformerConfig(), 32, 512)
    moe = flops.transformer_train_flops(
        TransformerConfig(moe_every_n=2, moe_num_experts=8, moe_top_k=2), 32, 512
    )
    tokens, d, f = 32 * 512, 768, 3072
    # 6 MoE blocks each run a second expert FFN and a [d, 8] router.
    extra = 3 * tokens * 6 * (2 * 2 * d * f + 2 * d * 8)
    assert moe.matmul - dense.matmul == extra
    assert moe.attention == dense.attention


def test_peak_and_mfu_off_the_card(monkeypatch):
    assert flops.device_peak_flops(torch.device("cpu")) is None
    assert flops.device_peak_flops("cpu") is None
    assert flops.mfu(1e12, 1.0, device=torch.device("cpu")) is None
    assert flops.mfu(1e12, 0.5, peak_flops=4e12) == 0.5
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.device_peak_flops(torch.device("cuda")) == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert flops.device_peak_flops(torch.device("cuda")) is None


@pytest.mark.parametrize("step", [1, 2, 3, 4])
def test_tutorial_step_runs_on_the_cpu(step, tmp_path, monkeypatch):
    import importlib

    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    module = importlib.import_module(f"adaptdl_tpu_torch.tutorial.mnist_step_{step}")
    losses = module.main(["--cpu", "--epochs", "1"])
    assert len(losses) == 1 and np.isfinite(losses[0]) and losses[0] < np.log(10)


def test_tutorial_step_5_trains_evaluates_and_restarts(tmp_path, monkeypatch):
    from adaptdl_tpu_torch.tutorial import mnist_step_5

    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    first = mnist_step_5.main(["--cpu", "--epochs", "1"])
    assert [h["epoch"] for h in first] == [0]
    assert first[0]["acc"] > 0.5 and np.isfinite(first[0]["loss"])
    checkpoint.save_all_states()
    metrics.join_fit()
    checkpoint._reset_registry()
    metrics._reset_state()
    epoch._reset_state()
    monkeypatch.setenv("ADAPTDL_NUM_RESTARTS", "1")
    second = mnist_step_5.main(["--cpu", "--epochs", "2"])
    # The restart resumes at epoch 1: epoch 0's loops do not replay.
    assert [h["epoch"] for h in second] == [1]
    assert second[0]["acc"] > 0.5
