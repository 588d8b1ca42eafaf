"""Model-FLOPs accounting and MFU, the port of ``adaptdl_tpu.flops``.

The matmul-only convention (the PaLM appendix's): 2 FLOPs per
multiply-accumulate, the backward pass at twice the forward, attention
scored causally (half the ``[seq, seq]`` rectangle) when the model is
causal. Rematerialisation's recompute is not model work and is not
counted. MFU is achieved model FLOP/s over the card's peak dense bf16
rate.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# Peak dense bf16 FLOP/s by the card's name (``torch.cuda.
# get_device_name``): NVIDIA's data sheet, H100 SXM, no sparsity.
_PEAK_BF16: tuple[tuple[str, float], ...] = (("H100 80GB HBM3", 989e12),)


def device_peak_flops(device) -> float | None:
    """Peak dense bf16 FLOP/s of a ``torch.device``; None
    for the CPU and any card not in the table."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for needle, peak in _PEAK_BF16:
        if needle in name:
            return peak
    return None


@dataclass(frozen=True)
class FlopsBreakdown:
    """Per-train-step model FLOPs, split for reporting."""

    matmul: float  # projections + FFN + LM head (fwd+bwd)
    attention: float  # QK^T and PV contractions (fwd+bwd)

    @property
    def total(self) -> float:
        return self.matmul + self.attention


def transformer_train_flops(config, batch_size: int, seq_len: int) -> FlopsBreakdown:
    """Model FLOPs of ONE optimizer step (forward + backward) of the
    transformer LM of ``config`` at the given batch and sequence.

    Layernorms, softmax, RoPE and residual adds are ignored. A MoE
    block costs ``top_k`` expert FFNs plus the router per token; the
    capacity padding's slots are not model FLOPs.
    """
    d = config.d_model
    d_ff = config.d_ff
    tokens = batch_size * seq_len

    dense_ffn = 2 * (2 * d * d_ff)  # up + down projections, per token
    moe_every = getattr(config, "moe_every_n", 0) or 0
    num_moe = (
        sum(1 for i in range(1, config.num_layers + 1) if i % moe_every == 0)
        if moe_every
        else 0
    )
    num_dense = config.num_layers - num_moe
    top_k = max(getattr(config, "moe_top_k", 1), 1)
    moe_ffn = top_k * dense_ffn + 2 * d * max(getattr(config, "moe_num_experts", 0), 0)

    proj = 2 * (4 * d * d)  # fused QKV (3 d^2) + output (d^2), per token
    head = 2 * d * config.vocab_size  # LM head, per token
    fwd_matmul = tokens * (
        config.num_layers * proj + num_dense * dense_ffn + num_moe * moe_ffn + head
    )

    # QK^T and PV: each 2*S*d_model FLOPs per token (summed over heads);
    # the causal mask discards half the rectangle.
    attn_per_token = 2 * (2 * seq_len * d)
    if getattr(config, "causal", True):
        attn_per_token /= 2
    fwd_attn = tokens * config.num_layers * attn_per_token

    return FlopsBreakdown(matmul=3.0 * fwd_matmul, attention=3.0 * fwd_attn)


def mfu(
    flops_per_step: float,
    step_time_s: float,
    num_devices: int = 1,
    device=None,
    peak_flops: float | None = None,
) -> float | None:
    """Achieved model FLOPs over the peak; None where the peak is not
    known (the CPU, a card not in the table)."""
    if peak_flops is None:
        if device is None:
            device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        peak_flops = device_peak_flops(device)
    if not peak_flops or step_time_s <= 0:
        return None
    return flops_per_step / (step_time_s * num_devices * peak_flops)
