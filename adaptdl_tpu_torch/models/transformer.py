"""Decoder-only transformer LM, the port of ``adaptdl_tpu.models.transformer``.

Same architecture and numerics contract as the JAX model: pre-LN
blocks without biases, RoPE positions, a pluggable ``attention_fn``
over ``[batch, heads, seq, head_dim]``, a GELU (tanh) MLP, and a tied
output head through the embedding table. Parameters are float32;
every matrix product and activation runs in ``config.dtype`` (bf16 on
the card), exactly where the flax modules cast, and LayerNorm
statistics are taken in float32. Per-block rematerialisation is
``torch.utils.checkpoint`` (non-reentrant).

Parameter names map one to one onto the flax tree (see
:mod:`adaptdl_tpu_torch.weights`); dense kernels are stored as
``Linear`` weights, ``[out, in]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from adaptdl_tpu_torch.device import resolve_device

NEG_INF = -1e30
LN_EPS = 1e-6  # flax LayerNorm's default


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # attention_fn(q, k, v) -> out over [batch, heads, seq, head_dim];
    # None selects plain attention, causal unless ``causal`` is False.
    attention_fn: Callable | None = None
    # causal=False gives bidirectional (encoder, BERT-style) attention
    # on the plain path; the MLM objective (mlm_loss_fn) needs it.
    causal: bool = True
    # Mixture-of-experts blocks belong to a later slice of the port.
    moe_every_n: int = 0
    moe_num_experts: int = 0

    def __post_init__(self):
        if self.moe_every_n or self.moe_num_experts:
            raise NotImplementedError(
                "mixture-of-experts transformers are not ported yet; "
                "this port runs the dense model only"
            )
        if self.d_model % self.num_heads:
            raise ValueError("d_model must divide by num_heads")


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over the last (head_dim) axis.

    x: [batch, heads, seq, head_dim]; positions: [seq].
    """
    head_dim = x.shape[-1]
    exponent = (
        torch.arange(0, head_dim, 2, device=x.device, dtype=torch.float32)
        / head_dim
    )
    freqs = 1.0 / (10000.0**exponent)
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]
    sin = torch.sin(angles).to(x.dtype)
    cos = torch.cos(angles).to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape)


def causal_attention(q, k, v, causal: bool = True):
    """Plain (dense) attention; q/k/v: [batch, heads, seq, head_dim].
    Logits and softmax in float32, the probabilities cast back to v's
    dtype for the second product."""
    seq_len = q.shape[2]
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(
            (seq_len, seq_len), dtype=torch.bool, device=q.device
        ).tril()
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


class LayerNorm(nn.Module):
    """Flax ``LayerNorm(use_bias=False)``: float32 statistics
    (``var = E[x^2] - E[x]^2``), output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.dtype = dtype

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp(
            x32.square().mean(dim=-1, keepdim=True) - mean.square(), min=0.0
        )
        mul = torch.rsqrt(var + LN_EPS) * self.scale
        return ((x32 - mean) * mul).to(self.dtype)


def _dense(x, weight, dtype):
    return F.linear(x.to(dtype), weight.to(dtype))


class Attention(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.qkv = nn.Linear(config.d_model, 3 * config.d_model, bias=False)
        self.out = nn.Linear(config.d_model, config.d_model, bias=False)

    def forward(self, x, positions):
        cfg = self.config
        batch, seq, _ = x.shape
        head_dim = cfg.d_model // cfg.num_heads
        qkv = _dense(x, self.qkv.weight, cfg.dtype).view(
            batch, seq, 3, cfg.num_heads, head_dim
        )
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))
        q = rope(q, positions)
        k = rope(k, positions)
        if cfg.attention_fn is not None:
            out = cfg.attention_fn(q, k, v)  # [b, h, s, d]
        else:
            out = causal_attention(q, k, v, causal=cfg.causal)
        out = out.transpose(1, 2).reshape(batch, seq, cfg.d_model)
        return _dense(out, self.out.weight, cfg.dtype)


class Block(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.ln1 = LayerNorm(config.d_model, config.dtype)
        self.attention = Attention(config)
        self.ln2 = LayerNorm(config.d_model, config.dtype)
        self.ff_up = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.ff_down = nn.Linear(config.d_ff, config.d_model, bias=False)

    def forward(self, x, positions):
        dtype = self.config.dtype
        x = x + self.attention(self.ln1(x), positions)
        y = _dense(self.ln2(x), self.ff_up.weight, dtype)
        y = F.gelu(y, approximate="tanh")
        return x + _dense(y, self.ff_down.weight, dtype)


class TransformerLM(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.embed = nn.Embedding(config.vocab_size, config.d_model)
        self.layers = nn.ModuleList(
            Block(config) for _ in range(config.num_layers)
        )
        self.ln_f = LayerNorm(config.d_model, config.dtype)

    def forward(self, tokens, return_hidden: bool = False):
        cfg = self.config
        table = self.embed.weight.to(cfg.dtype)
        x = F.embedding(tokens, table)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, positions, use_reentrant=False)
            else:
                x = layer(x, positions)
        x = self.ln_f(x)
        if return_hidden:
            return x
        # Tied output head through the embedding table.
        return torch.matmul(x.to(cfg.dtype), table.t()).float()


def _reset_parameters(model: TransformerLM, generator: torch.Generator):
    """Flax's default initialisers: embedding ~ N(0, 1/d_model); dense
    kernels lecun-normal (truncated at two standard deviations, unit
    fan-in variance); LayerNorm scales one."""
    with torch.no_grad():
        d_model = model.config.d_model
        model.embed.weight.normal_(0.0, d_model**-0.5, generator=generator)
        for module in model.modules():
            if isinstance(module, nn.Linear):
                fan_in = module.weight.shape[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(
                    module.weight, 0.0, std, -2 * std, 2 * std,
                    generator=generator,
                )
            elif isinstance(module, LayerNorm):
                module.scale.fill_(1.0)


def init_transformer(
    config: TransformerConfig, seed: int = 0, device="cuda"
) -> TransformerLM:
    """A freshly initialised model on ``device`` (float32 parameters),
    drawn from a CPU generator seeded with ``seed`` so the weights do
    not depend on the device."""
    device = resolve_device(device)
    model = TransformerLM(config)
    _reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def lm_loss_fn(model: TransformerLM, batch, generator=None) -> torch.Tensor:
    """Next-token cross-entropy, the mean over every position;
    batch = {"tokens": [b, s+1] int}. Draws nothing from
    ``generator``."""
    tokens = batch["tokens"]
    logits = model(tokens[:, :-1])
    return F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long()
    )


def mlm_loss_fn(mask_token: int, mask_rate: float = 0.15) -> Callable:
    """Masked-LM cross-entropy (the BERT-family objective), for a
    ``TransformerConfig(causal=False)`` model: each step masks
    ``mask_rate`` of the tokens, a fresh mask from the microbatch's
    generator, replaces them by ``mask_token`` and scores only the
    masked positions (a mean over them; zero when none is masked).
    batch = {"tokens": [b, s] int}."""

    def loss_fn(model: TransformerLM, batch, generator) -> torch.Tensor:
        tokens = batch["tokens"]
        draws = torch.rand(
            tokens.shape, generator=generator, device=tokens.device
        )
        return masked_lm_loss(model, tokens, draws < mask_rate, mask_token)

    return loss_fn


def masked_lm_loss(model: TransformerLM, tokens, mask, mask_token: int):
    """The MLM loss of ``tokens`` with the positions in ``mask`` (bool,
    the tokens' shape) replaced by ``mask_token``."""
    inputs = torch.where(mask, mask_token, tokens)
    logits = model(inputs)
    losses = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        tokens.reshape(-1).long(),
        reduction="none",
    )
    weights = mask.reshape(-1).float()
    return (losses * weights).sum() / torch.clamp(weights.sum(), min=1.0)
