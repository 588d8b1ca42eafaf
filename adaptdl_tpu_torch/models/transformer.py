"""Decoder-only transformer LM, the port of ``adaptdl_tpu.models.transformer``.

Same architecture and numerics contract as the JAX model: pre-LN
blocks without biases, RoPE positions, a pluggable ``attention_fn``
over ``[batch, heads, seq, head_dim]``, a GELU (tanh) MLP, and a tied
output head through the embedding table. Parameters are float32;
every matrix product and activation runs in ``config.dtype`` (bf16 on
the card), exactly where the flax modules cast, and LayerNorm
statistics are taken in float32. Per-block rematerialisation is
``torch.utils.checkpoint`` (non-reentrant), selective under a
``remat_policy`` (:data:`REMAT_POLICIES`).

Mixture-of-experts: every ``moe_every_n``-th block replaces its dense
FFN with :class:`MoEFFN` (:mod:`adaptdl_tpu_torch.models.moe`: one
expert shard, or with ``moe_axis`` the experts split over that axis of
the process mesh, ``switch_moe``); :func:`apply_with_moe_aux` returns
the weighted load-balancing loss beside the output, and both losses add
it.

Tensor parallelism: with ``model_axis`` set, each rank of that axis
holds its shard of the Megatron split
(:mod:`adaptdl_tpu_torch.parallel.tensor_parallel`): ``num_heads / tp``
heads of the attention and ``d_ff / tp`` columns of the FFN, the model
group's sums at the region boundaries. The ``attention_fn`` (the flash
kernel under ``--flash``) runs unchanged on the local heads.
:func:`init_transformer` draws the full weights from its seed and keeps
this rank's shards, so a seed gives one logical model at any tp or ep.

Sequence parallelism: with ``seq_axis`` set, each rank of that axis of
the process mesh (:mod:`adaptdl_tpu_torch.parallel.mesh`) holds one
contiguous block of every sequence; RoPE takes global positions and,
with no ``attention_fn``, attention runs over the axis as
``seq_attention`` says: ``"ring"`` (:mod:`..parallel.ring_attention`) or
``"ulysses"`` (:mod:`..parallel.ulysses`).

Parameter names map one to one onto the flax tree (see
:mod:`adaptdl_tpu_torch.weights`); dense kernels are stored as
``Linear`` weights, ``[out, in]``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from adaptdl_tpu_torch import collective
from adaptdl_tpu_torch.device import resolve_device
from adaptdl_tpu_torch.models.moe import dense_switch_moe, switch_moe
from adaptdl_tpu_torch.parallel.tensor_parallel import copy_in, reduce_out, shard_transformer

NEG_INF = -1e30
LN_EPS = 1e-6  # flax LayerNorm's default

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default)
_NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default)
# The jax.checkpoint_policies names the JAX model takes, and the ops
# whose outputs each saves for the backward (the rest is recomputed):
# None saves everything (no remat at all), () nothing (full-block remat).
# The flash forward kernel runs outside the dispatcher, so every policy
# that recomputes a block launches it again.
REMAT_POLICIES = {
    "everything_saveable": None,
    "nothing_saveable": (),
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
    "checkpoint_dots_with_no_batch_dims": _NO_BATCH_DOTS,
}


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # A jax.checkpoint_policies name (REMAT_POLICIES); None recomputes
    # the whole block, as "nothing_saveable".
    remat_policy: str | None = None
    # attention_fn(q, k, v) -> out over [batch, heads, seq, head_dim];
    # None selects plain attention, causal unless ``causal`` is False,
    # or under ``seq_axis`` the ``seq_attention`` mode.
    attention_fn: Callable | None = None
    # The process-mesh axis the sequence is sharded over (None: not
    # sharded), and how attention crosses it: "ring" or "ulysses".
    seq_axis: str | None = None
    seq_attention: str = "ring"
    # causal=False gives bidirectional (encoder, BERT-style) attention
    # on the plain path; the MLM objective (mlm_loss_fn) needs it.
    causal: bool = True
    # Mixture-of-experts: every ``moe_every_n``-th block (1-indexed; 0
    # disables) runs a Switch/GShard MoE of ``moe_num_experts`` experts
    # in place of its dense FFN, on this device (no expert sharding).
    # The losses add ``moe_aux_weight`` times the blocks' load-balancing
    # losses.
    moe_every_n: int = 0
    moe_num_experts: int = 0
    moe_capacity_factor: float = 2.0
    moe_top_k: int = 1
    moe_aux_weight: float = 1e-2
    # "tokens" (token choice) or "experts" (expert choice: every expert
    # ranks the whole token slice, so not causally valid).
    moe_router: str = "tokens"
    # Bin the tokens as this many expert-parallel devices would.
    moe_dense_slices: int = 1
    # The process-mesh axis the experts are split over (None: every
    # expert on this rank), and the one the Megatron split runs over
    # (None: no tensor parallelism).
    moe_axis: str | None = None
    model_axis: str | None = None

    def __post_init__(self):
        if self.d_model % self.num_heads:
            raise ValueError("d_model must divide by num_heads")
        if self.use_moe and self.moe_router == "experts" and self.causal:
            # Expert choice ranks across the whole slice: a token's
            # routing would depend on later tokens.
            raise ValueError(
                "moe_router='experts' is not causally valid with "
                "causal=True (expert-choice gating sees future tokens); "
                "use causal=False (encoder/MLM) or moe_router='tokens'"
            )
        if self.seq_attention not in ("ring", "ulysses"):
            raise ValueError(
                "seq_attention must be 'ring' or 'ulysses', "
                f"got {self.seq_attention!r}"
            )
        if self.remat_policy is not None and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; valid "
                f"names: {sorted(REMAT_POLICIES)}"
            )

    @property
    def use_moe(self) -> bool:
        return self.moe_every_n > 0 and self.moe_num_experts > 0

    def moe_block(self, layer: int) -> bool:
        """Whether block ``layer`` (0-indexed) is a MoE block."""
        return self.use_moe and (layer + 1) % self.moe_every_n == 0


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


def _axis_group(axis: str | None):
    """The process group of this rank's row of ``axis`` (SOLO for none)."""
    if axis is None:
        return collective.SOLO
    from adaptdl_tpu_torch.parallel.mesh import axis_group

    return axis_group(axis)


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
        # This rank's heads: all of them, or its model-axis shard.
        heads = self.qkv.weight.shape[0] // (3 * head_dim)
        group = _axis_group(cfg.model_axis)
        qkv = _dense(copy_in(x, group), self.qkv.weight, cfg.dtype).view(
            batch, seq, 3, heads, head_dim
        )
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))
        q = rope(q, positions)
        k = rope(k, positions)
        if cfg.attention_fn is not None:
            out = cfg.attention_fn(q, k, v)  # [b, h, s, d]
        elif cfg.seq_axis is None:
            out = causal_attention(q, k, v, causal=cfg.causal)
        elif cfg.seq_attention == "ulysses":
            from adaptdl_tpu_torch.parallel.ulysses import ulysses_attention

            out = ulysses_attention(q, k, v, cfg.seq_axis, causal=cfg.causal)
        else:
            from adaptdl_tpu_torch.parallel.ring_attention import ring_attention

            out = ring_attention(q, k, v, cfg.seq_axis, causal=cfg.causal)
        out = out.transpose(1, 2).reshape(batch, seq, heads * head_dim)
        return reduce_out(_dense(out, self.out.weight, cfg.dtype), group)


class MoEFFN(nn.Module):
    """Switch/GShard FFN over expert-stacked float32 parameters:
    ``router [d, E]``, ``w_up [E, d, f]``, ``w_down [E, f, d]`` (this
    rank's ``[E/ep, ...]`` once sharded over ``moe_axis``). Returns
    ``(out in config.dtype, aux)``."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        e, d, f = config.moe_num_experts, config.d_model, config.d_ff
        self.router = nn.Parameter(torch.empty(d, e))
        self.w_up = nn.Parameter(torch.empty(e, d, f))
        self.w_down = nn.Parameter(torch.empty(e, f, d))

    def forward(self, x):
        cfg = self.config
        if cfg.moe_axis is not None:
            out, aux = switch_moe(
                self.router,
                {"w_up": self.w_up, "w_down": self.w_down},
                x.reshape(-1, cfg.d_model),
                _axis_group(cfg.moe_axis),
                capacity_factor=cfg.moe_capacity_factor,
                top_k=cfg.moe_top_k,
                return_aux=True,
                router_type=cfg.moe_router,
            )
            return out.reshape(x.shape).to(cfg.dtype), aux
        out, aux = dense_switch_moe(
            self.router,
            {"w_up": self.w_up, "w_down": self.w_down},
            x.reshape(-1, cfg.d_model),
            num_slices=cfg.moe_dense_slices,
            capacity_factor=cfg.moe_capacity_factor,
            top_k=cfg.moe_top_k,
            return_aux=True,
            router_type=cfg.moe_router,
        )
        return out.reshape(x.shape).to(cfg.dtype), aux


class Block(nn.Module):
    """A pre-LN block; ``forward`` returns ``(x, aux)``, aux None for a
    dense FFN."""

    def __init__(self, config: TransformerConfig, use_moe: bool = False):
        super().__init__()
        self.config = config
        self.ln1 = LayerNorm(config.d_model, config.dtype)
        self.attention = Attention(config)
        self.ln2 = LayerNorm(config.d_model, config.dtype)
        if use_moe:
            self.moe = MoEFFN(config)
        else:
            self.ff_up = nn.Linear(config.d_model, config.d_ff, bias=False)
            self.ff_down = nn.Linear(config.d_ff, config.d_model, bias=False)

    def forward(self, x, positions):
        dtype = self.config.dtype
        x = x + self.attention(self.ln1(x), positions)
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln2(x))
            return x + y, aux
        group = _axis_group(self.config.model_axis)
        y = _dense(copy_in(self.ln2(x), group), self.ff_up.weight, dtype)
        y = F.gelu(y, approximate="tanh")
        return x + reduce_out(_dense(y, self.ff_down.weight, dtype), group), None


def apply_block(config: TransformerConfig, layer: Block, x, positions):
    """``layer(x, positions)`` under ``config``'s rematerialisation: the
    whole block recomputed in the backward (``remat``), selectively
    under a ``remat_policy``, or nothing recomputed."""
    saved = REMAT_POLICIES[config.remat_policy or "nothing_saveable"]
    if not (config.remat and torch.is_grad_enabled()) or saved is None:
        return layer(x, positions)
    if not saved:
        return checkpoint(layer, x, positions, use_reentrant=False)
    return checkpoint(
        layer, x, positions, use_reentrant=False,
        context_fn=functools.partial(
            create_selective_checkpoint_contexts, list(saved)
        ),
    )


class TransformerLM(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.embed = nn.Embedding(config.vocab_size, config.d_model)
        self.layers = nn.ModuleList(
            Block(config, config.moe_block(i)) for i in range(config.num_layers)
        )
        self.ln_f = LayerNorm(config.d_model, config.dtype)

    def _block(self, layer, x, positions):
        return apply_block(self.config, layer, x, positions)

    def forward(self, tokens, return_hidden: bool = False, return_aux: bool = False):
        """Logits ``[b, s, vocab]`` (float32), or the final hidden states
        in ``config.dtype`` with ``return_hidden``; with ``return_aux``,
        ``(that, aux)``: ``moe_aux_weight`` times the sum of the MoE
        blocks' load-balancing losses (0 for a dense model)."""
        cfg = self.config
        table = self.embed.weight.to(cfg.dtype)
        x = F.embedding(tokens, table)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        if cfg.seq_axis is not None:
            # This rank holds block ``seq_index`` of the global sequence:
            # RoPE and the causal masks need global positions.
            from adaptdl_tpu_torch.parallel.mesh import axis_index

            positions = positions + axis_index(cfg.seq_axis) * tokens.shape[1]
        auxes = []
        for layer in self.layers:
            x, aux = self._block(layer, x, positions)
            if aux is not None:
                auxes.append(aux)
        x = self.ln_f(x)
        if return_hidden:
            out = x
        else:
            # Tied output head through the embedding table.
            out = torch.matmul(x.to(cfg.dtype), table.t()).float()
        if not return_aux:
            return out
        if not auxes:
            return out, torch.zeros((), device=x.device)
        return out, cfg.moe_aux_weight * sum(auxes)


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
            elif isinstance(module, MoEFFN):
                module.router.normal_(0.0, 0.02, generator=generator)
                for w in (module.w_up, module.w_down):
                    # flax's variance_scaling fan-in over [E, in, out]
                    # counts the expert axis as receptive field.
                    fan_in = w.shape[0] * w.shape[1]
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(
                        w, 0.0, std, -2 * std, 2 * std, generator=generator
                    )


def init_transformer(
    config: TransformerConfig, seed: int = 0, device="cuda"
) -> TransformerLM:
    """A freshly initialised model on ``device`` (float32 parameters),
    drawn from a CPU generator seeded with ``seed`` so the weights do
    not depend on the device; under ``model_axis`` / ``moe_axis`` this
    rank's shards of them (:func:`shard_for_mesh`)."""
    device = resolve_device(device)
    model = TransformerLM(config)
    _reset_parameters(model, torch.Generator().manual_seed(seed))
    return shard_for_mesh(model).to(device)


def shard_for_mesh(model: TransformerLM) -> TransformerLM:
    """Cut a full model to this rank's shards on the current mesh's
    ``model_axis`` and ``moe_axis`` (in place; the model itself when
    neither is set)."""
    cfg = model.config
    if cfg.model_axis is None and cfg.moe_axis is None:
        return model
    from adaptdl_tpu_torch.parallel.mesh import axis_index, axis_size

    def shard(axis):
        return (0, 1) if axis is None else (axis_index(axis), axis_size(axis))

    tp = shard(cfg.model_axis)[1]
    if cfg.num_heads % tp or cfg.d_ff % tp:
        raise ValueError(
            f"num_heads ({cfg.num_heads}) and d_ff ({cfg.d_ff}) must divide "
            f"by the model shards ({tp})"
        )
    ep = shard(cfg.moe_axis)[1]
    if cfg.use_moe and cfg.moe_num_experts % ep:
        raise ValueError(
            f"{cfg.moe_num_experts} experts cannot shard over {ep} ranks "
            "(each shard owns a whole number of experts)"
        )
    return shard_transformer(model, shard(cfg.model_axis), shard(cfg.moe_axis))


def apply_with_moe_aux(model: TransformerLM, inputs, return_hidden: bool = False):
    """``(logits or hidden states, weighted MoE aux loss)``; the aux is
    0 for a dense model."""
    return model(inputs, return_hidden=return_hidden, return_aux=True)


def lm_loss_fn(model: TransformerLM, batch, generator=None) -> torch.Tensor:
    """Next-token cross-entropy, the mean over every position, plus the
    weighted MoE aux loss; batch = {"tokens": [b, s+1] int}. Draws
    nothing from ``generator``."""
    tokens = batch["tokens"]
    logits, aux = apply_with_moe_aux(model, tokens[:, :-1])
    return F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long()
    ) + aux


def lm_pair_loss_fn(model: TransformerLM, batch, generator=None) -> torch.Tensor:
    """Next-token cross-entropy over inputs and targets aligned on the
    host, the mean over every position, plus the weighted MoE aux loss;
    batch = {"inputs": [b, s] int, "targets": [b, s] int}. The
    sequence-parallel form of :func:`lm_loss_fn`: each rank's block of
    positions carries its own targets, so no shift crosses a block
    boundary. Draws nothing from ``generator``."""
    logits, aux = apply_with_moe_aux(model, batch["inputs"])
    return F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), batch["targets"].reshape(-1).long()
    ) + aux


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
    the tokens' shape) replaced by ``mask_token``, plus the weighted MoE
    aux loss."""
    inputs = torch.where(mask, mask_token, tokens)
    logits, aux = apply_with_moe_aux(model, inputs)
    losses = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        tokens.reshape(-1).long(),
        reduction="none",
    )
    weights = mask.reshape(-1).float()
    return (losses * weights).sum() / torch.clamp(weights.sum(), min=1.0) + aux
