"""Carry the JAX models' parameters into the port.

Each converter takes a flax parameter tree, as nested dicts of numpy
arrays, and returns the ``state_dict`` of the port's model. The layer
rules:

- ``nn.Dense`` kernels are ``[in, out]``; ``Linear`` weights
  ``[out, in]``.
- ``nn.Conv`` kernels are HWIO; ``F.conv2d`` takes OIHW.
- ``nn.ConvTranspose`` kernels ``[kh, kw, in, out]`` are correlated
  unflipped (``transpose_kernel=False``); ``F.conv_transpose2d`` takes
  ``[in, out, kh, kw]`` and correlates flipped, so the kernel is
  flipped in space and transposed.
- ``nn.GroupNorm`` scale and bias and ``nn.Embed`` tables carry over.
- A dense layer fed by an NHWC flatten (SmallCNN, the discriminator)
  has rows in ``(h, w, c)`` order; the port flattens NCHW, ``(c, h,
  w)``, so the rows are permuted. A dense output reshaped NHWC (the
  generator) has its columns, and its bias, permuted the same way.

The transformer's tree maps onto :class:`adaptdl_tpu_torch.models.
TransformerLM` as follows:

================================  ===================================
flax                              port
================================  ===================================
``embed/embedding [V, d]``        ``embed.weight [V, d]``
``LayerNorm_0/scale``             ``ln_f.scale``
``layer_i/LayerNorm_0/scale``     ``layers.i.ln1.scale``
``layer_i/LayerNorm_1/scale``     ``layers.i.ln2.scale``
``layer_i/attention/qkv/kernel``  ``layers.i.attention.qkv.weight``
  ``[d, 3, H, hd]``                 ``[3*H*hd, d]``
``layer_i/attention/out/kernel``  ``layers.i.attention.out.weight``
``layer_i/ff_up/kernel``          ``layers.i.ff_up.weight``
``layer_i/ff_down/kernel``        ``layers.i.ff_down.weight``
``layer_i/moe/router [d, E]``     ``layers.i.moe.router`` (as is)
``layer_i/moe/w_up [E, d, f]``    ``layers.i.moe.w_up`` (as is)
``layer_i/moe/w_down [E, f, d]``  ``layers.i.moe.w_down`` (as is)
================================  ===================================

The pipelined LM (``init_pipeline_lm``) stacks the blocks ``[S, (v,)
lpc, ...]`` under ``blocks``: :func:`flax_pipeline_to_state_dict` gives
the dense LM's names, global layer by global layer, and
:func:`flax_pipeline_to_rank_state_dict` one stage's share of them.

The per-layer ZeRO-3 LM (``init_zero3_lm``) stacks the same blocks
under ``blocks``: :func:`flax_zero3_lm_to_state_dict` maps
``blocks/<Block path> [L, ...]`` onto
:class:`adaptdl_tpu_torch.models.Zero3LMParams`'s ``blocks.<name> [L,
...]`` by the table above, layer by layer. :func:`flat_order_map` relates
the two packages' flat canonical vectors (``ravel_pytree`` order there,
parameter order here), so that flat moments can be compared.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    """float32, except float64 input, which stays exact (the index
    arrays of :func:`flat_order_map`)."""
    a = np.asarray(x)
    return torch.tensor(a if a.dtype == np.float64 else a.astype(np.float32))


def flax_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax ``TransformerLM`` tree."""
    state = {
        "embed.weight": _tensor(params["embed"]["embedding"]),
        "ln_f.scale": _tensor(params["LayerNorm_0"]["scale"]),
    }
    layer = 0
    while f"layer_{layer}" in params:
        p = params[f"layer_{layer}"]
        prefix = f"layers.{layer}."
        qkv = np.asarray(p["attention"]["qkv"]["kernel"])
        state[prefix + "ln1.scale"] = _tensor(p["LayerNorm_0"]["scale"])
        state[prefix + "ln2.scale"] = _tensor(p["LayerNorm_1"]["scale"])
        state[prefix + "attention.qkv.weight"] = _tensor(
            qkv.reshape(qkv.shape[0], -1).T
        )
        state[prefix + "attention.out.weight"] = _tensor(
            np.asarray(p["attention"]["out"]["kernel"]).T
        )
        if "moe" in p:
            for leaf in ("router", "w_up", "w_down"):
                state[prefix + "moe." + leaf] = _tensor(p["moe"][leaf])
        else:
            state[prefix + "ff_up.weight"] = _tensor(
                np.asarray(p["ff_up"]["kernel"]).T
            )
            state[prefix + "ff_down.weight"] = _tensor(
                np.asarray(p["ff_down"]["kernel"]).T
            )
        layer += 1
    return state


def flax_to_rank_state_dict(
    params, model: tuple[int, int] = (0, 1), expert: tuple[int, int] = (0, 1)
) -> dict[str, torch.Tensor]:
    """One rank's shard of a flax ``TransformerLM`` tree (the JAX
    package's full parameters): :func:`flax_to_state_dict`, cut for model
    rank ``model = (index, size)`` and expert rank ``expert = (index,
    size)`` by the port's Megatron and expert table
    (:func:`adaptdl_tpu_torch.parallel.tensor_parallel.shard_state_dict`)."""
    from adaptdl_tpu_torch.parallel.tensor_parallel import shard_state_dict

    return shard_state_dict(flax_to_state_dict(params), model, expert)


def flax_pipeline_to_state_dict(params, num_stages: int, interleave: int = 1) -> dict[str, torch.Tensor]:
    """The dense ``TransformerLM``'s ``state_dict`` for a flax
    ``init_pipeline_lm`` tree: ``embed``, ``ln_f`` and ``blocks`` stacked
    ``[S, lpc, ...]`` (GPipe) or ``[S, v, lpc, ...]`` (interleaved), where
    global layer ``l = (k * S + d) * lpc + i`` sits at ``[d, (k,) i]``."""
    blocks = params["blocks"]
    shape = np.asarray(_first_leaf(blocks)).shape
    lpc = shape[2] if interleave > 1 else shape[1]
    dense = {"embed": params["embed"], "LayerNorm_0": params["ln_f"]}
    for d in range(num_stages):
        for k in range(interleave):
            for i in range(lpc):
                at = (d, k, i) if interleave > 1 else (d, i)
                dense[f"layer_{(k * num_stages + d) * lpc + i}"] = _index(blocks, at)
    return flax_to_state_dict(dense)


def flax_pipeline_to_rank_state_dict(
    params, num_stages: int, interleave: int, stage: int,
    model: tuple[int, int] = (0, 1),
) -> dict[str, torch.Tensor]:
    """Stage ``stage``'s :class:`adaptdl_tpu_torch.models.PipelineLM`
    ``state_dict`` for a flax ``init_pipeline_lm`` tree: the replicated
    leaves and the stage's own layers, cut for model rank ``model =
    (index, size)`` by the Megatron table."""
    from adaptdl_tpu_torch.models.pipeline_lm import stage_layers
    from adaptdl_tpu_torch.parallel.tensor_parallel import shard_state_dict

    full = flax_pipeline_to_state_dict(params, num_stages, interleave)
    num_layers = sum(1 for n in full if n.endswith(".ln1.scale"))
    mine = stage_layers(num_layers, num_stages, interleave, stage)
    keep = {
        n: v for n, v in full.items()
        if not n.startswith("layers.") or int(n.split(".")[1]) in mine
    }
    # PipelineLM's order: the embedding, its layers in visit order, ln_f.
    ordered = {"embed.weight": keep["embed.weight"]}
    for layer in mine:
        prefix = f"layers.{layer}."
        ordered.update((n, v) for n, v in keep.items() if n.startswith(prefix))
    ordered["ln_f.scale"] = keep["ln_f.scale"]
    return shard_state_dict(ordered, model)


def _index(tree, at):
    if isinstance(tree, dict):
        return {k: _index(v, at) for k, v in tree.items()}
    return np.asarray(tree)[at]


def dense(p, prefix: str) -> dict[str, torch.Tensor]:
    """``nn.Dense`` -> ``{prefix}.weight`` (and ``.bias``)."""
    state = {prefix + ".weight": _tensor(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        state[prefix + ".bias"] = _tensor(p["bias"])
    return state


def conv(p, prefix: str) -> dict[str, torch.Tensor]:
    """``nn.Conv`` (HWIO) -> OIHW ``{prefix}.weight`` (and ``.bias``)."""
    state = {
        prefix + ".weight": _tensor(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    }
    if "bias" in p:
        state[prefix + ".bias"] = _tensor(p["bias"])
    return state


def conv_transpose(p, prefix: str) -> dict[str, torch.Tensor]:
    """``nn.ConvTranspose`` ``[kh, kw, in, out]`` -> the flipped
    ``[in, out, kh, kw]`` weight of :class:`~adaptdl_tpu_torch.models.
    layers.ConvTranspose2d`."""
    kernel = np.asarray(p["kernel"])[::-1, ::-1]
    return {prefix + ".weight": _tensor(kernel.transpose(2, 3, 0, 1).copy())}


def group_norm(p, prefix: str) -> dict[str, torch.Tensor]:
    return {prefix + ".scale": _tensor(p["scale"]), prefix + ".bias": _tensor(p["bias"])}


def embed(p, prefix: str) -> dict[str, torch.Tensor]:
    return {prefix + ".weight": _tensor(p["embedding"])}


def dense_after_nhwc_flatten(p, prefix: str, channels: int):
    """A dense layer whose input is an NHWC map flattened: its rows
    permuted from ``(h, w, c)`` to ``(c, h, w)`` order (square maps)."""
    kernel = np.asarray(p["kernel"])
    side = int(round((kernel.shape[0] // channels) ** 0.5))
    rows = kernel.reshape(side, side, channels, -1).transpose(2, 0, 1, 3)
    return dense({"kernel": rows.reshape(kernel.shape), "bias": p["bias"]}, prefix)


def dense_before_nhwc_reshape(p, prefix: str, channels: int):
    """A dense layer whose output is reshaped to an NHWC map: its
    columns and bias permuted from ``(h, w, c)`` to ``(c, h, w)``."""
    kernel = np.asarray(p["kernel"])
    side = int(round((kernel.shape[1] // channels) ** 0.5))
    cols = kernel.reshape(-1, side, side, channels).transpose(0, 3, 1, 2)
    bias = np.asarray(p["bias"]).reshape(side, side, channels).transpose(2, 0, 1)
    return dense(
        {"kernel": cols.reshape(kernel.shape), "bias": bias.reshape(-1)}, prefix
    )


def resnet18_state_dict(params) -> dict[str, torch.Tensor]:
    """The port's ``ResNet18`` state for a flax ``ResNet18`` tree."""
    state = {**conv(params["Conv_0"], "stem"),
             **group_norm(params["GroupNorm_0"], "stem_norm")}
    block = 0
    while f"ResidualBlock_{block}" in params:
        p, prefix = params[f"ResidualBlock_{block}"], f"blocks.{block}."
        state.update(conv(p["Conv_0"], prefix + "conv1"))
        state.update(group_norm(p["GroupNorm_0"], prefix + "norm1"))
        state.update(conv(p["Conv_1"], prefix + "conv2"))
        state.update(group_norm(p["GroupNorm_1"], prefix + "norm2"))
        if "Conv_2" in p:
            state.update(conv(p["Conv_2"], prefix + "proj"))
            state.update(group_norm(p["GroupNorm_2"], prefix + "proj_norm"))
        block += 1
    state.update(dense(params["Dense_0"], "head"))
    return state


def cnn_state_dict(params) -> dict[str, torch.Tensor]:
    """The port's ``SmallCNN`` state for a flax ``SmallCNN`` tree."""
    return {
        **conv(params["Conv_0"], "conv1"),
        **conv(params["Conv_1"], "conv2"),
        **dense_after_nhwc_flatten(params["Dense_0"], "fc1", channels=64),
        **dense(params["Dense_1"], "fc2"),
    }


def ncf_state_dict(params) -> dict[str, torch.Tensor]:
    """The port's ``NeuMF`` state for a flax ``NeuMF`` tree."""
    state = {}
    for name in ("gmf_user", "gmf_item", "mlp_user", "mlp_item"):
        state.update(embed(params[name], name))
    denses = sorted(
        (k for k in params if k.startswith("Dense_")),
        key=lambda k: int(k.split("_")[1]),
    )
    for i, name in enumerate(denses[:-1]):
        state.update(dense(params[name], f"tower.{i}"))
    state.update(dense(params[denses[-1]], "out"))
    return state


def generator_state_dict(params) -> dict[str, torch.Tensor]:
    """The port's DCGAN ``Generator`` state for a flax tree."""
    channels = np.asarray(params["GroupNorm_0"]["scale"]).shape[0]
    state = dense_before_nhwc_reshape(params["Dense_0"], "project", channels)
    for i in range(3):
        state.update(group_norm(params[f"GroupNorm_{i}"], f"norm{i}"))
        state.update(conv_transpose(params[f"ConvTranspose_{i}"], f"up{i + 1}"))
    return state


def discriminator_state_dict(params) -> dict[str, torch.Tensor]:
    """The port's DCGAN ``Discriminator`` state for a flax tree."""
    channels = np.asarray(params["GroupNorm_1"]["scale"]).shape[0]
    state = {}
    for i in range(3):
        state.update(conv(params[f"Conv_{i}"], f"conv{i + 1}"))
    state.update(group_norm(params["GroupNorm_0"], "norm2"))
    state.update(group_norm(params["GroupNorm_1"], "norm3"))
    state.update(dense_after_nhwc_flatten(params["Dense_0"], "out", channels))
    return state


def _unstack(tree, layer: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, layer) for k, v in tree.items()}
    return np.asarray(tree)[layer]


def flax_zero3_lm_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of :class:`Zero3LMParams` for a flax
    ``init_zero3_lm`` tree (``embed``, ``ln_f``, ``blocks`` stacked)."""
    blocks = params["blocks"]
    num_layers = int(np.asarray(_first_leaf(blocks)).shape[0])
    dense = {"embed": params["embed"], "LayerNorm_0": params["ln_f"]}
    for i in range(num_layers):
        dense[f"layer_{i}"] = _unstack(blocks, i)
    per_layer = flax_to_state_dict(dense)
    names = {"embed.weight": None, "ln_f.scale": None}
    stacked = {}
    for name, value in per_layer.items():
        if name in names:
            stacked[name] = value
            continue
        _, index, rest = name.split(".", 2)
        stacked.setdefault("blocks." + rest, [None] * num_layers)[int(index)] = value
    # Zero3LMParams' order: the embedding, a Block's parameters, ln_f.
    out = {"embed.weight": stacked["embed.weight"]}
    for name in _BLOCK_ORDER:
        out["blocks." + name] = torch.stack(stacked["blocks." + name])
    out["ln_f.scale"] = stacked["ln_f.scale"]
    return out


_BLOCK_ORDER = (
    "ln1.scale", "attention.qkv.weight", "attention.out.weight", "ln2.scale",
    "ff_up.weight", "ff_down.weight",
)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


def _flax_leaves(tree, path=()):
    """``(path, array)`` in ``jax.flatten_util.ravel_pytree`` order:
    dict keys sorted, depth first."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flax_leaves(tree[key], path + (key,))
        return out
    return [(path, np.asarray(tree))]


def flat_order_map(params, convert, names) -> np.ndarray:
    """Indices ``perm`` such that the port's flat canonical vector
    (parameters ``names`` in order, raveled) is ``jax_flat[perm]`` for
    the flax tree ``params`` and its ravel_pytree vector ``jax_flat``;
    ``convert`` is the tree's converter to the port's names
    (``flax_to_state_dict``, ``flax_zero3_lm_to_state_dict``)."""
    leaves = _flax_leaves(params)
    index, offset = {}, 0
    for path, leaf in leaves:
        index[path] = np.arange(offset, offset + leaf.size, dtype=np.float64).reshape(leaf.shape)
        offset += leaf.size
    tree: dict = {}
    for path, value in index.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    ported = convert(tree)
    return np.concatenate(
        [ported[n].numpy().reshape(-1) for n in names]
    ).astype(np.int64)
