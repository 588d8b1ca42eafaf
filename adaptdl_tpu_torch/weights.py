"""Carry the JAX transformer's parameters into the port.

The flax parameter tree, as nested dicts of numpy arrays, becomes the
``state_dict`` of :class:`adaptdl_tpu_torch.models.TransformerLM`:

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
================================  ===================================

Flax dense kernels are ``[in, out]``; ``Linear`` weights ``[out, in]``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


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
        state[prefix + "ff_up.weight"] = _tensor(
            np.asarray(p["ff_up"]["kernel"]).T
        )
        state[prefix + "ff_down.weight"] = _tensor(
            np.asarray(p["ff_down"]["kernel"]).T
        )
        layer += 1
    return state
