"""Shared set-up of the port's model-axis, expert-axis and seq x ZeRO
tests (``tests/test_torch_tensor_parallel.py``,
``test_torch_expert_parallel.py``, ``test_torch_seq_zero.py``): the JAX
trainer on a sharded CPU mesh under AdamW(1e-2) + AdamScale + the Adam
preconditioner (``_pcast`` bound to a keyword call), the port's one-rank
run in the test process, and the exact comparison of two full logical
checkpoint payloads."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.parallel import create_mesh as jax_mesh
from adaptdl_tpu.scaling_rules import AdamScale as JaxAdamScale
from adaptdl_tpu_torch import checkpoint, metrics
from adaptdl_tpu_torch.parallel import mesh as pmesh
from adaptdl_tpu_torch.weights import flax_to_state_dict
from tests import torch_axes_worker as worker
from tests import torch_zero_support as support

INIT_BATCH = 8


def jax_config(**kw):
    return JaxConfig(**worker.LM_SIZES, max_seq_len=16, dtype=jnp.float32, remat=False, **kw)


def jax_loss(model):
    from adaptdl_tpu.models.transformer import apply_with_moe_aux

    def loss(p, batch, rng):
        logits, aux = apply_with_moe_aux(model, p, batch["inputs"], rng)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["targets"]
        ).mean() + aux

    return loss


def jax_train(loss_fn, params, axes, sharding_fn, batches, steps, atomic, **mode):
    """The JAX ElasticTrainer under AdamW(1e-2) + AdamScale + the Adam
    preconditioner on ``axes``: per-step metrics, the parameter tree and
    Adam's moments as port state dicts, the noise statistics."""
    from adaptdl_tpu.trainer import ElasticTrainer as JaxTrainer
    from adaptdl_tpu.trainer import _find_adam_nu

    devices = int(np.prod(list(axes.values())))
    patch = support.bind_pcast()
    try:
        patch.setenv("ADAPTDL_NUM_REPLICAS", str(axes["data"]))
        trainer = JaxTrainer(
            loss_fn, params, optax.adamw(1e-2), INIT_BATCH, scaling_rule=JaxAdamScale(),
            precondition="adam", mesh=jax_mesh(axes, devices=jax.devices()[:devices]),
            param_sharding_fn=sharding_fn, **mode,
        )
        state = trainer.init_state()
        step = trainer.train_step(atomic, 0)
        metrics_ = []
        for i in range(steps):
            batch = {k: v[i] for k, v in batches.items()}
            state, m = step(state, trainer.shard_batch(batch))
            metrics_.append({k: float(v) for k, v in m.items()})
        opt = jax.tree.map(np.asarray, state.opt_state)

        def find_mu(node):
            if isinstance(node, optax.ScaleByAdamState):
                return node.mu
            if isinstance(node, tuple):
                for child in node:
                    found = find_mu(child)
                    if found is not None:
                        return found
            return None

        return {
            "steps": metrics_,
            "params": flax_to_state_dict(jax.tree.map(np.asarray, trainer.params_tree(state))),
            "exp_avg": flax_to_state_dict(find_mu(opt)),
            "exp_avg_sq": flax_to_state_dict(_find_adam_nu(opt)),
            "gns": {k: np.asarray(getattr(state.gns, k)) for k in
                    ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias")},
        }
    finally:
        patch.undo()


def in_process(out, task, restarts):
    """``worker.train`` at one rank in this process (no process group)."""
    with pytest.MonkeyPatch.context() as patch:
        for key in ("ADAPTDL_NUM_PROCESSES", "ADAPTDL_SEQ_SHARDS", "ADAPTDL_MODEL_SHARDS",
                    "ADAPTDL_EXPERT_SHARDS", "ADAPTDL_NUM_REPLICAS"):
            patch.delenv(key, raising=False)
        patch.setenv("ADAPTDL_NUM_RESTARTS", str(restarts))
        checkpoint._reset_registry()
        metrics._reset_state()
        try:
            return worker.train(task, str(out), 0)
        finally:
            checkpoint._reset_registry()
            metrics._reset_state()
            pmesh._reset()


def _tensors(node, path=()):
    """(path, tensor) of every tensor in a payload, in a fixed order."""
    if isinstance(node, torch.Tensor):
        return [(path, node)]
    if isinstance(node, dict):
        return [x for k in node for x in _tensors(node[k], path + (k,))]
    if isinstance(node, (list, tuple)):
        return [x for i, v in enumerate(node) for x in _tensors(v, path + (i,))]
    return []


def assert_state_equal(got, want):
    """Two full logical payloads bit for bit: every tensor (parameters,
    moments, noise statistics, the carry, the step)."""
    got, want = _tensors(got), _tensors(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), path
