"""The port's tensor parallelism (``parallel/tensor_parallel.py``, the
LM's model axis, the trainer's dp x tp step and the canonical
checkpoint across tp) against the JAX package.

The 2-layer, 4-head, d_model 32 LM from the same converted weights
(``weights.py``), float32, inputs and targets aligned on the host:

- The Megatron table: each rank's shards of the full weights
  (``weights.flax_to_rank_state_dict``) put back together give the
  full tensors, and ``qkv``'s shards hold each rank's heads of q, k and
  v (three strided row blocks).
- The sharded model at tp 2 (gloo ranks of ``tests/torch_axes_worker.py``,
  per-block remat on, so the backward re-runs the region collectives):
  the loss and every parameter's gradient, the shards put back together,
  against ``jax.value_and_grad`` of the JAX model. Loss rtol 1e-5,
  gradients rtol 1e-4 and atol 1e-6 of their largest entry.
- The trainer step at dp 2 x tp 2 (four ranks), AdamW(1e-2) + AdamScale +
  the Adam preconditioner, two steps at (4, 0), against the JAX
  ``ElasticTrainer`` with ``transformer_tp_specs`` on a
  ``{"data": 2, "model": 2}`` CPU mesh (``_pcast`` bound to a keyword
  call, ``tests/torch_zero_support.py::bind_pcast``), as
  ``tests/test_tensor_parallel.py`` runs it: loss, gain, LR factor and
  progress rtol 1e-5; the noise statistics rtol 5e-3; parameters rtol
  1e-5, atol 2e-4, and Adam moments rtol 1e-4, atol 1e-4 of their
  largest entry. The split sums each row-parallel product in another
  order than the full product, and Adam's first steps scale a
  rounding-level gradient difference up to a step of about lr, so the
  parameters are held at the atol the JAX package holds its own tp run
  to against the dp one (tests/test_tensor_parallel.py). The
  replicated leaves are bit-equal across each model group, and every
  rank gathers the same full state.
- The checkpoint: written at tp 1 (in this process), resumed at tp 2
  with equal parameters, moments, noise statistics and step, stepped and
  saved there, and resumed at tp 1 again with the tp 2 run's full state.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.parallel.tensor_parallel import transformer_tp_specs as jax_tp_specs
from adaptdl_tpu_torch.parallel import tensor_parallel as tp
from adaptdl_tpu_torch.weights import flax_to_rank_state_dict, flax_to_state_dict
from tests import torch_zero_support as support
from tests.torch_axes_support import (
    INIT_BATCH, assert_state_equal, in_process, jax_config, jax_loss, jax_train,
)
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

WORKER = "tests/torch_axes_worker.py"
STEPS = 2
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_RTOL = 1e-5
TP_PARAM_ATOL = 2e-4
MOMENT_RTOL, MOMENT_ATOL = 1e-4, 1e-4
GNS_RTOL = 5e-3
TRAIN = {"kind": "train", "name": "train", "axes": {"data": 2, "model": 2},
         "init_batch": INIT_BATCH, "atomic": 4, "accum": 0, "steps": STEPS,
         "batches": "lm.npz"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_parallel")
    model, params = jax_init(jax_config(), seq_len=16)
    params = jax.device_get(params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(STEPS + 2, 8, 17), dtype=np.int64)
    batches = {"inputs": tokens[:, :, :-1].copy(), "targets": tokens[:, :, 1:].copy()}
    full = flax_to_state_dict(params)
    for d in ("four", "two"):
        (out / d).mkdir()
        torch.save(full, out / d / "lm.pt")
        np.savez(out / d / "lm.npz", **batches)
    four = [
        {"kind": "grads", "name": "grads", "axes": {"data": 2, "model": 2},
         "batches": "lm.npz"},
        TRAIN,
    ]
    ckpt = {"kind": "train", "init_batch": INIT_BATCH, "atomic": 8, "accum": 0,
            "batches": "lm.npz", "ckpt_dir": "ckpt"}
    saved = in_process(out / "two", {**ckpt, "name": "tp1", "axes": {"data": 1},
                                     "steps": STEPS}, restarts=0)
    two = [{**ckpt, "name": "resume", "axes": {"data": 1, "model": 2}, "first": STEPS,
            "steps": 1}]
    for d, plan in (("four", four), ("two", two)):
        with open(out / d / "plan.json", "w") as f:
            json.dump(plan, f)
    procs = {
        d: support.start_ranks(out / d, "plan", replicas=n, restarts=1, worker=WORKER)
        for d, n in (("four", 4), ("two", 2))
    }
    try:
        loss_fn = jax_loss(model)
        first = {k: jnp.asarray(v[0]) for k, v in batches.items()}
        loss, grads = jax.value_and_grad(loss_fn)(params, first, None)
        reference = {
            "loss": float(loss),
            "grads": flax_to_state_dict(jax.tree.map(np.asarray, grads)),
            "train": jax_train(loss_fn, params, {"data": 2, "model": 2}, jax_tp_specs,
                               batches, STEPS, 4),
        }
    finally:
        for proc in procs.values():
            support.finish(proc)
    port = {
        name: [torch.load(out / d / f"{name}-rank{r}.pt") for r in range(n)]
        for d, n, names in (("four", 4, ("grads", "train")), ("two", 2, ("resume",)))
        for name in names
    }
    back = in_process(out / "two", {**ckpt, "name": "back", "axes": {"data": 1},
                                    "first": STEPS + 1, "steps": 0}, restarts=2)
    return {"jax": reference, "port": port, "full": full, "params": params,
            "saved": saved, "back": back}


def _assemble(ranks, key, tp_ranks=(0, 1)):
    """Every parameter's full tensor from the model ranks' shards of
    ``key`` (a name -> tensor dict per rank)."""
    out = {}
    for name, value in ranks[tp_ranks[0]][key].items():
        spec = tp.transformer_tp_specs(name, value)
        parts = [ranks[r][key][name] for r in tp_ranks]
        out[name] = spec.gather(parts) if spec is not None else value
    return out


@pytest.mark.parametrize("tp_size", [2, 4])
def test_megatron_table_cuts_and_joins(runs, tp_size):
    full, params = runs["full"], runs["params"]
    shards = [flax_to_rank_state_dict(params, model=(r, tp_size)) for r in range(tp_size)]
    for name, value in full.items():
        spec = tp.transformer_tp_specs(name, value)
        if spec is None:
            assert all(torch.equal(s[name], value) for s in shards), name
            continue
        assert torch.equal(spec.gather([s[name] for s in shards]), value), name
    qkv = full["layers.0.attention.qkv.weight"].view(3, 4, 8, 32)
    per = 4 // tp_size
    for r, shard in enumerate(shards):
        local = shard["layers.0.attention.qkv.weight"].view(3, per, 8, 32)
        assert torch.equal(local, qkv[:, r * per : (r + 1) * per]), r


def test_sharded_model_grads_match_jax(runs):
    ranks = runs["port"]["grads"]
    want = runs["jax"]
    np.testing.assert_allclose(float(ranks[0]["loss"]), want["loss"], rtol=LOSS_RTOL)
    got = _assemble(ranks, "grads")
    for name, value in want["grads"].items():
        scale = float(value.abs().max())
        np.testing.assert_allclose(
            got[name].numpy(), value.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
            err_msg=name,
        )
    # The other replica of the dp 2 x tp 2 mesh computes the same shards.
    for r in (2, 3):
        for name, g in ranks[r - 2]["grads"].items():
            assert torch.equal(ranks[r]["grads"][name], g), (r, name)


def test_dp_x_tp_step_matches_jax(runs):
    ranks = runs["port"]["train"]
    want = runs["jax"]["train"]
    assert ranks[0]["mesh"] == {"data": 2, "model": 2}
    support.assert_steps_match(ranks[0]["steps"], want["steps"])
    payload = ranks[0]["logical"]
    for name, value in want["params"].items():
        np.testing.assert_allclose(
            payload["model"][name].numpy(), value.numpy(), rtol=PARAM_RTOL,
            atol=TP_PARAM_ATOL, err_msg=name,
        )
    names = payload["param_names"]
    for key in ("exp_avg", "exp_avg_sq"):
        for i, name in enumerate(names):
            want_m = want[key][name].numpy()
            np.testing.assert_allclose(
                payload["optimizer"]["state"][i][key].numpy(), want_m, rtol=MOMENT_RTOL,
                atol=MOMENT_ATOL * float(np.abs(want_m).max()), err_msg=(key, name),
            )
    var = float(np.abs(want["gns"]["var_biased"]).max())
    for key, value in want["gns"].items():
        np.testing.assert_allclose(
            payload["gns"][key].numpy(), value, rtol=GNS_RTOL,
            atol=1e-5 * var if key == "sqr_biased" else 0, err_msg=key,
        )


def test_ranks_agree_under_tp(runs):
    ranks = runs["port"]["train"]
    # params_tree gives the full tensors; eval_step sums each replica once.
    for rank in ranks:
        for name, value in ranks[0]["logical"]["model"].items():
            assert torch.equal(rank["params_tree"][name], value), name
        assert int(rank["eval"]["rows"]) == 8
        assert torch.equal(rank["eval"]["loss_sum"], ranks[0]["eval"]["loss_sum"])
    # Replicated leaves bit-equal within each model group (and, after
    # the data mean, across the replicas); every rank gathers one state.
    for group in ((0, 1), (2, 3), (0, 2)):
        a, b = (ranks[r]["local"] for r in group)
        for name, value in a.items():
            if tp.transformer_tp_specs(name, value) is None or group == (0, 2):
                assert torch.equal(b[name], value), (group, name)
    for other in ranks[1:]:
        assert_state_equal(other["logical"], ranks[0]["logical"])
    # The local shards really are halves of the full tensors.
    full = ranks[0]["logical"]["model"]
    local = ranks[1]["local"]
    qkv = "layers.0.attention.qkv.weight"
    assert local[qkv].shape[0] * 2 == full[qkv].shape[0]
    assert torch.equal(
        local[qkv], tp.transformer_tp_specs(qkv, full[qkv]).shard(full[qkv], 1, 2)
    )


def test_checkpoint_moves_between_tp1_and_tp2(runs):
    saved, back = runs["saved"], runs["back"]
    assert not saved["restored"] and saved["step"] == STEPS
    resumed = runs["port"]["resume"]
    for rank in resumed:
        assert rank["restored"] and rank["resumed_step"] == STEPS
        assert rank["mesh"] == {"data": 1, "model": 2}
        assert_state_equal(rank["resumed"], saved["logical"])
        assert rank["step"] == STEPS + 1
    assert back["restored"] and back["resumed_step"] == STEPS + 1
    assert_state_equal(back["resumed"], resumed[0]["logical"])
