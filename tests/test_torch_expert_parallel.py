"""The port's expert parallelism (``models.moe.switch_moe``, the MoE LM's
expert axis, the trainer's dp x ep step and the canonical checkpoint
across ep) against the JAX package.

- ``switch_moe`` at ep 2 (gloo ranks of ``tests/torch_axes_worker.py``;
  x [32, 8], 4 experts of width 16, token choice top-1 and top-2 and
  expert choice): the output and aux loss against the JAX
  ``switch_moe`` in a ``shard_map`` over two CPU devices, and the
  gradients of ``sum(out * cot) + 3 aux`` with respect to x, the router
  and each rank's experts (put back together) against ``jax.grad`` of
  the JAX ``dense_switch_moe`` at ``num_slices = 2``, the same function.
  Output and aux rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-6
  of their largest entry.
- The MoE LM (2 layers, 4 heads, d_model 32, every second block 4
  experts, top-2) at dp 2 x ep 2 (four ranks): the first microbatch's
  loss and every gradient, router and experts included, against
  ``jax.value_and_grad`` of the dense-equivalent JAX model
  (``moe_dense_slices = 2``), as ``tests/test_moe.py`` holds its expert
  run to the dense one; and two trainer steps under AdamW(1e-2) +
  AdamScale + the Adam preconditioner against the JAX ``ElasticTrainer``
  with ``moe_param_sharding_fn`` on a ``{"data": 2, "expert": 2}`` CPU
  mesh (``_pcast`` bound): loss, gain, LR factor and progress rtol 1e-5;
  the noise statistics rtol 5e-3; parameters rtol 1e-5, atol 2e-4 (the
  JAX package's own bound for its expert run against the dense one is
  atol 1e-5 on a plain SGD toy; Adam's first steps scale a
  rounding-level gradient difference up); Adam moments rtol 1e-4, atol
  1e-4 of their largest entry. Replicated leaves are bit-equal across
  each expert group.
- The checkpoint: written at ep 1 (in this process), resumed at ep 2
  with equal parameters, moments, noise statistics and step, stepped
  and saved there, and resumed at ep 1 again with the ep 2 run's full
  state.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.models.moe import dense_switch_moe as jax_dense_moe
from adaptdl_tpu.models.moe import switch_moe as jax_switch_moe
from adaptdl_tpu.models.transformer import moe_param_sharding_fn
from adaptdl_tpu.parallel import create_mesh as jax_mesh
from adaptdl_tpu_torch.parallel import tensor_parallel as tp
from adaptdl_tpu_torch.weights import flax_to_rank_state_dict, flax_to_state_dict
from tests import torch_zero_support as support
from tests.torch_axes_support import (
    INIT_BATCH, assert_state_equal, in_process, jax_config, jax_loss, jax_train,
)
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

WORKER = "tests/torch_axes_worker.py"
STEPS = 2
D, F, E = 8, 16, 4
ROUTERS = [("top1", "tokens", 1), ("top2", "tokens", 2), ("experts", "experts", 1)]
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-4
MOMENT_RTOL, MOMENT_ATOL = 1e-4, 1e-4
GNS_RTOL = 5e-3
MOE = {"experts": 4, "top_k": 2}


def _moe_data(rng):
    return {
        "x": rng.normal(size=(32, D)).astype(np.float32),
        "router": rng.normal(size=(D, E)).astype(np.float32),
        "w_up": (rng.normal(size=(E, D, F)) * 0.3).astype(np.float32),
        "w_down": (rng.normal(size=(E, F, D)) * 0.3).astype(np.float32),
        "cot": rng.normal(size=(32, D)).astype(np.float32),
    }


def _jax_moe(data, top_k, router_type):
    """The JAX switch_moe over two devices (output, aux) and the dense
    form's gradients."""
    mesh = jax_mesh({"expert": 2}, devices=jax.devices()[:2])
    params = {k: jnp.asarray(data[k]) for k in ("router", "w_up", "w_down")}
    x = jnp.asarray(data["x"])
    out, aux = shard_map(
        lambda p, xx: jax_switch_moe(
            p, xx, top_k=top_k, return_aux=True, router_type=router_type
        ),
        mesh=mesh,
        in_specs=({"router": P(), "w_up": P("expert"), "w_down": P("expert")}, P()),
        out_specs=(P(), P()),
    )(params, x)

    def total(x, router, w_up, w_down):
        o, a = jax_dense_moe(
            router, {"w_up": w_up, "w_down": w_down}, x, num_slices=2,
            top_k=top_k, return_aux=True, router_type=router_type,
        )
        return (o * data["cot"]).sum() + 3.0 * a

    grads = jax.grad(total, argnums=(0, 1, 2, 3))(
        x, params["router"], params["w_up"], params["w_down"]
    )
    return {"out": np.asarray(out), "aux": float(aux),
            "grads": dict(zip(("x", "router", "w_up", "w_down"), map(np.asarray, grads)))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("expert_parallel")
    rng = np.random.default_rng(0)
    moe_data = _moe_data(rng)
    model, params = jax_init(jax_config(moe_every_n=2, moe_num_experts=4, moe_top_k=2),
                             seq_len=16)
    params = jax.device_get(params)
    tokens = rng.integers(0, 64, size=(STEPS + 2, 8, 17), dtype=np.int64)
    batches = {"inputs": tokens[:, :, :-1].copy(), "targets": tokens[:, :, 1:].copy()}
    full = flax_to_state_dict(params)
    for d in ("four", "two"):
        (out / d).mkdir()
        torch.save(full, out / d / "lm.pt")
        np.savez(out / d / "lm.npz", **batches)
    np.savez(out / "four" / "moe.npz", **moe_data)
    axes = {"data": 2, "expert": 2}
    four = [
        {"kind": "moe", "name": f"moe-{name}", "axes": axes, "file": "moe.npz",
         "router": router, "top_k": k}
        for name, router, k in ROUTERS
    ] + [
        {"kind": "grads", "name": "grads", "axes": axes, "batches": "lm.npz", **MOE},
        {"kind": "train", "name": "train", "axes": axes, "init_batch": INIT_BATCH,
         "atomic": 4, "accum": 0, "steps": STEPS, "batches": "lm.npz", **MOE},
    ]
    ckpt = {"kind": "train", "init_batch": INIT_BATCH, "atomic": 8, "accum": 0,
            "batches": "lm.npz", "ckpt_dir": "ckpt", **MOE}
    saved = in_process(out / "two", {**ckpt, "name": "ep1", "axes": {"data": 1},
                                     "steps": STEPS}, restarts=0)
    two = [{**ckpt, "name": "resume", "axes": {"data": 1, "expert": 2}, "first": STEPS,
            "steps": 1}]
    for d, plan in (("four", four), ("two", two)):
        with open(out / d / "plan.json", "w") as f:
            json.dump(plan, f)
    procs = {
        d: support.start_ranks(out / d, "plan", replicas=n, restarts=1, worker=WORKER)
        for d, n in (("four", 4), ("two", 2))
    }
    try:
        reference = {
            name: _jax_moe(moe_data, k, router) for name, router, k in ROUTERS
        }
        dense_model, _ = jax_init(
            jax_config(moe_every_n=2, moe_num_experts=4, moe_top_k=2, moe_dense_slices=2),
            seq_len=16,
        )
        first = {k: jnp.asarray(v[0]) for k, v in batches.items()}
        loss, grads = jax.value_and_grad(jax_loss(dense_model))(params, first, None)
        reference["lm"] = {
            "loss": float(loss),
            "grads": flax_to_state_dict(jax.tree.map(np.asarray, grads)),
        }
        ep_model, _ = jax_init(
            jax_config(moe_every_n=2, moe_num_experts=4, moe_top_k=2, moe_axis="expert"),
            seq_len=16,
        )
        reference["train"] = jax_train(
            jax_loss(ep_model), params, axes, moe_param_sharding_fn, batches, STEPS, 4
        )
    finally:
        for proc in procs.values():
            support.finish(proc)
    names = [f"moe-{name}" for name, _, _ in ROUTERS] + ["grads", "train"]
    port = {name: [torch.load(out / "four" / f"{name}-rank{r}.pt") for r in range(4)]
            for name in names}
    port["resume"] = [torch.load(out / "two" / f"resume-rank{r}.pt") for r in range(2)]
    back = in_process(out / "two", {**ckpt, "name": "back", "axes": {"data": 1},
                                    "first": STEPS + 1, "steps": 0}, restarts=2)
    return {"jax": reference, "port": port, "params": params, "full": full,
            "saved": saved, "back": back, "moe_x": moe_data["x"]}


def _close(got, want, rtol, atol_of_max, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol,
        atol=atol_of_max * max(float(np.abs(want).max()), 1e-30), err_msg=what,
    )


def _expert_leaf(name):
    return name.endswith(tp.EXPERT_LEAVES)


def _joined(ranks, key, name, ep_ranks=(0, 1)):
    """A gradient or parameter of the expert group put back together."""
    parts = [ranks[r][key][name] for r in ep_ranks]
    return tp.EXPERT_SPEC.gather(parts) if _expert_leaf(name) else parts[0]


@pytest.mark.parametrize("name", [r[0] for r in ROUTERS])
def test_switch_moe_matches_jax(runs, name):
    ranks = runs["port"][f"moe-{name}"]
    want = runs["jax"][name]
    for rank in ranks:
        np.testing.assert_allclose(rank["out"].numpy(), want["out"], rtol=OUT_RTOL,
                                   atol=OUT_ATOL)
        np.testing.assert_allclose(float(rank["aux"]), want["aux"], rtol=OUT_RTOL,
                                   atol=OUT_ATOL)
    # Routing moved tokens off the pass-through path.
    assert not np.allclose(ranks[0]["out"].numpy(), runs["moe_x"])
    for key in ("x", "router"):
        _close(ranks[0]["grads"][key], want["grads"][key], GRAD_RTOL, GRAD_ATOL, key)
        assert torch.equal(ranks[1]["grads"][key], ranks[0]["grads"][key]), key
    for key in ("w_up", "w_down"):
        joined = torch.cat([ranks[0]["grads"][key], ranks[1]["grads"][key]])
        _close(joined, want["grads"][key], GRAD_RTOL, GRAD_ATOL, key)


def test_expert_parallel_lm_grads_match_dense_jax(runs):
    ranks = runs["port"]["grads"]
    want = runs["jax"]["lm"]
    np.testing.assert_allclose(float(ranks[0]["loss"]), want["loss"], rtol=LOSS_RTOL)
    for name, value in want["grads"].items():
        _close(_joined(ranks, "grads", name), value.numpy(), GRAD_RTOL, GRAD_ATOL, name)
    router = "layers.1.moe.router"
    assert float(ranks[0]["grads"][router].abs().max()) > 0
    for r in (1, 2, 3):
        for name, g in ranks[0]["grads"].items():
            if not _expert_leaf(name):
                assert torch.equal(ranks[r]["grads"][name], g), (r, name)


def test_dp_x_ep_step_matches_jax(runs):
    ranks = runs["port"]["train"]
    want = runs["jax"]["train"]
    assert ranks[0]["mesh"] == {"data": 2, "expert": 2}
    support.assert_steps_match(ranks[0]["steps"], want["steps"])
    payload = ranks[0]["logical"]
    for name, value in want["params"].items():
        np.testing.assert_allclose(
            payload["model"][name].numpy(), value.numpy(), rtol=PARAM_RTOL,
            atol=PARAM_ATOL, err_msg=name,
        )
    for key in ("exp_avg", "exp_avg_sq"):
        for i, name in enumerate(payload["param_names"]):
            _close(payload["optimizer"]["state"][i][key], want[key][name].numpy(),
                   MOMENT_RTOL, MOMENT_ATOL, (key, name))
    var = float(np.abs(want["gns"]["var_biased"]).max())
    for key, value in want["gns"].items():
        np.testing.assert_allclose(
            payload["gns"][key].numpy(), value, rtol=GNS_RTOL,
            atol=1e-5 * var if key == "sqr_biased" else 0, err_msg=key,
        )
    # Each expert rank holds 2 of the 4 experts; replicated leaves agree.
    local = ranks[1]["local"]
    w_up = "layers.1.moe.w_up"
    assert local[w_up].shape[0] == 2
    assert torch.equal(local[w_up], payload["model"][w_up][2:])
    for name, value in ranks[0]["local"].items():
        if not _expert_leaf(name):
            assert torch.equal(local[name], value), name
    for other in ranks[1:]:
        assert_state_equal(other["logical"], payload)


def test_rank_shards_of_the_jax_weights(runs):
    params, full = runs["params"], runs["full"]
    shards = [flax_to_rank_state_dict(params, expert=(r, 2)) for r in range(2)]
    for name, value in full.items():
        if not _expert_leaf(name):
            assert all(torch.equal(s[name], value) for s in shards), name
        else:
            assert torch.equal(torch.cat([s[name] for s in shards]), value), name
            assert shards[1][name].shape[0] == 2


def test_checkpoint_moves_between_ep1_and_ep2(runs):
    saved, back = runs["saved"], runs["back"]
    assert not saved["restored"] and saved["step"] == STEPS
    resumed = runs["port"]["resume"]
    for rank in resumed:
        assert rank["restored"] and rank["resumed_step"] == STEPS
        assert rank["mesh"] == {"data": 1, "expert": 2}
        assert_state_equal(rank["resumed"], saved["logical"])
        assert rank["step"] == STEPS + 1
    assert back["restored"] and back["resumed_step"] == STEPS + 1
    assert_state_equal(back["resumed"], resumed[0]["logical"])
