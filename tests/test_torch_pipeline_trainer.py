"""The port's stage axis in the trainer (the dp x (tp x) stage step and
the checkpoint across stage layouts) against the JAX package.

The pipelined LM of ``tests/test_torch_pipeline.py`` (4 layers, d 32,
2 heads, seq 16, float32, per-block remat on in the port) from the JAX
``init_pipeline_lm`` weights, on raw token rows, under AdamW(1e-2) +
AdamScale + the Adam preconditioner, at M 2 pipeline microbatches:

- Three steps of eight rows at dp 1 x ss 2 (GPipe, two gloo ranks of
  ``tests/torch_pipeline_worker.py``), dp 2 x ss 2 (interleaved, v 2,
  four ranks) and dp 1 x tp 2 x ss 2 (GPipe, four ranks), each step two
  samples of the noise statistics (two replicas, or at dp 1 two
  accumulated microbatches of four rows), against the
  JAX ``ElasticTrainer`` with ``pipeline_lm_sharding_fn`` /
  ``pipeline_lm_tp_sharding_fn`` on the same CPU mesh (``_pcast`` bound
  to a keyword call, ``tests/torch_zero_support.py::bind_pcast``): loss,
  gain, LR factor and progress rtol 1e-5; both noise statistics rtol
  5e-3; parameters rtol 1e-5, atol 2e-4, and Adam moments rtol 1e-4,
  atol 1e-4 of their largest entry, the tolerances
  ``tests/test_torch_tensor_parallel.py`` holds the model axis to (Adam's
  first steps scale a rounding-level gradient difference up to a step
  of about lr). The gathered payload carries the dense LM's names. At
  one replica and one microbatch the statistics difference consecutive
  steps, preconditioned by the first step's second moments, and a
  rounding-level difference in a near-zero first-step gradient moves
  them by percents: on this model the JAX package's own dense, ss 2 and
  tp 2 x ss 2 runs spread 1.7 % in ``grad_var`` and the two packages'
  dense trainers differ by 3.1 %, so the layouts step two microbatches
  (the checkpoint chain below steps single microbatches).
- The ranks agree: the replicated leaves (embedding, tied head, ln_f)
  bit-equal on every stage, every rank gathers the same full state,
  ``params_tree`` is that state's parameters, and ``eval_step`` counts a
  stage group once.
- The checkpoint: written at ss 2 under GPipe, resumed by the dense
  one-rank LM with equal parameters, moments, noise statistics and step,
  stepped and saved there, resumed at ss 2 under the interleaved
  schedule (v 2) with the dense run's full state, stepped and saved, and
  resumed by the dense LM again with that state.
"""

import json

import numpy as np
import pytest
import torch

import jax
import optax

from adaptdl_tpu.models.pipeline_lm import (
    init_pipeline_lm as jax_init_pipeline_lm,
    pipeline_lm_sharding_fn,
    pipeline_lm_tp_sharding_fn,
)
from adaptdl_tpu.parallel import create_mesh as jax_mesh
from adaptdl_tpu.scaling_rules import AdamScale as JaxAdamScale
from adaptdl_tpu_torch import checkpoint, metrics
from adaptdl_tpu_torch.parallel import mesh as pmesh
from adaptdl_tpu_torch.weights import flax_pipeline_to_state_dict
from tests import torch_pipeline_worker as worker
from tests import torch_zero_support as support
from tests.test_torch_pipeline import jax_lm_config
from tests.torch_axes_support import assert_state_equal
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

WORKER = "tests/torch_pipeline_worker.py"
STEPS, MICRO, INIT_BATCH = 3, 2, 8
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-4
MOMENT_RTOL, MOMENT_ATOL = 1e-4, 1e-4
GNS_RTOL = 5e-3
# name -> (axes, interleave, (atomic rows, accumulation steps) per replica):
# eight rows a step, two microbatches of the noise statistics each.
LAYOUTS = {
    "dp1-ss2-gpipe": ({"data": 1, "stage": 2}, 1, (4, 1)),
    "dp2-ss2-interleaved": ({"data": 2, "stage": 2}, 2, (4, 0)),
    "dp1-tp2-ss2-gpipe": ({"data": 1, "model": 2, "stage": 2}, 1, (4, 1)),
}


def _task(layout, **kw):
    axes, interleave, (atomic, accum) = LAYOUTS[layout]
    return {"kind": "train", "name": layout, "axes": axes, "interleave": interleave,
            "atomic": atomic, "accum": accum, "micro": MICRO, "init_batch": INIT_BATCH,
            "steps": STEPS, "batches": "lm.npz", **kw}


def _find(node, kind):
    if isinstance(node, kind):
        return node
    if isinstance(node, tuple):
        for child in node:
            found = _find(child, kind)
            if found is not None:
                return found
    return None


def jax_train(name, batches):
    """The JAX ElasticTrainer on the layout's mesh: per-step metrics,
    parameters and Adam's moments under the dense LM's names, the noise
    statistics."""
    from adaptdl_tpu.trainer import ElasticTrainer as JaxTrainer

    axes, interleave, (atomic, accum) = LAYOUTS[name]
    stages = axes["stage"]
    loss_fn, params = jax_init_pipeline_lm(
        jax_lm_config(), stages, MICRO, interleave, seq_len=16
    )
    devices = int(np.prod(list(axes.values())))
    sharding = pipeline_lm_tp_sharding_fn if "model" in axes else pipeline_lm_sharding_fn
    patch = support.bind_pcast()
    try:
        patch.setenv("ADAPTDL_NUM_REPLICAS", str(axes["data"]))
        trainer = JaxTrainer(
            loss_fn, params, optax.adamw(1e-2), INIT_BATCH, scaling_rule=JaxAdamScale(),
            precondition="adam", mesh=jax_mesh(axes, devices=jax.devices()[:devices]),
            param_sharding_fn=sharding, pipeline_micro=MICRO,
        )
        state = trainer.init_state()
        step = trainer.train_step(atomic, accum)
        steps = []
        for i in range(STEPS):
            state, m = step(state, trainer.shard_batch({"tokens": batches["tokens"][i]}))
            steps.append({k: float(v) for k, v in m.items()})
        opt = jax.tree.map(np.asarray, state.opt_state)
        adam = _find(opt, optax.ScaleByAdamState)

        def dense(tree):
            return flax_pipeline_to_state_dict(
                jax.tree.map(np.asarray, tree), stages, interleave
            )

        return {
            "steps": steps,
            "params": dense(trainer.params_tree(state)),
            "exp_avg": dense(adam.mu), "exp_avg_sq": dense(adam.nu),
            "gns": {k: np.asarray(getattr(state.gns, k)) for k in
                    ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias")},
        }
    finally:
        patch.undo()


def in_process(out, task, restarts):
    """``worker.train`` at one rank in this process (no process group)."""
    with pytest.MonkeyPatch.context() as patch:
        for key in ("ADAPTDL_NUM_PROCESSES", "ADAPTDL_SEQ_SHARDS", "ADAPTDL_MODEL_SHARDS",
                    "ADAPTDL_STAGE_SHARDS", "ADAPTDL_EXPERT_SHARDS", "ADAPTDL_NUM_REPLICAS",
                    "ADAPTDL_PIPELINE_MICRO"):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_trainer")
    _, params = jax_init_pipeline_lm(jax_lm_config(), 2, MICRO, 1, seq_len=16)
    full = flax_pipeline_to_state_dict(jax.device_get(params), 2, 1)
    rng = np.random.default_rng(0)
    batches = {"tokens": rng.integers(0, 64, size=(STEPS + 3, 8, 17), dtype=np.int64)}
    for d in ("two", "four", "back"):
        (out / d).mkdir()
        torch.save(full, out / d / "lm.pt")
        np.savez(out / d / "lm.npz", **batches)
    plans = {
        "two": [_task("dp1-ss2-gpipe", ckpt_dir="ckpt")],
        "four": [_task("dp2-ss2-interleaved"), _task("dp1-tp2-ss2-gpipe")],
    }
    for d, plan in plans.items():
        with open(out / d / "plan.json", "w") as f:
            json.dump(plan, f)
    procs = {
        d: support.start_ranks(out / d, "plan", replicas=n, worker=WORKER)
        for d, n in (("two", 2), ("four", 4))
    }
    try:
        reference = {name: jax_train(name, batches) for name in LAYOUTS}
    finally:
        for proc in procs.values():
            support.finish(proc)
    port = {
        task["name"]: [torch.load(out / d / f"{task['name']}-rank{r}.pt") for r in range(n)]
        for d, n in (("two", 2), ("four", 4))
        for task in plans[d]
    }
    # ss 2 (GPipe) -> the dense LM -> ss 2 (interleaved) -> the dense LM.
    dense = {"kind": "train", "axes": {"data": 1}, "init_batch": INIT_BATCH, "atomic": 8,
             "batches": "lm.npz", "ckpt_dir": "ckpt"}
    to_dense = in_process(out / "two", {**dense, "name": "dense", "first": STEPS,
                                        "steps": 1}, restarts=1)
    (out / "back" / "ckpt").symlink_to(out / "two" / "ckpt")
    back_plan = [_task("dp1-ss2-gpipe", name="interleaved", interleave=2, first=STEPS + 1,
                       steps=1, ckpt_dir="ckpt")]
    with open(out / "back" / "plan.json", "w") as f:
        json.dump(back_plan, f)
    support.finish(support.start_ranks(out / "back", "plan", replicas=2, restarts=2,
                                       worker=WORKER))
    port["interleaved"] = [torch.load(out / "back" / f"interleaved-rank{r}.pt")
                           for r in range(2)]
    again = in_process(out / "two", {**dense, "name": "again", "first": STEPS + 2,
                                     "steps": 0}, restarts=3)
    return {"jax": reference, "port": port, "to_dense": to_dense, "again": again}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_stage_steps_match_jax(runs, name):
    ranks, want = runs["port"][name], runs["jax"][name]
    assert ranks[0]["mesh"] == LAYOUTS[name][0]
    support.assert_steps_match(ranks[0]["steps"], want["steps"])
    payload = ranks[0]["logical"]
    assert sorted(payload["param_names"]) == sorted(want["params"])
    for key, value in want["params"].items():
        np.testing.assert_allclose(
            payload["model"][key].numpy(), value.numpy(), rtol=PARAM_RTOL,
            atol=PARAM_ATOL, err_msg=key,
        )
    for moment in ("exp_avg", "exp_avg_sq"):
        for i, key in enumerate(payload["param_names"]):
            want_m = want[moment][key].numpy()
            np.testing.assert_allclose(
                payload["optimizer"]["state"][i][moment].numpy(), want_m,
                rtol=MOMENT_RTOL, atol=MOMENT_ATOL * float(np.abs(want_m).max()),
                err_msg=(moment, key),
            )
    var = float(np.abs(want["gns"]["var_biased"]).max())
    for key, value in want["gns"].items():
        np.testing.assert_allclose(
            payload["gns"][key].numpy(), value, rtol=GNS_RTOL,
            atol=1e-5 * var if key == "sqr_biased" else 0, err_msg=key,
        )


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_stage_ranks_agree(runs, name):
    ranks = runs["port"][name]
    replicated = ("embed.weight", "ln_f.scale")
    for rank in ranks:
        for key in replicated:
            assert torch.equal(rank["local"][key], ranks[0]["local"][key]), key
        assert_state_equal(rank["logical"], ranks[0]["logical"])
        for key, value in ranks[0]["logical"]["model"].items():
            assert torch.equal(rank["params_tree"][key], value), key
        assert int(rank["eval"]["rows"]) == 8
        assert torch.equal(rank["eval"]["loss_sum"], ranks[0]["eval"]["loss_sum"])
    # Each stage holds only its own blocks.
    stages = [r for r in ranks if r["mesh"] == ranks[0]["mesh"]]
    names = [{k for k in r["local"] if k.startswith("layers.")} for r in stages[:2]]
    if "model" not in LAYOUTS[name][0]:
        assert not names[0] & names[1]
        assert len(names[0]) * 2 == sum(k.startswith("layers.") for k in
                                         ranks[0]["logical"]["model"])


def test_checkpoint_moves_across_stage_layouts(runs):
    saved = runs["port"]["dp1-ss2-gpipe"][0]
    to_dense, again = runs["to_dense"], runs["again"]
    assert to_dense["restored"] and to_dense["resumed_step"] == STEPS
    assert to_dense["mesh"] == {"data": 1}
    assert_state_equal(to_dense["resumed"], saved["logical"])
    assert to_dense["step"] == STEPS + 1
    for rank in runs["port"]["interleaved"]:
        assert rank["restored"] and rank["resumed_step"] == STEPS + 1
        assert rank["mesh"] == {"data": 1, "stage": 2}
        assert_state_equal(rank["resumed"], to_dense["logical"])
        assert rank["step"] == STEPS + 2
    assert again["restored"] and again["resumed_step"] == STEPS + 2
    assert_state_equal(again["resumed"], runs["port"]["interleaved"][0]["logical"])
