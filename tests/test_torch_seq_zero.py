"""The ZeRO storage modes under a seq axis (the seq x ZeRO composition)
in the port, against the JAX package.

The 2-layer, 4-head, d_model 32 LM (``zero3_blocks``: the zero3 LM) from
the same converted weights, float32, inputs and targets aligned on the
host, ring attention over the seq axis, AdamW(1e-2) + AdamScale + the
Adam preconditioner, two steps on the same numpy batches of 8 rows of
16 positions at dp 2 x sp 2 (four gloo ranks of
``tests/torch_axes_worker.py``, per-block remat on) in each mode --
zero1 and zero3 at (4, 0), zero3_blocks at (2, 1) -- against the JAX
``ElasticTrainer`` in the same mode on a ``{"data": 2, "seq": 2}`` CPU
mesh (``_pcast`` bound to a keyword call in ``adaptdl_tpu.trainer`` and
``adaptdl_tpu.parallel.zero3``). The rows split over the data group
only: a rank's row is its data replica's, whatever its seq index.
Tolerances: loss, gain, LR factor and progress rtol 1e-5; the noise
statistics rtol 5e-3 (``tests/torch_zero_support.py``'s); parameters
rtol 1e-5, atol 2e-4; flat moments rtol 1e-4, atol 1e-4 of their
largest (through ``weights.flat_order_map``). The ring's blocked
softmax sums in another order than the JAX one, and Adam's first steps
scale a rounding-level gradient difference up to a step of about lr:
the parameters are held at the atol the JAX package holds its own
sharded runs to (``tests/test_tensor_parallel.py``). Every rank gathers
the same full state, bit for bit.

The sharded checkpoint at dp 2 x sp 2: one step saved through
``ShardedTrainerCheckpoint`` (the first seq rank of each data row writes
that row's file), restored on every rank and stepped once more. The
restored state equals the saved one and the second step equals the
uninterrupted run's, bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import optax

from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.models import init_zero3_lm as jax_init_zero3_lm
from adaptdl_tpu.parallel import create_mesh as jax_mesh
from adaptdl_tpu.scaling_rules import AdamScale as JaxAdamScale
from adaptdl_tpu_torch.weights import (
    flat_order_map, flax_to_state_dict, flax_zero3_lm_to_state_dict,
)
from tests import torch_zero_support as support
from tests.torch_axes_support import INIT_BATCH, assert_state_equal, jax_config, jax_loss
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

WORKER = "tests/torch_axes_worker.py"
STEPS = 2
AXES = {"data": 2, "seq": 2}
# (mode, atomic, accum): every run takes 8 rows per step.
MODES = [("zero1", 4, 0), ("zero3", 4, 0), ("zero3_blocks", 2, 1)]
PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-4
MOMENT_RTOL, MOMENT_ATOL = 1e-4, 1e-4


def _jax_run(mode, loss_fn, params, atomic, accum, batches):
    from adaptdl_tpu.trainer import ElasticTrainer as JaxTrainer

    patch = support.bind_pcast()
    try:
        patch.setenv("ADAPTDL_NUM_REPLICAS", "2")
        kwargs = {"zero3_blocks": "blocks"} if mode == "zero3_blocks" else {mode: True}
        trainer = JaxTrainer(
            loss_fn, params, optax.adamw(1e-2), INIT_BATCH, scaling_rule=JaxAdamScale(),
            precondition="adam", mesh=jax_mesh(AXES, devices=jax.devices()[:4]), **kwargs,
        )
        state = trainer.init_state()
        step = trainer.train_step(atomic, accum)
        steps = []
        for i in range(STEPS):
            state, m = step(state, trainer.shard_batch({k: v[i] for k, v in batches.items()}))
            steps.append({k: float(v) for k, v in m.items()})
        return {
            "steps": steps,
            "params": jax.tree.map(np.asarray, trainer.params_tree(state)),
            "moments": support.jax_moments(trainer, state),
            "gns": {k: np.asarray(getattr(state.gns, k)) for k in
                    ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias")},
            "ema_is_biased": bool(state.gns.ema_is_biased),
        }
    finally:
        patch.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq_zero")
    config = jax_config(seq_axis="seq", seq_attention="ring")
    _, params = jax_init(jax_config(), seq_len=16)
    params = jax.device_get(params)
    z3b_loss, z3b_params = jax_init_zero3_lm(config, seq_len=16)
    z3b_params = jax.device_get(z3b_params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(STEPS, 8, 17), dtype=np.int64)
    batches = {"inputs": tokens[:, :, :-1].copy(), "targets": tokens[:, :, 1:].copy()}
    torch.save(flax_to_state_dict(params), out / "lm.pt")
    torch.save(flax_zero3_lm_to_state_dict(z3b_params), out / "z3b.pt")
    np.savez(out / "lm.npz", **batches)
    plan = [
        {"kind": "train", "name": mode, "axes": AXES, "zero": mode, "init_batch": INIT_BATCH,
         "atomic": atomic, "accum": accum, "steps": STEPS, "batches": "lm.npz",
         "weights": "z3b.pt" if mode == "zero3_blocks" else "lm.pt"}
        for mode, atomic, accum in MODES
    ]
    for mode, atomic, accum in MODES:
        for name, first in (("save", 0), ("load", 1)):
            plan.append(
                {**plan[[m[0] for m in MODES].index(mode)], "name": f"{mode}-{name}",
                 "steps": 1, "first": first, "ckpt": "sharded", "ckpt_dir": f"ckpt-{mode}"}
            )
    with open(out / "plan.json", "w") as f:
        json.dump(plan, f)
    proc = support.start_ranks(out, "plan", replicas=4, restarts=0, worker=WORKER)
    try:
        seq_model, _ = jax_init(config, seq_len=16)
        reference = {}
        for mode, atomic, accum in MODES:
            if mode == "zero3_blocks":
                reference[mode] = _jax_run(mode, z3b_loss, z3b_params, atomic, accum, batches)
            else:
                reference[mode] = _jax_run(mode, jax_loss(seq_model), params, atomic,
                                           accum, batches)
    finally:
        support.finish(proc)
    port = {name: [torch.load(out / f"{name}-rank{r}.pt") for r in range(4)]
            for mode, _, _ in MODES for name in (mode, f"{mode}-save", f"{mode}-load")}
    payloads = {}
    for mode, _, _ in MODES:
        root = out / f"ckpt-{mode}" / "sharded"
        payloads[mode] = [sorted(os.listdir(root / d)) for d in sorted(os.listdir(root))
                          if (root / d).is_dir()]
    return {"jax": reference, "port": port, "params": params, "z3b_params": z3b_params,
            "payloads": payloads}


@pytest.mark.parametrize("mode", [m[0] for m in MODES])
def test_seq_zero_step_matches_jax(runs, mode):
    ranks = runs["port"][mode]
    want = runs["jax"][mode]
    assert ranks[0]["mesh"] == AXES
    support.assert_steps_match(ranks[0]["steps"], want["steps"])
    payload = ranks[0]["logical"]
    assert payload["layout"] == mode
    convert = flax_zero3_lm_to_state_dict if mode == "zero3_blocks" else flax_to_state_dict
    for name, value in convert(want["params"]).items():
        np.testing.assert_allclose(
            payload["model"][name].numpy(), value.numpy(), rtol=PARAM_RTOL,
            atol=PARAM_ATOL, err_msg=name,
        )
    perm = flat_order_map(
        runs["z3b_params"] if mode == "zero3_blocks" else runs["params"], convert,
        payload["param_names"],
    )
    flat = payload["optimizer"]["flat_state"]
    assert set(flat) == set(want["moments"])
    for key, value in flat.items():
        target = want["moments"][key][perm]
        np.testing.assert_allclose(
            value.numpy(), target, rtol=MOMENT_RTOL,
            atol=MOMENT_ATOL * float(np.abs(target).max()), err_msg=key,
        )
    support.assert_gns_match(payload["gns"], want)


@pytest.mark.parametrize("mode", [m[0] for m in MODES])
def test_seq_zero_ranks_agree(runs, mode):
    ranks = runs["port"][mode]
    for other in ranks[1:]:
        assert other["steps"] == ranks[0]["steps"]
        assert_state_equal(other["logical"], ranks[0]["logical"])


@pytest.mark.parametrize("mode", [m[0] for m in MODES])
def test_seq_zero_sharded_checkpoint_round_trip(runs, mode):
    port = runs["port"]
    # One file pair for each data row, none for a seq rank.
    assert runs["payloads"][mode]
    for files in runs["payloads"][mode]:
        assert files == ["rank-0.bin", "rank-0.json", "rank-1.bin", "rank-1.json"]
    saved, loaded, whole = port[f"{mode}-save"], port[f"{mode}-load"], port[mode]
    for r in range(4):
        assert not saved[r]["restored"]
        assert loaded[r]["restored"] and loaded[r]["resumed_step"] == 1
        assert_state_equal(loaded[r]["resumed"], saved[r]["logical"])
        assert loaded[r]["steps"] == whole[r]["steps"][1:]
        assert_state_equal(loaded[r]["logical"], whole[r]["logical"])
