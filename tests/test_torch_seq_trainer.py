"""The port's data x seq trainer step against the JAX package's.

The 2-layer, 2-head, d_model 32 LM from the same converted weights
(``weights.py``), SGD(0.05, momentum 0.9) + AdaScale, the loss over
inputs and targets aligned on the host, two steps on the same numpy
batches of 8 rows of 16 positions: at dp 1 x sp 2 (two gloo processes of
``tests/torch_seq_worker.py``) and dp 2 x sp 2 (four), ring and
ulysses, against the JAX ``ElasticTrainer`` on a ``{"data", "seq"}``
mesh of the conftest's CPU devices (``_pcast`` bound to a keyword call,
``tests/torch_zero_support.py::bind_pcast``). The port runs with
per-block remat, so its backward re-runs the seq exchanges. Tolerances
(float32): loss rtol 1e-5; parameters atol 2e-6 and rtol 1e-5; both
noise scalars (``grad_sqr``, ``grad_var``) rtol 1e-4. Every rank ends
with the same parameters.

The chunked head under a seq axis: at dp 1 x sp 2, ring and ulysses,
the loss of ``ops/chunked_xent.py`` over each rank's block of positions
(vocab chunks of ``CHUNK``, the last one padded) equals the port's
one-process chunked run on the same batches (loss rtol 1e-5, parameters
at the bound above, so the gradients agree) and the JAX
``chunked_softmax_xent`` over the full sequence (loss rtol 1e-5).

Also: the loader's rows under a seq group (a seq group's processes get
their data replica's rows), and a checkpoint written at sp 1 (in this
process) resumed at sp 2 with equal parameters and step, stepped and
saved there, and resumed at sp 1 again.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.parallel import create_mesh as jax_mesh
from adaptdl_tpu.scaling_rules import AdaScale as JaxAdaScale
from adaptdl_tpu_torch import checkpoint, metrics
from adaptdl_tpu_torch.parallel import mesh as pmesh
from adaptdl_tpu_torch.weights import flax_to_state_dict
from tests import torch_seq_worker as worker
from tests import torch_zero_support as support
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

WORKER = "tests/torch_seq_worker.py"
STEPS = 2
INIT_BATCH = 4
# (name, seq mode, dp, atomic, accum): every run takes 8 rows per step.
RUNS = [
    ("ring-dp1", "ring", 1, 8, 0),
    ("ulysses-dp1", "ulysses", 1, 8, 0),
    ("ulysses-dp2-accum1", "ulysses", 2, 2, 1),
    ("ring-dp2", "ring", 2, 4, 0),
]
# (name, seq mode): chunked-head runs at dp 1 x sp 2, atomic 8.
CHUNKED_RUNS = [("ring-dp1-chunked", "ring"), ("ulysses-dp1-chunked", "ulysses")]
CHUNK = 24
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 2e-6, 1e-5
GNS_RTOL = 1e-4


def _jax_loss(model):
    def loss(p, batch, rng):
        logits = model.apply({"params": p}, batch["inputs"], train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["targets"]
        ).mean()

    return loss


def _jax_run(params, mode, dp, atomic, accum, batches):
    from adaptdl_tpu.trainer import ElasticTrainer as JaxTrainer

    config = JaxConfig(
        **worker.LM_SIZES, max_seq_len=16, dtype=jnp.float32, remat=False,
        seq_axis="seq", seq_attention=mode,
    )
    model, _ = jax_init(config, seq_len=16)
    patch = support.bind_pcast()
    try:
        patch.setenv("ADAPTDL_NUM_REPLICAS", str(dp))
        trainer = JaxTrainer(
            _jax_loss(model), params, optax.sgd(0.05, momentum=0.9), INIT_BATCH,
            scaling_rule=JaxAdaScale(),
            mesh=jax_mesh({"data": dp, "seq": 2}, devices=jax.devices()[: dp * 2]),
        )
        state = trainer.init_state()
        step = trainer.train_step(atomic, accum)
        steps = []
        for i in range(STEPS):
            batch = {k: v[i] for k, v in batches.items()}
            state, m = step(state, trainer.shard_batch(batch))
            steps.append({k: float(v) for k, v in m.items()})
        tree = jax.tree.map(np.asarray, trainer.params_tree(state))
        return {"steps": steps, "params": flax_to_state_dict(tree)}
    finally:
        patch.undo()


def _jax_chunked_loss(params, batch):
    """The JAX example's chunked loss on the full sequence."""
    from adaptdl_tpu.ops.chunked_xent import chunked_softmax_xent

    config = JaxConfig(**worker.LM_SIZES, max_seq_len=16, dtype=jnp.float32, remat=False)
    model, _ = jax_init(config, seq_len=16)
    hidden = model.apply(
        {"params": params}, batch["inputs"], train=False, return_hidden=True
    )
    losses = chunked_softmax_xent(
        hidden.reshape(-1, hidden.shape[-1]), params["embed"]["embedding"],
        batch["targets"].reshape(-1), CHUNK,
    )
    return float(losses.mean())


def _sp1_chunked_run(out, batches):
    """The chunked head in one process (sp 1), ``STEPS`` steps at atomic 8."""
    with pytest.MonkeyPatch.context() as patch:
        for key in ("ADAPTDL_NUM_REPLICAS", "ADAPTDL_SEQ_SHARDS", "ADAPTDL_NUM_PROCESSES"):
            patch.delenv(key, raising=False)
        checkpoint._reset_registry()
        metrics._reset_state()
        trainer = worker.build_trainer(
            "ring", 1, INIT_BATCH, torch.load(out / "lm.pt"), chunked=CHUNK
        )
        state = trainer.init_state()
        step = trainer.train_step(8, 0)
        steps = []
        for i in range(STEPS):
            state, m = step(state, trainer.to_device({k: v[i] for k, v in batches.items()}))
            steps.append({k: float(v) for k, v in m.items()})
        params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        checkpoint._reset_registry()
        metrics._reset_state()
        pmesh._reset()
        return {"steps": steps, "params": params}


def _sp1_run(out, batches, restarts, first, steps):
    """A one-process (sp 1) run with the trainer checkpoint at
    ``out/ckpt``: restore, ``steps`` steps from batch ``first``, save."""
    with pytest.MonkeyPatch.context() as patch:
        for key in ("ADAPTDL_NUM_REPLICAS", "ADAPTDL_SEQ_SHARDS", "ADAPTDL_NUM_PROCESSES"):
            patch.delenv(key, raising=False)
        patch.setenv("ADAPTDL_CHECKPOINT_PATH", str(out / "ckpt"))
        patch.setenv("ADAPTDL_NUM_RESTARTS", str(restarts))
        checkpoint._reset_registry()
        metrics._reset_state()
        trainer = worker.build_trainer("ring", 1, INIT_BATCH, torch.load(out / "lm.pt"))
        holder = {"state": trainer.init_state()}
        ckpt = trainer.make_checkpoint_state(
            lambda: holder["state"], lambda s: holder.__setitem__("state", s), name="lm"
        )
        restored = checkpoint.load_state(ckpt)
        resumed = {
            "restored": restored, "step": holder["state"].host_step,
            "params": {k: v.clone() for k, v in trainer.model.state_dict().items()},
        }
        step = trainer.train_step(8, 0)
        for i in range(first, first + steps):
            holder["state"], _ = step(
                holder["state"], trainer.to_device({k: v[i] for k, v in batches.items()})
            )
        checkpoint.save_all_states()
        resumed["after"] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        checkpoint._reset_registry()
        metrics._reset_state()
        pmesh._reset()
        return resumed


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq_trainer")
    _, params = jax_init(
        JaxConfig(**worker.LM_SIZES, max_seq_len=16, dtype=jnp.float32, remat=False),
        seq_len=16,
    )
    params = jax.device_get(params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(STEPS + 1, 8, 17), dtype=np.int64)
    batches = {"inputs": tokens[:, :, :-1].copy(), "targets": tokens[:, :, 1:].copy()}
    # sp 1 saves after two steps; the two-rank launch resumes from it.
    saved = None
    plans = {}
    for ranks, dp in ((2, 1), (4, 2)):
        d = out / str(ranks)
        d.mkdir()
        torch.save(flax_to_state_dict(params), d / "lm.pt")
        np.savez(d / "lm.npz", **batches)
        plan = [
            {"kind": "train", "name": name, "dp": dp, "sp": 2, "seq_mode": mode,
             "init_batch": INIT_BATCH, "atomic": atomic, "accum": accum,
             "steps": STEPS, "batches": "lm.npz"}
            for name, mode, run_dp, atomic, accum in RUNS if run_dp == dp
        ] + [{"kind": "loader", "name": "loader", "dp": dp, "sp": 2, "batch": 8}]
        if ranks == 2:
            plan += [
                {"kind": "train", "name": name, "dp": 1, "sp": 2, "seq_mode": mode,
                 "init_batch": INIT_BATCH, "atomic": 8, "accum": 0, "steps": STEPS,
                 "batches": "lm.npz", "chunked": CHUNK}
                for name, mode in CHUNKED_RUNS
            ]
            saved = _sp1_run(d, batches, restarts=0, first=0, steps=STEPS)
            plan.append({
                "kind": "train", "name": "resume", "dp": 1, "sp": 2, "seq_mode": "ulysses",
                "init_batch": INIT_BATCH, "atomic": 8, "accum": 0, "first": STEPS,
                "steps": 1, "batches": "lm.npz", "ckpt_dir": "ckpt",
            })
        with open(d / "plan.json", "w") as f:
            json.dump(plan, f)
        plans[ranks] = plan
    procs = {
        ranks: support.start_ranks(out / str(ranks), "plan", replicas=ranks, restarts=1,
                                   worker=WORKER)
        for ranks in plans
    }
    reference = {}
    try:
        for name, mode, dp, atomic, accum in RUNS:
            reference[name] = _jax_run(params, mode, dp, atomic, accum, batches)
        reference["chunked-loss"] = _jax_chunked_loss(
            params, {k: v[0] for k, v in batches.items()}
        )
        one_rank_chunked = _sp1_chunked_run(out / "2", batches)
    finally:
        for proc in procs.values():
            support.finish(proc)
    port = {}
    for ranks, plan in plans.items():
        for task in plan:
            port[task["name"] if task["kind"] != "loader" else f"loader-{ranks}"] = [
                torch.load(out / str(ranks) / f"{task['name']}-rank{r}.pt")
                for r in range(ranks)
            ]
    back = _sp1_run(out / "2", batches, restarts=2, first=STEPS + 1, steps=0)
    return {"jax": reference, "port": port, "saved": saved, "back": back,
            "chunked": one_rank_chunked}


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_seq_step_matches_jax(runs, name):
    want = runs["jax"][name]
    ranks = runs["port"][name]
    dp = {r[0]: r[2] for r in RUNS}[name]
    assert ranks[0]["mesh"] == {"data": dp, "seq": 2}
    for got_step, want_step in zip(ranks[0]["steps"], want["steps"]):
        np.testing.assert_allclose(got_step["loss"], want_step["loss"], rtol=LOSS_RTOL)
        for key in ("grad_sqr", "grad_var"):
            np.testing.assert_allclose(got_step[key], want_step[key], rtol=GNS_RTOL)
        for key in ("gain", "lr_factor", "progress"):
            np.testing.assert_allclose(got_step[key], want_step[key], rtol=LOSS_RTOL)
    for key, value in want["params"].items():
        np.testing.assert_allclose(
            ranks[0]["params"][key].numpy(), value.numpy(),
            atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=key,
        )
    # One logical replica per seq group, one model per job: every rank
    # holds the same parameters and noise statistics.
    for other in ranks[1:]:
        for key, value in ranks[0]["params"].items():
            assert torch.equal(other["params"][key], value), key
        for key, value in ranks[0]["gns"].items():
            assert torch.equal(other["gns"][key], value), key


@pytest.mark.parametrize("name", [r[0] for r in CHUNKED_RUNS])
def test_seq_chunked_xent_matches_one_rank(runs, name):
    want = runs["chunked"]
    ranks = runs["port"][name]
    assert ranks[0]["mesh"] == {"data": 1, "seq": 2}
    np.testing.assert_allclose(
        ranks[0]["steps"][0]["loss"], runs["jax"]["chunked-loss"], rtol=LOSS_RTOL
    )
    for got_step, want_step in zip(ranks[0]["steps"], want["steps"]):
        np.testing.assert_allclose(got_step["loss"], want_step["loss"], rtol=LOSS_RTOL)
    for key, value in want["params"].items():
        np.testing.assert_allclose(
            ranks[0]["params"][key].numpy(), value.numpy(),
            atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=key,
        )
    for key, value in ranks[0]["params"].items():
        assert torch.equal(ranks[1]["params"][key], value), key


def test_loader_rows_follow_the_data_rank(runs):
    with pytest.MonkeyPatch.context() as patch:
        for key in ("ADAPTDL_NUM_PROCESSES", "ADAPTDL_SEQ_SHARDS"):
            patch.delenv(key, raising=False)
        patch.setenv("ADAPTDL_NUM_REPLICAS", "2")
        checkpoint._reset_registry()
        from adaptdl_tpu_torch.data import AdaptiveDataLoader

        dataset = {"x": np.arange(64 * 4, dtype=np.float32).reshape(64, 4)}
        loop = iter(AdaptiveDataLoader(dataset, batch_size=8))
        try:
            whole = next(loop)["x"]  # one process holding both replicas' rows
        finally:
            loop.close()
        checkpoint._reset_registry()
    dp1 = [r["x"].numpy() for r in runs["port"]["loader-2"]]
    np.testing.assert_array_equal(dp1[0], dp1[1])
    assert dp1[0].shape == (8, 4)
    dp2 = [r["x"].numpy() for r in runs["port"]["loader-4"]]
    # Ranks 0, 1 are replica 0's seq group, ranks 2, 3 replica 1's.
    np.testing.assert_array_equal(dp2[0], dp2[1])
    np.testing.assert_array_equal(dp2[2], dp2[3])
    np.testing.assert_array_equal(np.concatenate([dp2[0], dp2[2]]), whole)


def test_checkpoint_moves_between_sp1_and_sp2(runs):
    saved, back = runs["saved"], runs["back"]
    assert not saved["restored"] and saved["step"] == 0
    for rank in runs["port"]["resume"]:
        assert rank["restored"] and rank["resumed_step"] == STEPS
        for key, value in saved["after"].items():
            assert torch.equal(rank["resumed_params"][key], value), key
        assert rank["step"] == STEPS + 1
    assert back["restored"] and back["step"] == STEPS + 1
    for key, value in runs["port"]["resume"][0]["params"].items():
        assert torch.equal(back["params"][key], value), key
