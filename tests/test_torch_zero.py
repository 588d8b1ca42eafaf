"""The ZeRO-1 and ZeRO-3 ("lite") storage modes of the port's trainer,
against the JAX package's ``ElasticTrainer(zero1=True | zero3=True)``.

Parity: the 2-layer, d_model 32 transformer (the JAX tests' size) from
the same converted weights, three steps on the same numpy batches of 8
rows, at one replica (in this process) and at two (two gloo processes of
``tests/torch_zero_worker.py`` started by ``adaptdl_tpu_torch.launch``)
against the JAX trainer on a 1- and a 2-device mesh in the same mode,
at accum_steps 0 and 1, under AdamW(1e-2) + AdamScale with
``precondition="adam"`` and under SGD(0.05, momentum 0.9) + AdaScale.
Tolerances (``test_torch_multi_replica.py``'s): loss, gain, LR factor
and progress rtol 1e-5; parameters rtol 1e-5 and atol 2e-6; the noise
statistics rtol 5e-3; the flat moments rtol 1e-5 and atol 2e-6 of their
largest element. At one replica the modes equal the dense port bit for
bit. Also: two parameter groups (the per-position factor table), the
storage really split into rows (moments, parameters released between
zero3 steps, the empty carry), the collectives, a rescale 2 -> 1 -> 2
through ``TrainerCheckpoint`` for each mode against an uninterrupted
run, ``params_tree``/``eval_step``, calibration through ``run_step`` and
the composition rules.
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
from adaptdl_tpu.scaling_rules import AdamScale as JaxAdamScale
from adaptdl_tpu.scaling_rules import AdaScale as JaxAdaScale
from adaptdl_tpu_torch import checkpoint, metrics
from adaptdl_tpu_torch.weights import flat_order_map, flax_to_state_dict
from tests import torch_zero_support as support
from tests import torch_zero_worker as worker
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

STEPS = 3
MODES = ("zero1", "zero3")
OPTS = ("adamw", "sgd")


@pytest.fixture(autouse=True)
def _port_state():
    checkpoint._reset_registry()
    metrics._reset_state()
    yield
    checkpoint._reset_registry()
    metrics._reset_state()


def _jax_loss(model):
    def loss(p, batch, rng):
        tokens = batch["tokens"]
        logits = model.apply({"params": p}, tokens[:, :-1], train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tokens[:, 1:]
        ).mean()

    return loss


def _jax_opt(kind):
    if kind == "sgd":
        return optax.sgd(0.05, momentum=0.9), JaxAdaScale(), None
    return optax.adamw(1e-2), JaxAdamScale(), "adam"


def _task(name, mode, **kw):
    task = {"kind": "train", "name": name, "model": "lm", "model_file": "lm.pt",
            "mode": mode, "batches": "lm.npz", "steps": STEPS, "init_batch": 8}
    task.update(kw)
    return task


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch and JAX run of this module: the two-rank plan starts
    first, the JAX references run while it does, then the rescale's
    one-rank middle (in this process) and its two-rank end."""
    out = tmp_path_factory.mktemp("zero")
    jax_model, params = jax_init(
        JaxConfig(**worker.LM_SIZES, max_seq_len=16, dtype=jnp.float32, remat=False),
        seq_len=8,
    )
    params = jax.device_get(params)
    torch.save(flax_to_state_dict(params), out / "lm.pt")
    rng = np.random.default_rng(0)
    np.savez(out / "lm.npz", tokens=rng.integers(0, 64, size=(STEPS + 2, 8, 9), dtype=np.int32))
    plan = [{"kind": "collectives", "name": "collectives"}]
    for mode in MODES:
        for accum in (0, 1):
            for opt in OPTS:
                plan.append(_task(f"{mode}-{accum}-{opt}", mode, accum=accum, opt=opt))
        plan.append(_task(f"save-{mode}", mode, ckpt="trainer", ckpt_dir=f"ckpt-{mode}"))
    plan.append(_task("groups-zero1", "zero1", param_groups=True))
    plan.append(_task("groups-dense", "dense", param_groups=True))
    with open(out / "first.json", "w") as f:
        json.dump(plan, f)
    proc = support.start_ranks(out, "first")
    batches = dict(np.load(out / "lm.npz"))
    three = {"tokens": batches["tokens"][:STEPS]}
    loss = _jax_loss(jax_model)
    reference = {}
    try:
        for mode in MODES:
            for dp in (1, 2):
                for accum in (0, 1):
                    for opt in OPTS:
                        optimizer, rule, precond = _jax_opt(opt)
                        reference[(mode, dp, accum, opt)] = support.jax_run(
                            loss, params, optimizer, rule, precond, dp, three, accum, 8,
                            **{mode: True},
                        )

        def embed_first(path, leaf):
            return 0 if any(getattr(p, "key", None) == "embed" for p in path) else 1

        reference["groups"] = support.jax_run(
            loss, params, optax.adamw(1e-2), JaxAdamScale(), "adam", 2, three, 0, 8,
            group_fn=embed_first, zero1=True,
        )
    finally:
        first_out = support.finish(proc)
    ranks = {}
    for task in plan:
        ranks[task["name"]] = [torch.load(out / f"{task['name']}-rank{r}.pt") for r in (0, 1)]
    # The rescale's middle: one replica restores the two-rank save,
    # steps once and saves; then two ranks restore that and step once.
    middle = {}
    for mode in MODES:
        task = _task(f"middle-{mode}", mode, ckpt="trainer", ckpt_dir=f"ckpt-{mode}",
                     first=STEPS, steps=1)
        middle[mode] = worker.train(task, str(out), 0, 1)
        checkpoint._reset_registry()
    last = [_task(f"last-{mode}", mode, ckpt="trainer", ckpt_dir=f"ckpt-{mode}",
                  first=STEPS + 1, steps=1, save=False) for mode in MODES]
    with open(out / "last.json", "w") as f:
        json.dump(last, f)
    support.finish(support.start_ranks(out, "last", restarts=2))
    for task in last:
        ranks[task["name"]] = [torch.load(out / f"{task['name']}-rank{r}.pt") for r in (0, 1)]
    perm = flat_order_map(params, flax_to_state_dict, list(ranks["zero1-0-adamw"][0]["params"]))
    return {"out": out, "ranks": ranks, "jax": reference, "params": params,
            "middle": middle, "perm": perm, "log": first_out}


def _one_replica(runs, mode, accum, opt, name=None):
    task = _task(name or f"{mode}-{accum}-{opt}", mode, accum=accum, opt=opt)
    return worker.train(task, str(runs["out"]), 0, 1)


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("accum", [0, 1])
@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_zero_mode_matches_jax(runs, mode, dp, accum, opt):
    want = runs["jax"][(mode, dp, accum, opt)]
    if dp == 1:
        got = _one_replica(runs, mode, accum, opt)
    else:
        ranks = runs["ranks"][f"{mode}-{accum}-{opt}"]
        for name, p in ranks[0]["params"].items():
            assert torch.equal(p, ranks[1]["params"][name]), name
        assert ranks[0]["steps"] == ranks[1]["steps"]
        got = ranks[0]
    support.assert_steps_match(got["steps"], want["steps"])
    support.assert_params_match(got["params"], flax_to_state_dict(want["params"]))
    support.assert_gns_match(got["gns"], want)
    support.assert_moments_match(got["moments"], want["moments"], runs["perm"])
    assert got["step"] == want["step"] == STEPS


@pytest.mark.parametrize("accum", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_zero_at_one_replica_is_the_dense_step_bit_for_bit(runs, mode, accum):
    dense = _one_replica(runs, "dense", accum, "adamw", name="dense")
    got = _one_replica(runs, mode, accum, "adamw")
    assert got["steps"] == dense["steps"]
    for name, p in dense["params"].items():
        assert torch.equal(got["params"][name], p), name
    for key, flat in dense["moments"].items():
        assert torch.equal(got["moments"][key], flat), key


def test_zero1_param_groups_match_jax_and_dense(runs):
    ranks = runs["ranks"]
    got, dense = ranks["groups-zero1"][0], ranks["groups-dense"][0]
    want = runs["jax"]["groups"]
    support.assert_steps_match(got["steps"], want["steps"])
    support.assert_params_match(got["params"], flax_to_state_dict(want["params"]))
    for name, p in dense["params"].items():
        assert torch.equal(got["params"][name], p), name
    assert got["gns"]["sqr_biased"].shape == (2,)


def test_zero1_group_table_covers_each_position():
    from adaptdl_tpu_torch.models import TransformerConfig, init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    model = init_transformer(
        TransformerConfig(**worker.LM_SIZES, dtype=torch.float32, remat=False), device="cpu"
    )
    numels = [p.numel() for p in model.parameters()]
    trainer = ElasticTrainer(
        lm_loss_fn, model, AdamW(model.parameters(), lr=1e-2), 8, device="cpu",
        zero1=True, param_group_fn=lambda n, p: 0 if n.startswith("embed") else 1,
    )
    gids = trainer._row_gids
    assert gids.shape == (sum(numels),)
    assert gids[: numels[0]].eq(0).all() and gids[numels[0]:].eq(1).all()
    single = ElasticTrainer(
        lm_loss_fn, model, AdamW(model.parameters(), lr=1e-2), 8, device="cpu", zero1=True,
    )
    assert single._row_gids is None  # one group: no table


@pytest.mark.parametrize("mode", MODES)
def test_storage_is_split_into_rows(runs, mode):
    facts = [r["facts"] for r in runs["ranks"][f"{mode}-0-adamw"]]
    n = facts[0]["n"]
    shard = (n + n % 2) // 2
    for f in facts:
        assert f["rows"] == [[shard]]
        assert f["moments"] == {"exp_avg": [[shard]], "exp_avg_sq": [[shard]]}
        # The carry is the placeholder at two replicas.
        assert all(shape == [1] for shape in f["prev_grad"])
        # zero3 releases the parameter buffer between steps.
        assert all(f["released"]) == (mode == "zero3")
        assert any(f["released"]) == (mode == "zero3")


def test_collectives_at_two_ranks_and_at_one():
    from adaptdl_tpu_torch import collective

    row = torch.arange(3.0)
    assert collective.all_gather_rows(row) is row
    assert collective.reduce_scatter_sum(row) is row


def test_collectives_gather_and_reduce_scatter(runs):
    for rank, got in enumerate(runs["ranks"]["collectives"]):
        want = torch.cat([torch.arange(4.0), torch.arange(4.0) + 10])
        assert torch.equal(got["gathered"], want)
        assert torch.equal(got["gathered_out"], want)
        summed = torch.arange(8.0) * 3  # ranks multiply by 1 and 2
        assert torch.equal(got["scattered"], summed[rank * 4 : (rank + 1) * 4])
        # Two gathers and one reduce-scatter of 8 float32 each; no
        # exchange of the seq axis.
        assert got["traffic"] == {"all_reduce": 0, "all_gather": 64, "reduce_scatter": 32,
                                  "all_to_all": 0, "ppermute": 0}


@pytest.mark.parametrize("mode", MODES)
def test_rescale_two_one_two_through_the_trainer_checkpoint(runs, mode):
    """3 steps at two ranks, a save; one rank restores it (step 3, the
    saved parameters), steps once and saves; two ranks restore that and
    step once: the parameters equal 5 uninterrupted steps of the dense
    port at one replica (same global batches; the LR factor is 1 at this
    scale, so the replica count changes only the summation order)."""
    saved = runs["ranks"][f"save-{mode}"][0]
    middle = runs["middle"][mode]
    last = runs["ranks"][f"last-{mode}"]
    assert middle["resumed"] == STEPS and last[0]["resumed"] == STEPS + 1
    assert last[0]["step"] == STEPS + 2
    for name, p in saved["params"].items():
        assert torch.equal(middle["resumed_params"][name], p), name
    for name, p in middle["params"].items():
        assert torch.equal(last[0]["resumed_params"][name], p), name
    for name, p in last[0]["params"].items():
        assert torch.equal(p, last[1]["params"][name]), name
    reference = worker.train(
        _task("reference", "dense", steps=STEPS + 2), str(runs["out"]), 0, 1
    )
    for name, p in reference["params"].items():
        np.testing.assert_allclose(
            last[0]["params"][name].numpy(), p.numpy(), rtol=5e-5, atol=5e-6, err_msg=name
        )
    assert saved["step"] == STEPS


@pytest.mark.parametrize("mode", MODES)
def test_canonical_snapshot_travels_the_handoff(mode):
    """The handoff's chunks (raw tensor bytes and a JSON meta) of a
    ZeRO-mode snapshot restore it: parameters, moments and step."""
    from adaptdl_tpu_torch.models import TransformerConfig, init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    def make():
        model = init_transformer(
            TransformerConfig(**worker.LM_SIZES, dtype=torch.float32, remat=False),
            seed=5, device="cpu",
        )
        trainer = ElasticTrainer(lm_loss_fn, model, AdamW(model.parameters(), lr=1e-2), 8,
                                 device="cpu", **{mode: True})
        holder = {"state": trainer.init_state()}
        ck = trainer.make_checkpoint_state(lambda: holder["state"],
                                           lambda s: holder.__setitem__("state", s),
                                           name=f"handoff-{mode}")
        return trainer, holder, ck

    trainer, holder, ck = make()
    tokens = torch.as_tensor(np.random.default_rng(4).integers(0, 64, size=(8, 9)))
    for _ in range(2):
        holder["state"], _ = trainer.train_step(8, 0)(holder["state"], {"tokens": tokens})
    chunks = ck.snapshot_chunks(ck.snapshot())
    assert chunks[0][0] == "meta" and json.loads(chunks[0][1])
    ck.unregister()
    trainer2, holder2, ck2 = make()
    ck2.load_chunks(chunks)
    ck2.unregister()
    assert holder2["state"].host_step == 2
    want, got = trainer.params_tree(holder["state"]), trainer2.params_tree(holder2["state"])
    for name, p in want.items():
        assert torch.equal(got[name], p), name
    for key in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(trainer2.optimizer.state[trainer2._row][key],
                           trainer.optimizer.state[trainer._row][key]), key


@pytest.mark.parametrize("mode", ["dense", "zero1", "zero3"])
def test_params_tree_and_eval_step(mode):
    from adaptdl_tpu_torch.models import TransformerConfig, init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    model = init_transformer(
        TransformerConfig(**worker.LM_SIZES, dtype=torch.float32, remat=False), device="cpu"
    )
    names = [n for n, _ in model.named_parameters()]
    kwargs = {"zero1": {"zero1": True}, "zero3": {"zero3": True}}.get(mode, {})
    trainer = ElasticTrainer(
        lm_loss_fn, model, AdamW(model.parameters(), lr=1e-2), 8, device="cpu", **kwargs
    )
    state = trainer.init_state()
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, 64, size=(8, 9)))
    state, _ = trainer.train_step(8, 0)(state, {"tokens": tokens})
    tree = trainer.params_tree(state)
    assert list(tree) == names

    def metric_fn(m, batch):
        loss = lm_loss_fn(m, batch)
        return {"loss_sum": loss * len(batch["tokens"]), "seen": len(batch["tokens"])}

    out = trainer.eval_step(metric_fn)(state, {"tokens": tokens})
    assert int(out["seen"]) == 8 and np.isfinite(float(out["loss_sum"]))
    if mode == "zero3":
        assert all(p.untyped_storage().nbytes() == 0 for p in model.parameters())


@pytest.mark.parametrize("mode", ["zero1", "zero3"])
def test_run_step_calibrates_under_the_mode(mode):
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.models import TransformerConfig, init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    model = init_transformer(
        TransformerConfig(**worker.LM_SIZES, dtype=torch.float32, remat=False), device="cpu"
    )
    trainer = ElasticTrainer(
        lm_loss_fn, model, AdamW(model.parameters(), lr=1e-2), 8, device="cpu",
        **{mode: True},
    )
    trainer.calibrate_repeats = 1
    state = trainer.init_state()
    data = {"tokens": np.random.default_rng(11).integers(0, 64, size=(32, 9)).astype(np.int32)}
    loader = AdaptiveDataLoader(data, batch_size=8, name=f"calibrate-{mode}")
    for i, batch in enumerate(loader):
        state, m = trainer.run_step(state, batch, loader)
        if i == 1:
            break
    assert trainer._calibrated == {8}
    assert np.isfinite(float(m["loss"]))
    assert metrics.current_state().profile


def test_composition_rules(monkeypatch):
    from adaptdl_tpu_torch.examples.transformer_lm import check_zero_flags
    from adaptdl_tpu_torch.models import TransformerConfig, init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    def fresh():
        model = init_transformer(
            TransformerConfig(**worker.LM_SIZES, dtype=torch.float32, remat=False),
            device="cpu",
        )
        return model, AdamW(model.parameters(), lr=1e-2)

    model, opt = fresh()
    trainer = ElasticTrainer(lm_loss_fn, model, opt, 8, device="cpu", zero3=True)
    assert trainer.zero1 and trainer.zero3  # zero3 implies zero1
    model, opt = fresh()
    with pytest.raises(ValueError, match="storage mode of its own"):
        ElasticTrainer(lm_loss_fn, model, opt, 8, device="cpu", zero1=True,
                       zero3_blocks="blocks")
    with pytest.raises(ValueError, match="single param group"):
        ElasticTrainer(lm_loss_fn, model, opt, 8, device="cpu", zero3_blocks="blocks",
                       param_group_fn=lambda n, p: int(n.startswith("embed")))
    with pytest.raises(ValueError, match="no 'blocks' entry"):
        ElasticTrainer(lm_loss_fn, model, opt, 8, device="cpu", zero3_blocks="blocks")
    with pytest.raises(TypeError, match="meshes"):
        ElasticTrainer(lm_loss_fn, model, opt, 8, device="cpu", zero1=True, mesh=object())
    model, opt = fresh()
    model.half()
    with pytest.raises(ValueError, match="float32"):
        ElasticTrainer(lm_loss_fn, model, AdamW(model.parameters(), lr=1e-2), 8,
                       device="cpu", zero1=True)
    # Under a model or expert axis the ZeRO modes refuse with the JAX
    # trainer's messages (a mesh of two processes, checked before any
    # collective runs).
    from adaptdl_tpu_torch import collective
    from adaptdl_tpu_torch.parallel.mesh import ProcessMesh

    monkeypatch.setenv("ADAPTDL_NUM_PROCESSES", "2")
    for axis in ("model", "expert"):
        mesh = ProcessMesh({"data": 1, axis: 2}, 0, {"data": collective.SOLO, axis: None})
        model, opt = fresh()
        with pytest.raises(ValueError, match="zero1 shards optimizer state over the "
                           "data axis and composes with data/seq parallelism only"):
            ElasticTrainer(lm_loss_fn, model, opt, 8, device="cpu", zero1=True, mesh=mesh)
        with pytest.raises(ValueError, match=r"zero3_blocks shards parameter storage "
                           r"over the data axis and composes with data and sequence "
                           r"parallelism only \(model/stage/expert axes"):
            ElasticTrainer(lm_loss_fn, model, opt, 8, device="cpu",
                           zero3_blocks="blocks", mesh=mesh)
    monkeypatch.delenv("ADAPTDL_NUM_PROCESSES")

    class Flags:
        zero1 = zero3 = zero3_blocks = flash = False
        moe_experts = chunked_xent = 0

    flags = Flags()
    flags.zero3 = True
    check_zero_flags(flags)
    assert flags.zero1
    for bad in ({"zero3_blocks": True, "flash": True}, {"zero3_blocks": True, "zero1": True},
                {"zero3_blocks": True, "chunked_xent": 64}, {"zero1": True, "moe_experts": 4},
                {"zero1": True, "tp_shards": 2}, {"zero3_blocks": True, "tp_shards": 2}):
        flags = Flags()
        for k, v in bad.items():
            setattr(flags, k, v)
        with pytest.raises(AssertionError):
            check_zero_flags(flags)
