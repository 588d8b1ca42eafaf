"""The port's sharded checkpoint (``adaptdl_tpu_torch.sharded_checkpoint``,
the JAX package's ``ShardedTrainerCheckpoint`` without orbax).

Each ZeRO mode (zero1, zero3, zero3_blocks) on the 2-layer, d_model 32
LM takes three steps at two gloo ranks (``tests/torch_zero_worker.py``
under ``adaptdl_tpu_torch.launch``) and saves: every rank writes its own
rows. One replica (this process) restores that at the saved step with
the saved parameters, steps once and saves; two ranks restore that and
step once more. The result equals five uninterrupted steps at one
replica (rtol 5e-5, atol 5e-6, the JAX rescale tests' bounds), and for
zero1 also the JAX trainer's five uninterrupted zero1 steps on a
2-device mesh. Also: every rank's row is checked against its sha256
sidecar (a flipped byte makes the checkpoint unreadable), a second save
never overwrites the payload a complete checkpoint references, the
registry's pointer is JSON and a restore unpickles nothing, the hash
table's differences, and a dense trainer is refused.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.scaling_rules import AdamScale as JaxAdamScale
from adaptdl_tpu_torch import checkpoint, metrics, sharded_checkpoint
from adaptdl_tpu_torch.models import Zero3LMParams, TransformerConfig
from adaptdl_tpu_torch.weights import flax_to_state_dict
from tests import torch_zero_support as support
from tests import torch_zero_worker as worker
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

STEPS = 3
MODES = ("zero1", "zero3", "zero3_blocks")


@pytest.fixture(autouse=True)
def _port_state():
    checkpoint._reset_registry()
    metrics._reset_state()
    yield
    checkpoint._reset_registry()
    metrics._reset_state()


def _task(name, mode, **kw):
    z3b = mode == "zero3_blocks"
    task = {"kind": "train", "name": name, "model": "lm_z3b" if z3b else "lm",
            "model_file": "lm_z3b.pt" if z3b else "lm.pt", "mode": mode,
            "batches": "lm.npz", "steps": STEPS, "init_batch": 8}
    task.update(kw)
    return task


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    jax_model, params = jax_init(
        JaxConfig(**worker.LM_SIZES, max_seq_len=16, dtype=jnp.float32, remat=False),
        seq_len=8,
    )
    params = jax.device_get(params)
    dense = flax_to_state_dict(params)
    torch.save(dense, out / "lm.pt")
    z3b = Zero3LMParams.from_transformer(_dense_module(dense))
    torch.save(z3b.state_dict(), out / "lm_z3b.pt")
    rng = np.random.default_rng(2)
    np.savez(out / "lm.npz", tokens=rng.integers(0, 64, size=(STEPS + 2, 8, 9), dtype=np.int32))
    plan = [_task(f"save-{m}", m, ckpt="sharded", ckpt_dir=f"ckpt-{m}") for m in MODES]
    plan.append(_task("corrupt", "zero3", ckpt="sharded", ckpt_dir="ckpt-corrupt"))
    with open(out / "first.json", "w") as f:
        json.dump(plan, f)
    proc = support.start_ranks(out, "first")
    try:
        def jax_loss(p, batch, rng):
            tokens = batch["tokens"]
            logits = jax_model.apply({"params": p}, tokens[:, :-1], train=False)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, tokens[:, 1:]
            ).mean()

        five = {"tokens": np.load(out / "lm.npz")["tokens"]}
        reference_jax = support.jax_run(
            jax_loss, params, optax.adamw(1e-2), JaxAdamScale(), "adam", 2, five, 0, 8,
            zero1=True,
        )
    finally:
        support.finish(proc)
    ranks = {t["name"]: [torch.load(out / f"{t['name']}-rank{r}.pt") for r in (0, 1)]
             for t in plan}
    middle = {}
    for mode in MODES:
        middle[mode] = worker.train(
            _task(f"middle-{mode}", mode, ckpt="sharded", ckpt_dir=f"ckpt-{mode}",
                  first=STEPS, steps=1), str(out), 0, 1)
        checkpoint._reset_registry()
    last = [_task(f"last-{m}", m, ckpt="sharded", ckpt_dir=f"ckpt-{m}", first=STEPS + 1,
                  steps=1, save=False) for m in MODES]
    with open(out / "last.json", "w") as f:
        json.dump(last, f)
    support.finish(support.start_ranks(out, "last", restarts=2))
    for t in last:
        ranks[t["name"]] = [torch.load(out / f"{t['name']}-rank{r}.pt") for r in (0, 1)]
    return {"out": out, "ranks": ranks, "middle": middle, "jax": reference_jax}


def _dense_module(state_dict):
    from adaptdl_tpu_torch.models import TransformerLM

    model = TransformerLM(TransformerConfig(**worker.LM_SIZES, dtype=torch.float32, remat=False))
    model.load_state_dict(state_dict)
    return model


@pytest.mark.parametrize("mode", MODES)
def test_sharded_rescale_two_one_two(runs, mode):
    saved = runs["ranks"][f"save-{mode}"]
    middle = runs["middle"][mode]
    last = runs["ranks"][f"last-{mode}"]
    assert saved[0]["step"] == STEPS and middle["resumed"] == STEPS
    # One replica restored exactly the two ranks' parameters.
    for name, p in saved[0]["params"].items():
        assert torch.equal(middle["resumed_params"][name], p), name
    assert last[0]["resumed"] == STEPS + 1 and last[0]["step"] == STEPS + 2
    for name, p in last[0]["params"].items():
        assert torch.equal(p, last[1]["params"][name]), name
    reference = worker.train(_task("reference", mode, steps=STEPS + 2), str(runs["out"]), 0, 1)
    for name, p in reference["params"].items():
        np.testing.assert_allclose(
            last[0]["params"][name].numpy(), p.numpy(), rtol=5e-5, atol=5e-6, err_msg=name
        )
    if mode == "zero1":
        want = flax_to_state_dict(runs["jax"]["params"])
        for name, p in last[0]["params"].items():
            np.testing.assert_allclose(
                p.numpy(), want[name].numpy(), rtol=5e-5, atol=5e-6, err_msg=name
            )


@pytest.mark.parametrize("mode", MODES)
def test_restore_lands_on_the_saved_rows(runs, mode, tmp_path, monkeypatch):
    """One replica restores the newest payload of the rescale (the
    one-replica middle's save) again: the step and the parameters equal
    what was saved, the registry's pointer is JSON and nothing is
    unpickled."""
    src = runs["out"] / f"ckpt-{mode}"
    ckpt_dir = tmp_path / "ckpt"
    shutil.copytree(src, ckpt_dir)
    newest = checkpoint.latest_checkpoint_dir(str(ckpt_dir))
    with open(os.path.join(newest, "zero-test")) as f:
        pointer = json.load(f)
    assert set(pointer) >= {"payload_dir", "dp", "families", "small"}
    monkeypatch.setattr(pickle, "load", _refuse)
    monkeypatch.setattr(pickle, "loads", _refuse)
    monkeypatch.setattr(torch, "load", _refuse)
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(ckpt_dir))
    task = _task("replay", mode)
    weights = _weights(runs, mode)
    trainer = worker.make_trainer(task, weights)
    holder = {"state": trainer.init_state()}
    ck = sharded_checkpoint.ShardedTrainerCheckpoint(
        "zero-test", trainer, lambda: holder["state"], lambda s: holder.__setitem__("state", s))
    assert checkpoint.load_state(ck)
    ck.unregister()
    assert holder["state"].host_step == pointer["small"]["step"] == STEPS + 1
    middle = runs["middle"][mode]
    for name, p in trainer.params_tree(holder["state"]).items():
        assert torch.equal(p, middle["params"][name]), name


def _refuse(*args, **kwargs):
    raise AssertionError("a sharded restore unpickles nothing")


def _weights(runs, mode):
    name = "lm_z3b.pt" if mode == "zero3_blocks" else "lm.pt"
    with open(runs["out"] / name, "rb") as f:
        return torch.serialization.load(f)


def test_every_row_is_checked_against_its_sidecar(runs, tmp_path, monkeypatch):
    ckpt_dir = tmp_path / "ckpt"
    shutil.copytree(runs["out"] / "ckpt-corrupt", ckpt_dir)
    (payload,) = [p for p in (ckpt_dir / "sharded").iterdir() if p.is_dir()]
    sidecars = sorted(p.name for p in (ckpt_dir / "sharded").iterdir() if p.is_file())
    assert sidecars == [f"{payload.name}.rank-{r}.sha256.json" for r in (0, 1)]
    with open(f"{payload}.rank-1.sha256.json") as f:
        table = json.load(f)
    assert set(table) == {"params@1", "exp_avg@1", "exp_avg_sq@1"}
    data = bytearray((payload / "rank-1.bin").read_bytes())
    data[len(data) // 2] ^= 0x40
    (payload / "rank-1.bin").write_bytes(bytes(data))
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(ckpt_dir))
    trainer = worker.make_trainer(_task("corrupt", "zero3"), _weights(runs, "zero3"))
    holder = {"state": trainer.init_state()}
    ck = sharded_checkpoint.ShardedTrainerCheckpoint(
        "zero-test", trainer, lambda: holder["state"], lambda s: holder.__setitem__("state", s))
    with pytest.raises(checkpoint.CheckpointUnreadableError):
        checkpoint.load_state(ck)
    ck.unregister()


def test_second_save_never_clobbers_previous_payload(runs, tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    trainer = worker.make_trainer(_task("clobber", "zero1"), _weights(runs, "zero1"))
    holder = {"state": trainer.init_state()}
    ck = sharded_checkpoint.ShardedTrainerCheckpoint(
        "zero-test", trainer, lambda: holder["state"], lambda s: holder.__setitem__("state", s))
    tokens = torch.as_tensor(np.load(runs["out"] / "lm.npz")["tokens"])
    step = trainer.train_step(8, 0)

    def pointed():
        with open(os.path.join(checkpoint.latest_checkpoint_dir(str(tmp_path)), "zero-test")) as f:
            return json.load(f)["payload_dir"]

    holder["state"], _ = step(holder["state"], {"tokens": tokens[0]})
    checkpoint.save_all_states()
    first = pointed()
    first_bytes = (tmp_path / "sharded" / first / "rank-0.bin").read_bytes()
    holder["state"], _ = step(holder["state"], {"tokens": tokens[1]})
    checkpoint.save_all_states()
    second = pointed()
    assert second != first
    # The first payload stayed as it was while a checkpoint could point to it.
    assert (tmp_path / "sharded" / first / "rank-0.bin").read_bytes() == first_bytes
    holder["state"], _ = step(holder["state"], {"tokens": tokens[2]})
    checkpoint.save_all_states()
    third = pointed()
    left = sorted(p.name for p in (tmp_path / "sharded").iterdir() if p.is_dir())
    assert first not in left and second in left and third in left
    assert not any(p.name.startswith(first + ".") for p in (tmp_path / "sharded").iterdir())
    ck.unregister()


def test_shard_hash_table_and_diff():
    a = {"params": np.arange(4, dtype=np.float32), "exp_avg": np.zeros(4, np.float32)}
    table = sharded_checkpoint.shard_hash_table(a, 1)
    assert set(table) == {"params@1", "exp_avg@1"} and table["params@1"]["bytes"] == 16
    changed, nbytes = sharded_checkpoint.diff_shard_tables(None, table)
    assert sorted(changed) == ["exp_avg@1", "params@1"] and nbytes == 32
    b = dict(a, params=np.arange(4, dtype=np.float32) + 1)
    changed, nbytes = sharded_checkpoint.diff_shard_tables(
        table, sharded_checkpoint.shard_hash_table(b, 1))
    assert changed == ["params@1"] and nbytes == 16


def test_dense_trainer_is_refused(runs):
    trainer = worker.make_trainer(_task("dense", "dense"), _weights(runs, "zero1"))
    with pytest.raises(ValueError, match="TrainerCheckpoint"):
        sharded_checkpoint.ShardedTrainerCheckpoint(
            "zero-test", trainer, trainer.init_state, lambda s: None)


def test_a_fault_in_the_payload_write_leaves_the_last_checkpoint(runs, tmp_path, monkeypatch):
    """A fault while a rank writes its rows (``ckpt.sharded.payload``)
    fails the save and leaves the previous complete (pointer, payload)
    pair restorable."""
    from adaptdl_tpu_torch import faults

    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    trainer = worker.make_trainer(_task("fault", "zero3_blocks"), _weights(runs, "zero3_blocks"))
    holder = {"state": trainer.init_state()}
    ck = sharded_checkpoint.ShardedTrainerCheckpoint(
        "zero-test", trainer, lambda: holder["state"], lambda s: holder.__setitem__("state", s))
    tokens = torch.as_tensor(np.load(runs["out"] / "lm.npz")["tokens"])
    step = trainer.train_step(8, 0)
    holder["state"], _ = step(holder["state"], {"tokens": tokens[0]})
    checkpoint.save_all_states()
    saved = trainer.params_tree(holder["state"])
    holder["state"], _ = step(holder["state"], {"tokens": tokens[1]})
    faults.configure("ckpt.sharded.payload=fail@1")
    try:
        with pytest.raises(faults.InjectedFault):
            checkpoint.save_all_states()
    finally:
        faults.reset()
    ck.unregister()
    fresh = worker.make_trainer(_task("fault", "zero3_blocks"), _weights(runs, "zero3_blocks"))
    holder2 = {"state": fresh.init_state()}
    ck2 = sharded_checkpoint.ShardedTrainerCheckpoint(
        "zero-test", fresh, lambda: holder2["state"], lambda s: holder2.__setitem__("state", s))
    assert checkpoint.load_state(ck2)
    ck2.unregister()
    assert holder2["state"].host_step == 1
    for name, p in fresh.params_tree(holder2["state"]).items():
        assert torch.equal(p, saved[name]), name
