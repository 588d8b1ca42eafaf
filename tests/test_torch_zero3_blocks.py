"""Per-layer ZeRO-3 (``zero3_blocks``) in the port, against the JAX
package's ``adaptdl_tpu.parallel.zero3``, ``models.zero3_lm`` and
``ElasticTrainer(zero3_blocks="blocks")``.

- The layout: ``tree_to_rows``, ``rows_to_tree``, the flat canonical
  vector and back at dp 1, 2, 4 and 8, equal to the JAX functions on the
  JAX tests' stacked-block MLP (three blocks, d 8, h 16), whose
  parameters the port's module registers in ``ravel_pytree`` order; the
  rows' canonical segments.
- The gather Function and ``scan_blocks``: loss and row gradients equal
  to the dense model's at one rank and at two gloo ranks (the forward an
  all-gather, the backward a reduce-scatter), ``unroll`` 2 equal to 1.
- The model: the zero3 LM against the port's dense LM on the same
  weights (bit for bit) and against the JAX zero3 LM through
  ``weights.flax_zero3_lm_to_state_dict`` (rtol 1e-5).
- The step: the 2-layer, d_model 32 zero3 LM, three steps from the same
  weights at one and two replicas, accum 0 and 1, under AdamW(1e-2) +
  AdamScale + the Adam preconditioner and SGD(0.05, momentum 0.9) +
  AdaScale, against the JAX trainer in the same mode, at
  ``test_torch_multi_replica.py``'s tolerances (loss, gain, LR factor,
  progress rtol 1e-5; parameters rtol 1e-5, atol 2e-6; noise statistics
  rtol 5e-3; flat moments rtol 1e-5, atol 2e-6 of their largest,
  compared through ``weights.flat_order_map``).
- The storage in rows, a rescale 2 -> 1 -> 2, the three cross-mode
  restores (dense -> zero3_blocks, zero3_blocks -> zero3, a dense
  ``TransformerLM`` -> the zero3 LM), ``eval_step``/``params_tree`` and
  calibration through ``run_step``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models import init_zero3_lm as jax_init_zero3_lm
from adaptdl_tpu.parallel import zero3 as jax_zero3
from adaptdl_tpu.scaling_rules import AdamScale as JaxAdamScale
from adaptdl_tpu.scaling_rules import AdaScale as JaxAdaScale
from adaptdl_tpu_torch import checkpoint, metrics
from adaptdl_tpu_torch.parallel import zero3
from adaptdl_tpu_torch.weights import flat_order_map, flax_zero3_lm_to_state_dict
from tests import torch_zero_support as support
from tests import torch_zero_worker as worker
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

STEPS = 3


@pytest.fixture(autouse=True)
def _port_state():
    checkpoint._reset_registry()
    metrics._reset_state()
    yield
    checkpoint._reset_registry()
    metrics._reset_state()


def _mlp_params(L=3, d=8, h=16, seed=0):
    """The JAX tests' toy (tests/test_zero3_blocks.py::_mlp_setup)."""
    rng = np.random.default_rng(seed)
    return {
        "inp": (rng.normal(size=(d, d)) * 0.3).astype(np.float32),
        "blocks": {
            "w1": (rng.normal(size=(L, d, h)) * 0.3).astype(np.float32),
            "b1": np.zeros((L, h), np.float32),
            "w2": (rng.normal(size=(L, h, d)) * 0.3).astype(np.float32),
            "b2": np.zeros((L, d), np.float32),
        },
        "out": (rng.normal(size=(d, d)) * 0.3).astype(np.float32),
    }


def _mlp_state_dict(params):
    out = {f"blocks.{k}": torch.tensor(params["blocks"][k]) for k in ("b1", "b2", "w1", "w2")}
    out["inp.w"], out["out.w"] = torch.tensor(params["inp"]), torch.tensor(params["out"])
    return out


def _mlp_module(params):
    model = worker.ToyMLP()
    model.load_state_dict(_mlp_state_dict(params))
    return model


def _mlp_batch(seed=0, B=16, d=8, steps=1):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(steps, B, d)).astype(np.float32),
        "y": rng.normal(size=(steps, B, d)).astype(np.float32),
    }


def _jax_config():
    return JaxConfig(**worker.LM_SIZES, max_seq_len=16, dtype=jnp.float32, remat=False)


def _jax_opt(kind):
    if kind == "sgd":
        return optax.sgd(0.05, momentum=0.9), JaxAdaScale(), None
    return optax.adamw(1e-2), JaxAdamScale(), "adam"


def _task(name, **kw):
    task = {"kind": "train", "name": name, "model": "lm_z3b", "model_file": "lm_z3b.pt",
            "mode": "zero3_blocks", "batches": "lm.npz", "steps": STEPS, "init_batch": 8}
    task.update(kw)
    return task


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("z3b")
    jax_loss, jax_params = jax_init_zero3_lm(_jax_config(), seq_len=8)
    jax_params = jax.device_get(jax_params)
    torch.save(flax_zero3_lm_to_state_dict(jax_params), out / "lm_z3b.pt")
    torch.save(_mlp_state_dict(_mlp_params()), out / "mlp.pt")
    np.savez(out / "mlp.npz", **_mlp_batch())
    rng = np.random.default_rng(1)
    np.savez(out / "lm.npz", tokens=rng.integers(0, 64, size=(STEPS + 2, 8, 9), dtype=np.int32))
    plan = [{"kind": "scan", "name": "scan", "model_file": "mlp.pt", "batches": "mlp.npz"}]
    for accum in (0, 1):
        for opt in ("adamw", "sgd"):
            plan.append(_task(f"lm-{accum}-{opt}", accum=accum, opt=opt))
    plan.append(_task("save", ckpt="trainer", ckpt_dir="ckpt"))
    with open(out / "first.json", "w") as f:
        json.dump(plan, f)
    proc = support.start_ranks(out, "first")
    three = {"tokens": np.load(out / "lm.npz")["tokens"][:STEPS]}
    reference = {}
    try:
        for dp in (1, 2):
            for accum in (0, 1):
                for opt in ("adamw", "sgd"):
                    optimizer, rule, precond = _jax_opt(opt)
                    reference[(dp, accum, opt)] = support.jax_run(
                        jax_loss, jax_params, optimizer, rule, precond, dp, three, accum, 8,
                        zero3_blocks="blocks",
                    )
    finally:
        support.finish(proc)
    ranks = {t["name"]: [torch.load(out / f"{t['name']}-rank{r}.pt") for r in (0, 1)]
             for t in plan}
    middle = worker.train(
        _task("middle", ckpt="trainer", ckpt_dir="ckpt", first=STEPS, steps=1), str(out), 0, 1
    )
    checkpoint._reset_registry()
    last = [_task("last", ckpt="trainer", ckpt_dir="ckpt", first=STEPS + 1, steps=1, save=False)]
    with open(out / "last.json", "w") as f:
        json.dump(last, f)
    support.finish(support.start_ranks(out, "last", restarts=2))
    ranks["last"] = [torch.load(out / f"last-rank{r}.pt") for r in (0, 1)]
    names = list(ranks["save"][0]["params"])
    perm = flat_order_map(jax_params, flax_zero3_lm_to_state_dict, names)
    return {"out": out, "ranks": ranks, "jax": reference, "middle": middle,
            "perm": perm, "jax_params": jax_params, "jax_loss": jax_loss}


# ---- the layout ----------------------------------------------------------


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_layout_roundtrips_across_dp_as_the_jax_layout(dp):
    params = _mlp_params(seed=3)
    jspec = jax_zero3.block_spec(params, "blocks")
    jb, jo = jax_zero3.tree_to_rows(params, "blocks", jspec, dp)
    model = _mlp_module(params)
    spec = zero3.block_spec(model, "blocks")
    assert zero3.shard_sizes(spec, dp) == jax_zero3.shard_sizes(jspec, dp)
    b, o = zero3.tree_to_rows(model, "blocks", spec, dp)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    tree = zero3.rows_to_tree(b, o, "blocks", spec)
    for name, p in model.named_parameters():
        assert torch.equal(tree[name], p.detach()), name
    flat = zero3.rows_to_flat_canonical(b, o, "blocks", spec)
    jflat = jax_zero3.rows_to_flat_canonical(jb, jo, "blocks", jspec)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back_b, back_o = zero3.flat_canonical_to_rows(flat, "blocks", spec, dp)
    assert torch.equal(back_b, b) and torch.equal(back_o, o)
    # Each rank's canonical segments cover the vector once and read its rows.
    covered = torch.zeros(spec.n_total, dtype=torch.int64)
    for rank in range(dp):
        row = torch.cat([b[:, rank].reshape(-1), o[rank]])
        for start, length, offset in zero3.row_segments(spec, rank, dp):
            covered[start : start + length] += 1
            assert torch.equal(row[offset : offset + length], flat[start : start + length])
    assert covered.eq(1).all()


def test_stack_layers_maps_a_dense_lm_onto_the_blocks():
    from adaptdl_tpu_torch.models import TransformerConfig, Zero3LMParams, init_transformer

    cfg = TransformerConfig(**worker.LM_SIZES, dtype=torch.float32, remat=False)
    dense = init_transformer(cfg, seed=4, device="cpu")
    params = Zero3LMParams.from_transformer(dense)
    tree = dict(dense.named_parameters())
    assert torch.equal(params.blocks.attention.qkv.weight[1],
                       tree["layers.1.attention.qkv.weight"])
    spec = zero3.block_spec(params, "blocks")
    assert zero3.stack_layers({"x.0.y": torch.zeros(1)}, spec) is None
    assert list(zero3.stack_layers(tree, spec)) == list(spec.names)


# ---- the gather and the layer loop -----------------------------------------


def _mlp_dense_reference():
    model = _mlp_module(_mlp_params())
    batch = {k: torch.as_tensor(v[0]) for k, v in _mlp_batch().items()}
    loss = worker.mlp_dense_loss(model, batch)
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    return loss, grads, model, batch


@pytest.mark.parametrize("unroll", [1, 2])
def test_scan_blocks_matches_dense_forward_and_grad_at_one_rank(unroll):
    loss_d, grads_d, model, batch = _mlp_dense_reference()
    spec = zero3.block_spec(model, "blocks")
    b, o = zero3.tree_to_rows(model, "blocks", spec, 1)
    b, o = b[:, 0].clone().requires_grad_(), o[0].clone().requires_grad_()
    loss = worker.mlp_z3b_loss(spec, unroll)(zero3.build_view(b, o, spec), batch)
    gb, go = torch.autograd.grad(loss, [b, o])
    assert torch.equal(loss, loss_d)
    tree = zero3.rows_to_tree(gb[:, None], go[None], "blocks", spec)
    for name, g in grads_d.items():
        np.testing.assert_allclose(tree[name].numpy(), g.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("unroll", [1, 2])
def test_gather_function_at_two_ranks_matches_dense(runs, unroll):
    """Two gloo ranks, each on half the batch: the summed losses and the
    reduce-scattered row gradients (over dp) equal the dense model's on
    the whole batch; unroll 2 equals unroll 1."""
    loss_d, grads_d, model, _ = _mlp_dense_reference()
    spec = zero3.block_spec(model, "blocks")
    ranks = runs["ranks"]["scan"]
    b = torch.stack([r[unroll]["blocks"] for r in ranks], dim=1)
    o = torch.stack([r[unroll]["other"] for r in ranks])
    np.testing.assert_allclose(float(ranks[0][unroll]["loss"]), float(loss_d.detach()), rtol=1e-6)
    tree = zero3.rows_to_tree(b, o, "blocks", spec)
    for name, g in grads_d.items():
        np.testing.assert_allclose(tree[name].numpy(), g.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for key in ("blocks", "other"):
        np.testing.assert_allclose(
            ranks[0][2][key].numpy(), ranks[0][1][key].numpy(), rtol=1e-6, atol=1e-7
        )


# ---- the model ---------------------------------------------------------------


def test_zero3_lm_matches_the_dense_lm_and_the_jax_model(runs):
    from adaptdl_tpu_torch.models import (
        TransformerConfig, TransformerLM, Zero3LMParams, zero3_lm_loss_fn, zero3_lm_metric_fn,
    )

    cfg = TransformerConfig(**worker.LM_SIZES, dtype=torch.float32, remat=False)
    params = Zero3LMParams(cfg)
    params.load_state_dict(torch.load(runs["out"] / "lm_z3b.pt"))
    spec = zero3.block_spec(params, "blocks")
    b, o = zero3.tree_to_rows(params, "blocks", spec, 1)
    view = zero3.build_view(b[:, 0], o[0], spec)
    tokens = np.random.default_rng(5).integers(0, 64, size=(4, 9)).astype(np.int32)
    loss_fn = zero3_lm_loss_fn(params)
    logits = loss_fn.forward(view, torch.as_tensor(tokens[:, :-1]))
    # The dense LM on the same weights, layer by layer.
    dense = TransformerLM(cfg)
    names = {f"layers.{i}.{n[len('blocks.'):]}": (n, i)
             for n in spec.names if n.startswith("blocks.") for i in range(cfg.num_layers)}
    tree = dict(params.named_parameters())
    dense.load_state_dict({
        k: (tree[names[k][0]][names[k][1]] if k in names else tree[k])
        for k in dict(dense.named_parameters())
    })
    assert torch.equal(logits, dense(torch.as_tensor(tokens[:, :-1])))
    # The JAX zero3 LM on the converted weights.
    from jax.sharding import PartitionSpec as P

    from adaptdl_tpu.parallel import create_mesh

    jspec = jax_zero3.block_spec(runs["jax_params"], "blocks")
    jb, jo = jax_zero3.tree_to_rows(runs["jax_params"], "blocks", jspec, 1)
    patch = support.bind_pcast()
    try:
        forward = jax.jit(jax.shard_map(
            lambda bb, oo, t: runs["jax_loss"].forward(jax_zero3.build_view(bb, oo, jspec), t),
            mesh=create_mesh({"data": 1}, devices=jax.devices()[:1]),
            in_specs=(P(None, "data"), P("data"), P("data")), out_specs=P("data"),
        ))
        want = np.asarray(forward(jb, jo, tokens[:, :-1]))
    finally:
        patch.undo()
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    out = zero3_lm_metric_fn(loss_fn)(view, {"tokens": torch.as_tensor(tokens)})
    assert int(out["seen"]) == 4 * 8 and np.isfinite(float(out["loss_sum"]))


def test_flat_order_map_relates_the_two_canonical_vectors(runs):
    from jax.flatten_util import ravel_pytree

    from adaptdl_tpu_torch.models import TransformerConfig, Zero3LMParams

    weights = torch.load(runs["out"] / "lm_z3b.pt")
    names = [n for n, _ in Zero3LMParams(
        TransformerConfig(**worker.LM_SIZES, dtype=torch.float32)).named_parameters()]
    assert list(weights) == names
    port_flat = torch.cat([weights[n].reshape(-1) for n in names]).numpy()
    jax_flat = np.asarray(ravel_pytree(runs["jax_params"])[0])
    assert sorted(runs["perm"].tolist()) == list(range(len(jax_flat)))
    np.testing.assert_array_equal(jax_flat[runs["perm"]], port_flat)


# ---- the step ------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
@pytest.mark.parametrize("accum", [0, 1])
@pytest.mark.parametrize("dp", [1, 2])
def test_z3b_step_matches_jax(runs, dp, accum, opt):
    want = runs["jax"][(dp, accum, opt)]
    if dp == 1:
        got = worker.train(_task(f"lm-{accum}-{opt}", accum=accum, opt=opt),
                           str(runs["out"]), 0, 1)
    else:
        ranks = runs["ranks"][f"lm-{accum}-{opt}"]
        for name, p in ranks[0]["params"].items():
            assert torch.equal(p, ranks[1]["params"][name]), name
        got = ranks[0]
    support.assert_steps_match(got["steps"], want["steps"])
    support.assert_params_match(got["params"], flax_zero3_lm_to_state_dict(want["params"]))
    support.assert_gns_match(got["gns"], want)
    support.assert_moments_match(got["moments"], want["moments"], runs["perm"])


def test_z3b_storage_is_rows(runs):
    """Parameters, moments and the differenced carry persist as this
    rank's rows (1/dp of every padded block and of the rest); the module's
    own parameters are released."""
    for rank, got in enumerate(runs["ranks"]["lm-0-adamw"]):
        facts = got["facts"]
        weights = torch.load(runs["out"] / "lm_z3b.pt")
        from adaptdl_tpu_torch.models import TransformerConfig, Zero3LMParams

        params = Zero3LMParams(TransformerConfig(**worker.LM_SIZES, dtype=torch.float32))
        params.load_state_dict(weights)
        spec = zero3.block_spec(params, "blocks")
        sb, so = zero3.shard_sizes(spec, 2)
        rows = [[spec.num_blocks, sb], [so]]
        assert facts["rows"] == rows
        assert facts["moments"] == {"exp_avg": rows, "exp_avg_sq": rows}
        assert facts["prev_grad"] == rows
        assert all(facts["released"])


def test_z3b_rescale_two_one_two(runs):
    """Three steps at two ranks and a save; one rank restores it (with the
    primed carry) and steps once; two ranks restore that and step once:
    the parameters equal five uninterrupted steps at one replica."""
    middle, last = runs["middle"], runs["ranks"]["last"]
    assert middle["resumed"] == STEPS and last[0]["resumed"] == STEPS + 1
    for name, p in runs["ranks"]["save"][0]["params"].items():
        assert torch.equal(middle["resumed_params"][name], p), name
    for name, p in middle["params"].items():
        assert torch.equal(last[0]["resumed_params"][name], p), name
    for name, p in last[0]["params"].items():
        assert torch.equal(p, last[1]["params"][name]), name
    reference = worker.train(_task("reference", steps=STEPS + 2), str(runs["out"]), 0, 1)
    for name, p in reference["params"].items():
        np.testing.assert_allclose(
            last[0]["params"][name].numpy(), p.numpy(), rtol=5e-5, atol=5e-6, err_msg=name
        )


# ---- cross-mode restores (one replica) ---------------------------------------------


def _mlp_trainer(mode, params=None):
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    model = _mlp_module(params or _mlp_params(seed=21))
    spec = zero3.block_spec(model, "blocks")
    loss = worker.mlp_z3b_loss(spec) if mode == "zero3_blocks" else worker.mlp_dense_loss
    kwargs = {"zero3": {"zero3": True},
              "zero3_blocks": {"zero3_blocks": "blocks"}}.get(mode, {})
    return ElasticTrainer(loss, model, AdamW(model.parameters(), lr=1e-2), 16,
                          device="cpu", **kwargs)


def _drive(trainer, holder, first, count):
    batches = _mlp_batch(seed=9, steps=5)
    step = trainer.train_step(16, 0)
    for i in range(first, first + count):
        holder["state"], m = step(
            holder["state"], {k: torch.as_tensor(v[i]) for k, v in batches.items()}
        )
    return m


def _save_and_restore(tmp_path, monkeypatch, first, second):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    holder = {"state": first.init_state()}
    ck = first.make_checkpoint_state(lambda: holder["state"],
                                     lambda s: holder.__setitem__("state", s), name="cross")
    _drive(first, holder, 0, 3)
    checkpoint.save_all_states()
    ck.unregister()
    holder2 = {"state": second.init_state()}
    ck2 = second.make_checkpoint_state(lambda: holder2["state"],
                                       lambda s: holder2.__setitem__("state", s), name="cross")
    assert checkpoint.load_state(ck2)
    ck2.unregister()
    assert int(holder2["state"].step) == 3
    return holder, holder2


def test_dense_checkpoint_into_z3b(tmp_path, monkeypatch):
    dense, z3b = _mlp_trainer("dense"), _mlp_trainer("zero3_blocks")
    holder, holder2 = _save_and_restore(tmp_path, monkeypatch, dense, z3b)
    assert set(z3b.optimizer.state[z3b._rows[0]]) == {"step", "exp_avg", "exp_avg_sq"}
    assert not bool(holder2["state"].gns.prev_grad_valid)  # the carry re-primes
    _drive(z3b, holder2, 3, 2)
    _drive(dense, holder, 3, 2)
    got = z3b.params_tree(holder2["state"])
    for name, p in dense.params_tree(holder["state"]).items():
        np.testing.assert_allclose(got[name].numpy(), p.numpy(), rtol=5e-5, atol=5e-6,
                                   err_msg=name)


def test_z3b_checkpoint_into_zero3(tmp_path, monkeypatch):
    z3b, lite = _mlp_trainer("zero3_blocks"), _mlp_trainer("zero3")
    holder, holder2 = _save_and_restore(tmp_path, monkeypatch, z3b, lite)
    before, after = z3b.params_tree(holder["state"]), lite.params_tree(holder2["state"])
    for name, p in before.items():
        assert torch.equal(after[name], p), name
    want = z3b.layout.gather(z3b.row_families(holder["state"])["exp_avg_sq"])
    got = lite.layout.gather(lite.row_families(holder2["state"])["exp_avg_sq"])
    assert torch.equal(got, want)
    assert not bool(holder2["state"].gns.prev_grad_valid)
    m = _drive(lite, holder2, 3, 1)
    assert np.isfinite(float(m["loss"]))


def test_dense_transformer_checkpoint_into_z3b_lm(tmp_path, monkeypatch):
    from adaptdl_tpu_torch.models import (
        TransformerConfig, init_transformer, init_zero3_lm, lm_loss_fn,
    )
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    cfg = TransformerConfig(**worker.LM_SIZES, dtype=torch.float32, remat=False)
    tokens = np.random.default_rng(17).integers(0, 64, size=(8, 9))
    model = init_transformer(cfg, seed=1, device="cpu")
    dense = ElasticTrainer(lm_loss_fn, model, AdamW(model.parameters(), lr=1e-2), 8,
                           device="cpu")
    holder = {"state": dense.init_state()}
    ck = dense.make_checkpoint_state(lambda: holder["state"],
                                     lambda s: holder.__setitem__("state", s), name="lm")
    for _ in range(3):
        holder["state"], m_d = dense.train_step(8, 0)(holder["state"], {"tokens": torch.as_tensor(tokens)})
    checkpoint.save_all_states()
    ck.unregister()
    loss_fn, params = init_zero3_lm(cfg, seed=2, device="cpu")
    z3b = ElasticTrainer(loss_fn, params, AdamW(params.parameters(), lr=1e-2), 8,
                         device="cpu", zero3_blocks="blocks")
    holder2 = {"state": z3b.init_state()}
    ck2 = z3b.make_checkpoint_state(lambda: holder2["state"],
                                    lambda s: holder2.__setitem__("state", s), name="lm")
    assert checkpoint.load_state(ck2)
    ck2.unregister()
    assert int(holder2["state"].step) == 3
    restored = z3b.params_tree(holder2["state"])
    stacked = zero3.stack_layers(dense.params_tree(holder["state"]), z3b._spec)
    for name, p in stacked.items():
        assert torch.equal(restored[name], p), name
    # Both continue identically (the same function of the same state).
    holder["state"], m1 = dense.train_step(8, 0)(holder["state"], {"tokens": torch.as_tensor(tokens)})
    holder2["state"], m2 = z3b.train_step(8, 0)(holder2["state"], {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    assert float(m2["loss"]) < float(m_d["loss"]) + 1.0


# ---- evaluation, the tree, calibration --------------------------------------------------


def test_z3b_eval_params_tree_and_run_step():
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.models import TransformerConfig, init_zero3_lm, zero3_lm_metric_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    cfg = TransformerConfig(**worker.LM_SIZES, dtype=torch.float32, remat=False)
    loss_fn, params = init_zero3_lm(cfg, seed=0, device="cpu")
    names = [n for n, _ in params.named_parameters()]
    trainer = ElasticTrainer(loss_fn, params, AdamW(params.parameters(), lr=1e-2), 8,
                             device="cpu", zero3_blocks="blocks")
    trainer.calibrate_repeats = 1
    state = trainer.init_state()
    data = {"tokens": np.random.default_rng(11).integers(0, 64, size=(64, 9)).astype(np.int32)}
    loader = AdaptiveDataLoader(data, batch_size=8, name="z3b-loader")
    for i, batch in enumerate(loader):
        state, m = trainer.run_step(state, batch, loader)
        if i == 1:
            break
    assert trainer._calibrated == {8} and np.isfinite(float(m["loss"]))
    out = trainer.eval_step(zero3_lm_metric_fn(loss_fn))(
        state, {"tokens": torch.as_tensor(data["tokens"][:8])}
    )
    assert int(out["seen"]) == 8 * 8 and np.isfinite(float(out["loss_sum"]))
    tree = trainer.params_tree(state)
    assert list(tree) == names
    assert tree["blocks.ff_up.weight"].shape == (2, 64, 32)
