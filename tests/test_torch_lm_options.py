"""The LM's one-card options in the port: remat policies, parameter
groups, and the examples' flags.

- Remat: under every jax.checkpoint_policies name the JAX model takes,
  the port's gradients equal those without remat at atol 1e-6 (dense
  with flash attention, and MoE); an unknown name raises in both
  packages.
- Parameter groups: the port's trainer and the JAX trainer (one
  replica, accum_steps 1) on the JAX tests' two-group problem, SGD(0.05)
  under AdaScale: per-group noise statistics and LR factors at rtol
  1e-5 over the same steps, parameters too. Putting every parameter in
  group 0 is bit-equal to no groups; a one-group checkpoint restores
  into a grouped trainer.
- The examples: the LM with ``--moe-experts --moe-top-k --chunked-xent
  --remat-policy``, BERT with ``--moe-router experts``, on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.parallel import create_mesh
from adaptdl_tpu.scaling_rules import AdaScale as JaxAdaScale
from adaptdl_tpu.scaling_rules import RuleContext as JaxRuleContext
from adaptdl_tpu.trainer import ElasticTrainer as JaxTrainer
from adaptdl_tpu_torch import _signal, checkpoint, epoch, gns, metrics
from adaptdl_tpu_torch.models import TransformerConfig, TransformerLM, lm_loss_fn
from adaptdl_tpu_torch.models.transformer import REMAT_POLICIES
from adaptdl_tpu_torch.ops import make_flash_attention
from adaptdl_tpu_torch.optim import SGD
from adaptdl_tpu_torch.scaling_rules import AdaScale, RuleContext
from adaptdl_tpu_torch.trainer import ElasticTrainer
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401



@pytest.fixture(autouse=True)
def _port_state():
    def reset():
        checkpoint._reset_registry()
        metrics._reset_state()
        epoch._reset_state()
        _signal.set_exit_flag(False)

    reset()
    yield
    reset()


# -- remat policies ----------------------------------------------------------

SIZES = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64)
VARIANTS = {
    "flash": dict(attention_fn=make_flash_attention(block_q=8, block_k=8)),
    "moe": dict(moe_every_n=1, moe_num_experts=4, moe_top_k=2),
}


def _grads(config):
    torch.manual_seed(0)
    model = TransformerLM(config)
    model.load_state_dict(_grads.state)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 64, (2, 17), dtype=np.int64)
    )
    lm_loss_fn(model, {"tokens": tokens}).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_remat_policy_gradients_equal_no_remat(policy, variant):
    base = TransformerConfig(**SIZES, **VARIANTS[variant], dtype=torch.float32, remat=False)
    _grads.state = TransformerLM(base).state_dict()
    for t in _grads.state.values():
        torch.nn.init.normal_(t, 0.0, 0.2)
    want = _grads(base)
    got = _grads(dataclasses.replace(base, remat=True, remat_policy=policy))
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=1e-6, err_msg=name)


def test_unknown_remat_policy_raises_in_both():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TransformerConfig(**SIZES, remat_policy="save_only_these_names")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        jax_init(JaxConfig(**SIZES, max_seq_len=16, remat_policy="save_only_these_names"),
                 seq_len=16)
    assert set(REMAT_POLICIES) == {
        "everything_saveable", "nothing_saveable", "dots_saveable", "checkpoint_dots",
        "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims",
    }


def test_remat_policies_save_what_they_name():
    """Counted in the dispatcher over a forward and backward: full remat
    runs every matrix product of a block again; the no-batch-dims
    policies save mm/addmm and run only the batched (attention) products
    again; the dots policies save bmm too, as everything_saveable does,
    which recomputes nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountDots(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                        torch.ops.aten.bmm.default):
                CountDots.count += 1
            return func(*args, **(kwargs or {}))

    base = TransformerConfig(**SIZES, dtype=torch.float32, remat=True)
    tokens = torch.zeros((2, 16), dtype=torch.int64)
    counts = {}
    for policy in sorted(REMAT_POLICIES):
        model = TransformerLM(dataclasses.replace(base, remat_policy=policy))
        CountDots.count = 0
        with CountDots():
            model(tokens).sum().backward()
        counts[policy] = CountDots.count
    assert counts["nothing_saveable"] > counts["dots_with_no_batch_dims_saveable"]
    assert counts["dots_with_no_batch_dims_saveable"] > counts["dots_saveable"]
    assert counts["dots_saveable"] == counts["everything_saveable"]
    assert counts["dots_saveable"] == counts["checkpoint_dots"]
    assert (counts["dots_with_no_batch_dims_saveable"]
            == counts["checkpoint_dots_with_no_batch_dims"])


# -- parameter groups --------------------------------------------------------


def _group_data():
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=4).astype(np.float32)
    data = {
        "x": rng.normal(size=(512, 4)).astype(np.float32),
        "z": rng.normal(size=(512, 4)).astype(np.float32),
    }
    data["y_clean"] = (data["x"] @ w_true).astype(np.float32)
    data["y_noisy"] = rng.normal(size=512).astype(np.float32)
    batches = [
        {k: v[idx] for k, v in data.items()}
        for idx in (rng.integers(0, 512, size=16) for _ in range(12))
    ]
    return batches


class _TwoGroups(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w_clean = torch.nn.Parameter(torch.zeros(4))
        self.w_noisy = torch.nn.Parameter(torch.zeros(4))


def _two_group_loss(model, batch, generator=None):
    clean = torch.mean((batch["x"] @ model.w_clean - batch["y_clean"]) ** 2)
    noisy = torch.mean((batch["z"] @ model.w_noisy - batch["y_noisy"]) ** 2)
    return clean + noisy


def _port_group_trainer(param_group_fn, seed=0):
    model = _TwoGroups()
    return ElasticTrainer(
        _two_group_loss, model, SGD(model.parameters(), lr=0.05), 16,
        scaling_rule=AdaScale(), param_group_fn=param_group_fn, device="cpu",
        seed=seed,
    )


def _by_name(name, param):
    return 0 if "clean" in name else 1


def test_param_groups_match_jax(monkeypatch):
    import adaptdl_tpu.trainer as jax_trainer_mod

    monkeypatch.setattr(
        jax_trainer_mod, "_pcast", lambda x, axes, to: jax.lax.pcast(x, axes, to=to)
    )

    def jloss(params, batch, _rng):
        clean = jnp.mean((batch["x"] @ params["w_clean"] - batch["y_clean"]) ** 2)
        noisy = jnp.mean((batch["z"] @ params["w_noisy"] - batch["y_noisy"]) ** 2)
        return clean + noisy

    jtrainer = JaxTrainer(
        jloss, {"w_clean": jnp.zeros(4), "w_noisy": jnp.zeros(4)}, optax.sgd(0.05), 16,
        scaling_rule=JaxAdaScale(), mesh=create_mesh(devices=jax.devices()[:1]),
        param_group_fn=lambda path, leaf: 0 if "clean" in str(path[-1]) else 1,
    )
    trainer = _port_group_trainer(_by_name)
    assert trainer.num_param_groups == jtrainer.num_param_groups == 2
    jstate, state = jtrainer.init_state(), trainer.init_state()
    jstep, step = jtrainer.train_step(8, 1), trainer.train_step(8, 1)
    for batch in _group_data():
        jstate, jm = jstep(jstate, jtrainer.shard_batch(batch))
        state, m = step(state, trainer.to_device(batch))
        for fn in ("raw_sqr_avg", "raw_var_avg"):
            want = np.asarray(getattr(jax_trainer_mod.gns, fn)(jstate.gns))
            got = getattr(gns, fn)(state.gns).numpy()
            assert got.shape == (2,)
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=fn)
        ctx = dict(scale=2.0, batch_size=32, init_batch_size=16)
        want = JaxAdaScale().lr_factor_groups(
            JaxRuleContext(**ctx, gns_state=jstate.gns, progress=jstate.progress)
        )
        got = AdaScale().lr_factor_groups(
            RuleContext(**ctx, gns_state=state.gns, progress=state.progress)
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        np.testing.assert_allclose(float(m["gain"]), float(jm["gain"]), rtol=1e-5)
    for name in ("w_clean", "w_noisy"):
        np.testing.assert_allclose(
            getattr(trainer.model, name).detach().numpy(),
            np.asarray(jstate.params[name]), rtol=1e-5, atol=1e-6,
        )
    # The noisy group's noise-to-signal ratio is the larger, and so is
    # its factor.
    assert got[1] > got[0]


def test_one_group_fn_is_bit_equal_to_no_groups():
    runs = []
    for fn in (None, lambda name, p: 0):
        trainer = _port_group_trainer(fn)
        state = trainer.init_state()
        step = trainer.train_step(8, 1)
        for batch in _group_data()[:4]:
            state, _ = step(state, trainer.to_device(batch))
        runs.append((trainer.model.state_dict(), state.gns.tensors()))
    (params_a, gns_a), (params_b, gns_b) = runs
    for k in params_a:
        assert torch.equal(params_a[k], params_b[k]), k
    for k in gns_a:
        pairs = zip(gns_a[k], gns_b[k]) if k == "prev_grad" else [(gns_a[k], gns_b[k])]
        assert all(torch.equal(x, y) for x, y in pairs), k


def test_group_ids_must_be_contiguous():
    with pytest.raises(ValueError, match="contiguous group ids"):
        _port_group_trainer(lambda name, p: 0 if "clean" in name else 2)


def test_one_group_checkpoint_restores_into_a_grouped_trainer(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    trainer = _port_group_trainer(None)
    holder = {"state": trainer.init_state()}
    step = trainer.train_step(8, 1)
    for batch in _group_data()[:3]:
        holder["state"], _ = step(holder["state"], trainer.to_device(batch))
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    checkpoint.save_all_states()
    saved = holder["state"].gns
    ckpt.unregister()

    grouped = _port_group_trainer(_by_name)
    held = {"state": grouped.init_state()}
    ckpt2 = grouped.make_checkpoint_state(
        lambda: held["state"], lambda s: held.__setitem__("state", s)
    )
    assert checkpoint.load_state(ckpt2)
    restored = held["state"].gns
    assert restored.sqr_biased.shape == (2,)
    for field in ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias"):
        np.testing.assert_array_equal(
            getattr(restored, field).numpy(), np.repeat(getattr(saved, field).numpy(), 2)
        )
    held["state"], m = grouped.train_step(8, 1)(held["state"], grouped.to_device(_group_data()[5]))
    assert np.isfinite(float(m["gain"]))
    # A grouped checkpoint does not restore into a trainer grouped
    # otherwise: its load raises, and the job refuses to start.
    checkpoint.save_all_states()
    ckpt2.unregister()
    other = _port_group_trainer(lambda name, p: 1 if "clean" in name else 0)
    kept = {"state": other.init_state()}
    ckpt3 = other.make_checkpoint_state(
        lambda: kept["state"], lambda s: kept.__setitem__("state", s)
    )
    payload = {"group_ids": [0, 1]}
    with pytest.raises(ValueError, match="parameter groups differ"):
        ckpt3._apply(payload)
    with pytest.raises(checkpoint.CheckpointUnreadableError):
        checkpoint.load_state(ckpt3)
    assert int(kept["state"].step) == 0


def test_normalize_groups_matches_jax():
    from adaptdl_tpu import gns as jgns

    state = gns.init([torch.zeros(2)], num_groups=1)
    state = dataclasses.replace(
        state, sqr_biased=torch.tensor([0.5]), var_biased=torch.tensor(0.25)
    )
    fixed = gns.normalize_groups(state, 3)
    want = jgns.normalize_groups(
        jgns.init({"w": jnp.zeros(2)}, num_groups=1)._replace(
            sqr_biased=np.float32(0.5), var_biased=np.float32(0.25)
        ), 3,
    )
    for field in ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias"):
        np.testing.assert_array_equal(getattr(fixed, field).numpy(), getattr(want, field))
    with pytest.raises(ValueError, match="groups"):
        gns.normalize_groups(fixed, 2)


# -- the examples' flags ------------------------------------------------------


def test_lm_example_takes_moe_chunked_and_remat_flags(tmp_path, monkeypatch, capsys):
    from adaptdl_tpu_torch.examples import transformer_lm

    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    transformer_lm.main([
        "--cpu", "--epochs", "1", "--moe-experts", "4", "--moe-top-k", "2",
        "--chunked-xent", "64", "--remat-policy", "dots_with_no_batch_dims_saveable",
    ])
    loss = float(capsys.readouterr().out.split("loss=")[1].split()[0])
    assert np.isfinite(loss) and loss < np.log(256)
    config = transformer_lm.lm_config(True, 32, False, "checkpoint_dots", 8, 2)
    assert (config.moe_every_n, config.moe_num_experts, config.moe_top_k) == (2, 8, 2)
    assert config.remat_policy == "checkpoint_dots"
    with pytest.raises(ValueError, match="--seq-shards 2 runs one process per chip"):
        transformer_lm.main(["--cpu", "--seq-shards", "2"])


def test_bert_example_takes_expert_choice(tmp_path, monkeypatch):
    from adaptdl_tpu_torch.examples import bert_mlm

    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    state = bert_mlm.main([
        "--cpu", "--epochs", "1", "--seq-len", "8", "--moe-experts", "4",
        "--moe-router", "experts",
    ])
    model = state.model
    assert model.config.moe_router == "experts" and not model.config.causal
    assert [hasattr(b, "moe") for b in model.layers] == [False, True]
    assert all(torch.isfinite(p).all() for p in model.parameters())
