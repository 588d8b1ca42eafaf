"""The port's elastic training step against the JAX package's, and the
port's elastic resume.

Parity: the JAX ``ElasticTrainer.train_step`` (one-device mesh) and the
port's run three steps from the
same converted parameters on the same batches, with ``adamw(3e-4)``,
``AdamScale``, ``precondition="adam"`` and accum_steps 0 and 1. Loss,
parameters, the GNS statistics, gain and progress must agree. The models
use plain attention here: flash attention's forward and gradients are
held to the JAX kernel in test_torch_flash_attention.py and
test_torch_transformer.py, and the resume test below trains through it.
Tolerances: loss, parameters, gain, LR factor and progress rtol 1e-5
(parameters also atol 2e-6; float32 through three Adam steps). The noise
statistics get rtol 5e-3: the Adam preconditioner divides each gradient
entry by sqrt(nu) + 1e-8, so the entries with the smallest gradients --
sums that nearly cancel, the least accurate in float32 -- carry the
largest weights, and the preconditioned norms inherit their error
(about 2e-3 observed on grad_var). grad_sqr is moreover a difference of
two such norms, each of grad_var's size, so its agreement is bounded in
absolute terms too: atol 1e-5 * |grad_var|.

The installed jax (0.9) takes ``jax.lax.pcast``'s ``to`` by keyword
only, while ``adaptdl_tpu._compat.pcast`` passes it by position, so
every JAX train step raises TypeError here. The parity test binds the
trainer's ``_pcast`` to a keyword call for its duration; the JAX
package itself is unchanged.

Resume: a run told to stop mid-epoch (the SIGTERM flag) saves every
state and exits 143; its successor restores and finishes, ending bit
for bit where an undisturbed run ends.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.parallel import create_mesh
from adaptdl_tpu.scaling_rules import AdamScale as JaxAdamScale
from adaptdl_tpu.trainer import ElasticTrainer as JaxTrainer
from adaptdl_tpu_torch import _signal, checkpoint, epoch, gns, metrics
from adaptdl_tpu_torch.data import AdaptiveDataLoader
from adaptdl_tpu_torch.models import TransformerConfig, init_transformer, lm_loss_fn
from adaptdl_tpu_torch.ops import make_flash_attention
from adaptdl_tpu_torch.optim import AdamW
from adaptdl_tpu_torch.scaling_rules import AdamScale
from adaptdl_tpu_torch.trainer import ElasticTrainer
from adaptdl_tpu_torch.weights import flax_to_state_dict
from tests.torch_support import private_tempdir  # noqa: F401

SIZES = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64)
INIT_BATCH = 2
ATOMIC = 4


@pytest.fixture(autouse=True)
def _port_state():
    """The port keeps its own registries beside the JAX package's."""
    checkpoint._reset_registry()
    metrics._reset_state()
    epoch._reset_state()
    _signal.set_exit_flag(False)
    yield
    checkpoint._reset_registry()
    metrics._reset_state()
    epoch._reset_state()
    _signal.set_exit_flag(False)


def _port_trainer(model):
    return ElasticTrainer(
        lm_loss_fn, model, AdamW(model.parameters(), lr=3e-4),
        init_batch_size=INIT_BATCH, scaling_rule=AdamScale(),
        precondition="adam", device="cpu",
    )


def _batches(rows, count=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        out.append({"tokens": rng.integers(0, 64, size=(rows, 33), dtype=np.int32)})
    return out


@pytest.mark.parametrize("accum_steps", [0, 1])
def test_three_steps_match_jax(accum_steps, monkeypatch):
    import adaptdl_tpu.trainer as jax_trainer_mod

    monkeypatch.setattr(
        jax_trainer_mod, "_pcast",
        lambda x, axes, to: jax.lax.pcast(x, axes, to=to),
    )
    jax_model, params = jax_init(
        JaxConfig(**SIZES, max_seq_len=32, dtype=jnp.float32, remat=True),
        seq_len=32,
    )

    def jax_loss(p, batch, rng):
        tokens = batch["tokens"]
        logits = jax_model.apply({"params": p}, tokens[:, :-1], train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tokens[:, 1:]
        ).mean()

    jax_trainer = JaxTrainer(
        jax_loss, params, optax.adamw(3e-4), INIT_BATCH,
        scaling_rule=JaxAdamScale(), precondition="adam",
        mesh=create_mesh(devices=jax.devices()[:1]),
    )
    model = init_transformer(
        TransformerConfig(**SIZES, dtype=torch.float32, remat=True),
        device="cpu",
    )
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    trainer = _port_trainer(model)

    jstate = jax_trainer.init_state()
    state = trainer.init_state()
    jstep = jax_trainer.train_step(ATOMIC, accum_steps)
    step = trainer.train_step(ATOMIC, accum_steps)
    for batch in _batches(ATOMIC * (accum_steps + 1)):
        jstate, jm = jstep(jstate, jax_trainer.shard_batch(batch))
        state, m = step(state, trainer.to_device(batch))
        for key in ("loss", "gain", "lr_factor", "progress"):
            np.testing.assert_allclose(
                float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key
            )
        var = abs(float(jm["grad_var"]))
        np.testing.assert_allclose(float(m["grad_var"]), var, rtol=5e-3)
        np.testing.assert_allclose(
            float(m["grad_sqr"]), float(jm["grad_sqr"]),
            rtol=5e-3, atol=1e-5 * var, err_msg="grad_sqr",
        )
    want = flax_to_state_dict(jax.device_get(jstate.params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(
            p.numpy(), want[name].numpy(), rtol=1e-5, atol=2e-6, err_msg=name
        )
    var = np.abs(np.asarray(jstate.gns.var_biased))
    for name in ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias"):
        np.testing.assert_allclose(
            getattr(state.gns, name).numpy(),
            np.asarray(getattr(jstate.gns, name)), rtol=5e-3,
            atol=1e-5 * float(var.max()) if name == "sqr_biased" else 0,
            err_msg=name,
        )
    assert bool(state.gns.ema_is_biased) == bool(jstate.gns.ema_is_biased)
    assert bool(state.gns.prev_grad_valid) == bool(jstate.gns.prev_grad_valid)
    assert int(state.step) == int(jstate.step) == 3


def _elastic_run(tmp_path, monkeypatch, restarts, stop_after=None):
    """Train two epochs of 8 steps through the loader; with
    ``stop_after`` the exit flag is raised after that many steps."""
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("ADAPTDL_NUM_RESTARTS", str(restarts))
    model = init_transformer(
        TransformerConfig(**SIZES, dtype=torch.float32, remat=True,
                          attention_fn=make_flash_attention(block_q=16, block_k=16)),
        seed=0, device="cpu",
    )
    trainer = _port_trainer(model)
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()
    tokens = np.concatenate([b["tokens"] for b in _batches(16, count=2)])
    loader = AdaptiveDataLoader({"tokens": tokens}, batch_size=4)
    steps = 0
    for _ in epoch.remaining_epochs_until(2):
        for batch in loader:
            holder["state"], _ = trainer.run_step(holder["state"], batch, loader)
            steps += 1
            if steps == stop_after:
                _signal.set_exit_flag(True)
    return holder["state"], steps


def test_sigterm_save_resume_equals_undisturbed(tmp_path, monkeypatch):
    want, total = _elastic_run(tmp_path / "undisturbed", monkeypatch, 0)
    assert total == 16
    want_params = {k: v.clone() for k, v in want.model.state_dict().items()}
    checkpoint._reset_registry()
    epoch._reset_state()

    with pytest.raises(SystemExit) as exited:
        _elastic_run(tmp_path / "elastic", monkeypatch, 0, stop_after=5)
    assert exited.value.code == 143
    assert checkpoint.latest_checkpoint_dir(str(tmp_path / "elastic"))
    checkpoint._reset_registry()
    metrics._reset_state()
    epoch._reset_state()
    _signal.set_exit_flag(False)

    got, resumed_steps = _elastic_run(tmp_path / "elastic", monkeypatch, 1)
    assert 0 < resumed_steps < total
    assert int(got.step) == int(want.step) == total
    for name, p in got.model.state_dict().items():
        assert torch.equal(p, want_params[name]), name
    assert torch.equal(got.progress, want.progress)
    assert torch.equal(gns.sqr_avg(got.gns), gns.sqr_avg(want.gns))


def test_unported_modes_raise(monkeypatch):
    model = init_transformer(
        TransformerConfig(**SIZES, dtype=torch.float32), device="cpu"
    )
    opt = AdamW(model.parameters(), lr=1e-3)
    with pytest.raises(TypeError, match="meshes"):
        ElasticTrainer(lm_loss_fn, model, opt, 4, mesh=object(), device="cpu")
    # A seq or stage axis needs one process per chip: the stage axis is
    # ported (tests/test_torch_pipeline_trainer.py trains it at two and
    # four ranks), so one process asks for the processes it lacks; an
    # unknown axis raises.
    monkeypatch.setenv("ADAPTDL_SEQ_SHARDS", "2")
    with pytest.raises(NotImplementedError, match="one per chip under a seq axis"):
        ElasticTrainer(lm_loss_fn, model, opt, 4, device="cpu")
    monkeypatch.setenv("ADAPTDL_SEQ_SHARDS", "1")
    monkeypatch.setenv("ADAPTDL_STAGE_SHARDS", "2")
    with pytest.raises(NotImplementedError, match=r"\{'data': 1, 'stage': 2\} needs 2"):
        ElasticTrainer(lm_loss_fn, model, opt, 4, device="cpu")
    monkeypatch.setenv("ADAPTDL_STAGE_SHARDS", "1")
    from adaptdl_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(ValueError, match="unknown mesh axes"):
        pmesh.create_mesh({"data": 1, "pipe": 2})
    monkeypatch.setenv("ADAPTDL_NUM_REPLICAS", "2")
    with pytest.raises(NotImplementedError, match="multi-replica"):
        ElasticTrainer(lm_loss_fn, model, opt, 4, device="cpu")
