"""The model zoo through the port's ElasticTrainer, against the JAX one.

Parity (one replica against a one-device mesh, three steps from the same
converted parameters on the same numpy batches, seeded):

- ResNet18 (width 8, 8x8 images) with ``SGD(0.1, momentum=0.9)`` and
  AdaScale at accum_steps 0 and 1: the unpreconditioned noise
  statistics, AdaScale's gain and LR factor, progress, the parameters
  and the momentum buffers;
- NeuMF with ``Adam(1e-3)``, AdamScale and ``precondition="adam"``;
- the DCGAN discriminator under ``has_aux=True`` (the generator arrives
  as ``aux``), alternating with generator steps of
  ``make_generator_step``, as ``tests/test_models.py::
  test_dcgan_alternating_steps`` drives the JAX pair.

Tolerances. Losses, gain, LR factor and progress: rtol 1e-5.
Parameters and optimizer buffers: rtol 1e-5, atol 1e-6 (float32 through
three steps; atol for entries that pass near zero), and atol 5e-6 for the
ResNet: its float32 gradients differ by about 2e-6 of their scale
(test_torch_models_zoo.py: the conv and GroupNorm backward sum in another
order), and each step moves a parameter by 0.1 x AdaScale's factor (up
to 2 here) x the momentum trace, which sums 1 + 1.9 + 2.71 such
gradients over three steps. The noise
statistics: rtol 1e-4 without a preconditioner (each is a sum of
squares over every gradient entry, summed in another order on each
side; grad_sqr is moreover a difference of two such sums, so it also
gets atol 1e-5 * |grad_var|), and rtol 5e-3 with the Adam preconditioner,
for the reason tests/test_torch_trainer.py gives (entries with the
smallest gradients carry the largest weights). The JAX step's ``_pcast``
is bound to a keyword call, as in test_torch_trainer.py.

Within the port: every microbatch draws from its own generator (seeded
by the trainer's seed, the step, the microbatch index and the replica
rank), and a run restored from a checkpoint draws the same dropout masks
as an undisturbed one, ending bit for bit where it ends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaptdl_tpu.models import dcgan as jax_dcgan
from adaptdl_tpu.models import ncf as jax_ncf
from adaptdl_tpu.models import resnet as jax_resnet
from adaptdl_tpu.parallel import create_mesh
from adaptdl_tpu.scaling_rules import AdamScale as JaxAdamScale
from adaptdl_tpu.scaling_rules import AdaScale as JaxAdaScale
from adaptdl_tpu.trainer import ElasticTrainer as JaxTrainer
from adaptdl_tpu_torch import _signal, checkpoint, epoch, metrics, weights
from adaptdl_tpu_torch.data import AdaptiveDataLoader
from adaptdl_tpu_torch.models import cnn, dcgan, ncf, resnet
from adaptdl_tpu_torch.optim import SGD, Adam
from adaptdl_tpu_torch.scaling_rules import AdamScale, AdaScale
from adaptdl_tpu_torch.trainer import ElasticTrainer, microbatch_generator
from tests.torch_support import private_tempdir  # noqa: F401

INIT_BATCH = 2
ATOMIC = 4
STEPS = 3
SCALARS = dict(rtol=1e-5)
PARAMS = dict(rtol=1e-5, atol=1e-6)
RESNET_PARAMS = dict(rtol=1e-5, atol=5e-6)


@pytest.fixture(autouse=True)
def _port_state():
    checkpoint._reset_registry()
    metrics._reset_state()
    epoch._reset_state()
    _signal.set_exit_flag(False)
    yield
    checkpoint._reset_registry()
    metrics._reset_state()
    epoch._reset_state()
    _signal.set_exit_flag(False)


@pytest.fixture
def jax_trainer(monkeypatch):
    """Builds JAX trainers on a one-device mesh with ``_pcast`` bound to
    a keyword call."""
    import adaptdl_tpu.trainer as jax_trainer_mod

    monkeypatch.setattr(
        jax_trainer_mod, "_pcast",
        lambda x, axes, to: jax.lax.pcast(x, axes, to=to),
    )

    def build(*args, **kwargs):
        return JaxTrainer(
            *args, mesh=create_mesh(devices=jax.devices()[:1]), **kwargs
        )

    return build


def _check_step(m, jm, stat_rtol):
    for key in ("loss", "gain", "lr_factor", "progress"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), err_msg=key, **SCALARS)
    var = abs(float(jm["grad_var"]))
    np.testing.assert_allclose(float(m["grad_var"]), var, rtol=stat_rtol)
    np.testing.assert_allclose(
        float(m["grad_sqr"]), float(jm["grad_sqr"]),
        rtol=stat_rtol, atol=1e-5 * var, err_msg="grad_sqr",
    )


def _check_state(state, jstate, convert, stat_rtol, params_tol=PARAMS):
    want = convert(jax.device_get(jstate.params))
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(
            p.numpy(), want[name].numpy(), err_msg=name, **params_tol
        )
    var = np.abs(np.asarray(jstate.gns.var_biased))
    for name in ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias"):
        np.testing.assert_allclose(
            getattr(state.gns, name).numpy(),
            np.asarray(getattr(jstate.gns, name)), rtol=stat_rtol,
            atol=1e-5 * float(var.max()) if name == "sqr_biased" else 0,
            err_msg=name,
        )
    assert bool(state.gns.ema_is_biased) == bool(jstate.gns.ema_is_biased)
    assert int(state.step) == int(jstate.step) == STEPS


def _image_batches(rows, size=8, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {
            "image": rng.normal(size=(rows, size, size, channels)).astype(np.float32),
            "label": rng.integers(0, 10, size=rows).astype(np.int32),
        }
        for _ in range(STEPS)
    ]


@pytest.mark.parametrize("accum_steps", [0, 1])
def test_resnet18_sgd_adascale_matches_jax(jax_trainer, accum_steps):
    jmodel, params = jax_resnet.init_resnet18(image_size=8, width=8)
    jt = jax_trainer(
        jax_resnet.resnet_loss_fn(jmodel), params,
        optax.sgd(0.1, momentum=0.9), INIT_BATCH, scaling_rule=JaxAdaScale(),
    )
    model = resnet.ResNet18(width=8)
    model.load_state_dict(weights.resnet18_state_dict(params))
    optimizer = SGD(model.parameters(), lr=0.1, momentum=0.9)
    trainer = ElasticTrainer(
        resnet.resnet_loss_fn, model, optimizer, INIT_BATCH,
        scaling_rule=AdaScale(), device="cpu",
    )
    jstate, state = jt.init_state(), trainer.init_state()
    jstep = jt.train_step(ATOMIC, accum_steps)
    step = trainer.train_step(ATOMIC, accum_steps)
    for batch in _image_batches(ATOMIC * (accum_steps + 1)):
        jstate, jm = jstep(jstate, jt.shard_batch(batch))
        state, m = step(state, trainer.to_device(batch))
        _check_step(m, jm, stat_rtol=1e-4)
    _check_state(
        state, jstate, weights.resnet18_state_dict, stat_rtol=1e-4,
        params_tol=RESNET_PARAMS,
    )
    # The momentum buffers are optax's trace, untouched by the factor.
    trace = weights.resnet18_state_dict(jax.device_get(jstate.opt_state[0].trace))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            optimizer.state[p]["momentum_buffer"].numpy(), trace[name].numpy(),
            err_msg=name, **RESNET_PARAMS,
        )


def test_neumf_adam_adamscale_matches_jax(jax_trainer):
    jmodel, params = jax_ncf.init_ncf(20, 30, embed_dim=8, mlp_dims=(16, 8))
    jt = jax_trainer(
        jax_ncf.ncf_loss_fn(jmodel), params, optax.adam(1e-3), INIT_BATCH,
        scaling_rule=JaxAdamScale(), precondition="adam",
    )
    model = ncf.NeuMF(20, 30, embed_dim=8, mlp_dims=(16, 8))
    model.load_state_dict(weights.ncf_state_dict(params))
    trainer = ElasticTrainer(
        ncf.ncf_loss_fn, model, Adam(model.parameters(), lr=1e-3), INIT_BATCH,
        scaling_rule=AdamScale(), precondition="adam", device="cpu",
    )
    rng = np.random.default_rng(1)
    jstate, state = jt.init_state(), trainer.init_state()
    jstep, step = jt.train_step(ATOMIC, 1), trainer.train_step(ATOMIC, 1)
    for _ in range(STEPS):
        batch = {
            "user": rng.integers(0, 20, size=2 * ATOMIC).astype(np.int32),
            "item": rng.integers(0, 30, size=2 * ATOMIC).astype(np.int32),
            "label": rng.integers(0, 2, size=2 * ATOMIC).astype(np.float32),
        }
        jstate, jm = jstep(jstate, jt.shard_batch(batch))
        state, m = step(state, trainer.to_device(batch))
        _check_step(m, jm, stat_rtol=5e-3)
    _check_state(state, jstate, weights.ncf_state_dict, stat_rtol=5e-3)


def test_dcgan_has_aux_alternating_steps_match_jax(jax_trainer):
    gen, g_params, disc, d_params = jax_dcgan.init_dcgan(
        latent_dim=8, base_features=8, channels=1
    )
    jt = jax_trainer(
        jax_dcgan.discriminator_loss_fn(disc, gen), d_params,
        optax.adam(2e-4, b1=0.5), INIT_BATCH, has_aux=True,
    )
    g_opt = optax.adam(2e-4, b1=0.5)
    g_opt_state = g_opt.init(g_params)
    jg_step = jax_dcgan.make_generator_step(gen, disc, g_opt)

    g = dcgan.Generator(8, 8, 1)
    g.load_state_dict(weights.generator_state_dict(g_params))
    d = dcgan.Discriminator(8, 1)
    d.load_state_dict(weights.discriminator_state_dict(d_params))
    trainer = ElasticTrainer(
        dcgan.discriminator_loss_fn, d, Adam(d.parameters(), lr=2e-4, b1=0.5),
        INIT_BATCH, has_aux=True, device="cpu",
    )
    g_step = dcgan.make_generator_step(g, d, Adam(g.parameters(), lr=2e-4, b1=0.5))

    rng = np.random.default_rng(2)
    jstate, state = jt.init_state(), trainer.init_state()
    jd_step, d_step = jt.train_step(ATOMIC, 0), trainer.train_step(ATOMIC, 0)
    for _ in range(STEPS):
        batch = {
            "image": rng.normal(size=(ATOMIC, 32, 32, 1)).astype(np.float32),
            "z": rng.normal(size=(ATOMIC, 8)).astype(np.float32),
        }
        jstate, jm = jd_step(jstate, jt.shard_batch(batch), g_params)
        state, m = d_step(state, trainer.to_device(batch), g)
        _check_step(m, jm, stat_rtol=1e-4)
        z = rng.normal(size=(ATOMIC, 8)).astype(np.float32)
        g_params, g_opt_state, jg_loss = jg_step(
            g_params, g_opt_state, jstate.params, jnp.asarray(z)
        )
        g_loss = g_step(torch.from_numpy(z))
        np.testing.assert_allclose(float(g_loss), float(jg_loss), **SCALARS)
    _check_state(state, jstate, weights.discriminator_state_dict, stat_rtol=1e-4)
    want = weights.generator_state_dict(jax.device_get(g_params))
    for name, p in g.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), err_msg=name, **PARAMS)


def test_precondition_adam_needs_second_moments():
    model = ncf.NeuMF(4, 4, embed_dim=8, mlp_dims=(8,))
    with pytest.raises(ValueError, match="second moments"):
        ElasticTrainer(
            ncf.ncf_loss_fn, model, SGD(model.parameters(), lr=0.1), 4,
            precondition="adam", device="cpu",
        )


def test_microbatch_generators_differ_by_step_micro_and_rank():
    def draw(*key):
        return torch.rand(4, generator=microbatch_generator(torch.device("cpu"), *key))

    base = draw(0, 3, 0, 0)
    assert torch.equal(base, draw(0, 3, 0, 0))
    for other in [(1, 3, 0, 0), (0, 4, 0, 0), (0, 3, 1, 0), (0, 3, 0, 1)]:
        assert not torch.equal(base, draw(*other)), other


def _cnn_run(root, monkeypatch, restarts, stop_after=None):
    """SmallCNN with dropout, two epochs of 6 steps (accum 1) through
    the loader; with ``stop_after`` the exit flag is raised after that
    many steps. Returns the final state and every loss."""
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(root))
    monkeypatch.setenv("ADAPTDL_NUM_RESTARTS", str(restarts))
    model = cnn.init_cnn(seed=0, device="cpu", image_size=8)
    trainer = ElasticTrainer(
        cnn.cnn_loss_fn, model, SGD(model.parameters(), lr=0.05, momentum=0.9),
        8, scaling_rule=AdaScale(), seed=7, device="cpu",
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()
    data = _image_batches(48, size=8, channels=1, seed=3)[0]
    loader = AdaptiveDataLoader(data, batch_size=8)
    loader.apply_retune(4, 1)
    losses = []
    for _ in epoch.remaining_epochs_until(2):
        for batch in loader:
            holder["state"], m = trainer.run_step(holder["state"], batch, loader)
            losses.append(float(m["loss"]))
            if len(losses) == stop_after:
                _signal.set_exit_flag(True)
    return holder["state"], losses


def test_restart_draws_the_same_dropout_masks(tmp_path, monkeypatch):
    want, want_losses = _cnn_run(tmp_path / "undisturbed", monkeypatch, 0)
    assert len(want_losses) == 12
    checkpoint._reset_registry()
    metrics._reset_state()
    epoch._reset_state()
    with pytest.raises(SystemExit) as exited:
        _cnn_run(tmp_path / "elastic", monkeypatch, 0, stop_after=4)
    assert exited.value.code == 143
    checkpoint._reset_registry()
    metrics._reset_state()
    epoch._reset_state()
    _signal.set_exit_flag(False)
    got, losses = _cnn_run(tmp_path / "elastic", monkeypatch, 1)
    # The resumed steps are the undisturbed run's last ones, masks and all.
    assert losses == want_losses[-len(losses):]
    assert got.host_step == int(got.step) == want.host_step == 12
    assert got.seed == 7
    for (name, p), q in zip(got.model.state_dict().items(), want.model.state_dict().values()):
        assert torch.equal(p, q), name


# -- the examples, one short epoch each on the CPU --------------------------


@pytest.fixture
def example_env(monkeypatch):
    """A one-replica job with no checkpoint dir, the way a user runs an
    example by hand."""
    for name in ("ADAPTDL_CHECKPOINT_PATH", "ADAPTDL_SUPERVISOR_URL", "ADAPTDL_JOB_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ADAPTDL_NUM_REPLICAS", "1")


def test_cifar_resnet18_example_runs_an_epoch(example_env):
    from adaptdl_tpu_torch.examples import cifar_resnet18

    state = cifar_resnet18.main(["--cpu", "--epochs", "1", "--width", "8"])
    # 2048 images at the initial batch of 128 (no fitted model yet).
    assert int(state.step) == state.host_step == 16
    assert isinstance(state.optimizer, SGD)
    assert np.isfinite(float(state.progress))


def test_ncf_example_runs_an_epoch(example_env):
    from adaptdl_tpu_torch.examples import ncf as ncf_example

    state, (hr, ndcg) = ncf_example.main(["--cpu", "--epochs", "1", "--users", "32", "--items", "64"])
    # 32 users x 8 positives x (1 + 4 negatives) at batch 256.
    assert int(state.step) == 5
    assert 0.0 <= ndcg <= hr <= 1.0


def test_dcgan_example_runs_an_epoch_and_writes_tensorboard(example_env, tmp_path):
    from adaptdl_tpu_torch import tensorboard
    from adaptdl_tpu_torch.examples import dcgan as dcgan_example

    state, generator, path = dcgan_example.main([
        "--cpu", "--epochs", "1", "--features", "8", "--logdir", str(tmp_path / "tb"),
    ])
    assert int(state.step) == 1024 // 64
    rows = tensorboard.read_events(path)
    assert [step for step, _ in rows] == [0]
    assert set(rows[0][1]) == {"dcgan/d_loss", "dcgan/g_loss"}
    with open(path, "rb") as f:
        assert b"dcgan/samples" in f.read()


def test_bert_mlm_example_runs_an_epoch(example_env):
    from adaptdl_tpu_torch.examples import bert_mlm

    state = bert_mlm.main(["--cpu", "--epochs", "1", "--seq-len", "8"])
    assert int(state.step) == 4096 // 32
    assert not state.model.config.causal
    # --moe-experts runs (tests/test_torch_lm_options.py); a router the JAX
    # example does not take is refused.
    with pytest.raises(SystemExit):
        bert_mlm.main(["--cpu", "--moe-experts", "4", "--moe-router", "nope"])


def test_linear_regression_example_converges(example_env):
    from adaptdl_tpu_torch.examples import linear_regression

    w, b = linear_regression.main(["--cpu", "--epochs", "1"])
    np.testing.assert_allclose(w, linear_regression.TRUE_W, atol=0.05)
    assert abs(b) < 0.05
