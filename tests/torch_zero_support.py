"""Shared set-up of the port's ZeRO tests (``tests/test_torch_zero.py``,
``test_torch_zero3_blocks.py``, ``test_torch_sharded_checkpoint.py``):
the JAX reference run in a given storage mode on the conftest's CPU mesh
(``_pcast`` bound to a keyword call in ``adaptdl_tpu.trainer``,
``adaptdl_tpu.parallel.zero3`` and ``adaptdl_tpu.parallel.pipeline``,
as ``jax.lax.pcast`` takes ``to`` by keyword under the installed jax),
the launch of
``tests/torch_zero_worker.py`` at two gloo ranks, and the comparisons at
``test_torch_multi_replica.py``'s tolerances: loss, gain, LR factor and
progress rtol 1e-5; parameters rtol 1e-5 and atol 2e-6; the noise
statistics rtol 5e-3 (grad_sqr and sqr_biased also atol 1e-5 of the
variance's scale)."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WORKER = "tests/torch_zero_worker.py"
LAUNCH_TIMEOUT_S = 300


def start_ranks(out_dir, plan, replicas=2, restarts=0, worker=WORKER):
    """Launch ``worker``'s ``plan`` at ``replicas`` gloo ranks; returns
    the process (it leads its own process group, so a timeout kills
    every rank)."""
    run_env = {k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")}
    run_env.update(
        PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
        ADAPTDL_NUM_REPLICAS=str(replicas), ADAPTDL_NUM_RESTARTS=str(restarts),
    )
    return subprocess.Popen(
        [sys.executable, "-m", "adaptdl_tpu_torch.launch", worker, str(out_dir), plan],
        cwd=REPO, env=run_env, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def finish(proc):
    try:
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch {proc.args} timed out:\n{out}")
    assert proc.returncode == 0, out
    return out


def bind_pcast():
    """A MonkeyPatch context binding the JAX package's ``_pcast`` to a
    keyword call where the trainer, the ZeRO paths and the pipeline
    schedules import it."""
    import jax

    import adaptdl_tpu.parallel.pipeline as jax_pipeline
    import adaptdl_tpu.parallel.zero3 as jax_zero3
    import adaptdl_tpu.trainer as jax_trainer_mod

    patch = pytest.MonkeyPatch()
    pcast = lambda x, axes, to: jax.lax.pcast(x, axes, to=to)  # noqa: E731
    patch.setattr(jax_trainer_mod, "_pcast", pcast)
    patch.setattr(jax_zero3, "_pcast", pcast)
    patch.setattr(jax_pipeline, "_pcast", pcast)
    return patch


def jax_moments(trainer, state):
    """The JAX trainer's optimizer moments as flat canonical numpy
    vectors in ravel_pytree order: ``exp_avg``/``exp_avg_sq`` (Adam's
    mu/nu) or ``momentum_buffer`` (SGD's trace)."""
    import jax
    import optax
    from jax.flatten_util import ravel_pytree

    opt = jax.tree.map(np.asarray, state.opt_state)
    if trainer.zero3_blocks is not None:
        opt = trainer._z3b_canonical_opt(opt)
    elif trainer.zero1:
        opt = trainer._zero1_canonical_opt(opt)
    found = {}

    def visit(node):
        if isinstance(node, optax.ScaleByAdamState):
            found["exp_avg"], found["exp_avg_sq"] = node.mu, node.nu
        elif isinstance(node, optax.TraceState):
            found["momentum_buffer"] = node.trace
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)

    visit(opt)
    out = {}
    for key, value in found.items():
        flat = value if isinstance(value, np.ndarray) else np.asarray(ravel_pytree(value)[0])
        out[key] = np.asarray(flat)
    return out


def jax_run(loss_fn, params, optimizer, rule, precond, dp, batches, accum,
            init_batch, group_fn=None, **mode):
    """The JAX ElasticTrainer on a ``dp``-device mesh over ``batches``
    (``{key: [steps, rows, ...]}``): per-step metrics, parameter tree,
    flat moments, noise statistics, trainer."""
    import jax

    from adaptdl_tpu.parallel import create_mesh
    from adaptdl_tpu.trainer import ElasticTrainer as JaxTrainer

    patch = bind_pcast()
    try:
        patch.setenv("ADAPTDL_NUM_REPLICAS", str(dp))
        trainer = JaxTrainer(
            loss_fn, params, optimizer, init_batch, scaling_rule=rule,
            precondition=precond, mesh=create_mesh({"data": dp}, devices=jax.devices()[:dp]),
            param_group_fn=group_fn, **mode,
        )
        state = trainer.init_state()
        keys = list(batches)
        rows = len(batches[keys[0]][0])
        step = trainer.train_step(rows // (dp * (accum + 1)), accum)
        metrics = []
        for i in range(len(batches[keys[0]])):
            state, m = step(state, trainer.shard_batch({k: batches[k][i] for k in keys}))
            metrics.append({k: float(v) for k, v in m.items()})
        tree = jax.tree.map(np.asarray, trainer.params_tree(state))
        return {
            "steps": metrics, "params": tree,
            "moments": jax_moments(trainer, state),
            "gns": {k: np.asarray(getattr(state.gns, k)) for k in
                    ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias")},
            "ema_is_biased": bool(state.gns.ema_is_biased),
            "step": int(state.step),
        }
    finally:
        patch.undo()


def assert_steps_match(port_steps, jax_steps):
    assert len(port_steps) == len(jax_steps)
    for m, jm in zip(port_steps, jax_steps):
        for key in ("loss", "gain", "lr_factor", "progress"):
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-5, err_msg=key)
        var = abs(jm["grad_var"])
        np.testing.assert_allclose(m["grad_var"], var, rtol=5e-3, err_msg="grad_var")
        np.testing.assert_allclose(
            m["grad_sqr"], jm["grad_sqr"], rtol=5e-3, atol=1e-5 * var, err_msg="grad_sqr"
        )


def assert_params_match(port_params, want):
    """``want``: the JAX tree converted to the port's names."""
    assert set(port_params) == set(want)
    for name, p in port_params.items():
        np.testing.assert_allclose(
            p.numpy(), want[name].numpy(), rtol=1e-5, atol=2e-6, err_msg=name
        )


def assert_gns_match(port_gns, jax_result):
    var = float(np.abs(jax_result["gns"]["var_biased"]).max())
    for name, want in jax_result["gns"].items():
        np.testing.assert_allclose(
            port_gns[name].numpy(), want, rtol=5e-3,
            atol=1e-5 * var if name == "sqr_biased" else 0, err_msg=name,
        )
    assert bool(port_gns["ema_is_biased"]) == jax_result["ema_is_biased"]


def assert_moments_match(port_moments, jax_moments_, perm):
    """Flat moments: the port's canonical order is ``jax_flat[perm]``."""
    assert set(port_moments) == set(jax_moments_)
    for key, flat in port_moments.items():
        want = jax_moments_[key][perm]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(
            flat.numpy(), want, rtol=1e-5, atol=2e-6 * max(scale, 1.0), err_msg=key
        )
