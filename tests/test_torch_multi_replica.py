"""Multi-replica data parallelism in the port: one process per replica.

Parity: two gloo processes of the port (fresh interpreters started by
``adaptdl_tpu_torch.launch``, each stepping on its replica-major block,
see ``tests/torch_replica_worker.py``) against the JAX ``ElasticTrainer``
on a 2-device mesh, three steps from the same converted weights on the
same numpy batches at accum_steps 0 and 1: the 2-layer, d_model 32
transformer with AdamW(3e-4), AdamScale and ``precondition="adam"``.
The port's model runs flash attention (its plain version on the CPU),
the JAX model plain attention; the two agree to float32 accumulation
order (test_torch_transformer.py). Tolerances are those of
test_torch_trainer.py: loss, gain, LR factor and progress rtol 1e-5,
parameters rtol 1e-5 and atol 2e-6, the noise statistics rtol 5e-3
(grad_sqr also atol 1e-5 * |grad_var|). The two ranks agree bit for
bit. The JAX step's ``_pcast`` is bound to a keyword call, as in
test_torch_trainer.py.

Elastic: a user program (linear regression through ElasticTrainer,
AdaptiveDataLoader, remaining_epochs_until and an Accumulator) at 2
replicas is preempted by the exit flag on rank 1 alone; the launcher
exits 143. Successors at 1 and 3 replicas resume at the interrupted
epoch and position and converge, and hold profiles of both replica
counts; a successor at 2 replicas ends bit for bit where an undisturbed
2-replica run ends, Accumulator totals (replayed and summed) included.

DCGAN: two gloo ranks train the DCGAN pair (discriminator under
``has_aux``, generator through ``make_generator_step``) on their blocks
of the same global batches: the generators stay bit for bit equal across
the ranks, and both models agree with one process stepping the whole
batch to float32 summation order (rtol 1e-5, atol 1e-6; Adam's update is
the same function of the averaged gradient, which each side sums in
another order).

Units: the launcher's exit-code rule and signal forwarding, the backend
rule, the device map, the flat all-reduce's packing and its one call
per step on a gloo group, the loader's per-process block, the metrics'
replica coverage through a checkpoint.
"""

import io
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.parallel import create_mesh
from adaptdl_tpu.scaling_rules import AdamScale as JaxAdamScale
from adaptdl_tpu.trainer import ElasticTrainer as JaxTrainer
from adaptdl_tpu_torch import _signal, checkpoint, collective, epoch, metrics
from adaptdl_tpu_torch.device import replica_device
from adaptdl_tpu_torch.launch import exit_code
from adaptdl_tpu_torch.weights import flax_to_state_dict
from tests import torch_replica_worker as worker
from tests.torch_support import private_tempdir  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WORKER = "tests/torch_replica_worker.py"
LAUNCH_TIMEOUT_S = 300  # a guard against hangs; runs take ~10-30 s
STEPS = 3
STEPS_PER_EPOCH = worker.DATASET_SIZE // 32  # global batch 32
PREEMPT_AFTER = 5  # rank 1's steps before its flag; both stop after one more


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


LAUNCHER = ["-m", "adaptdl_tpu_torch.launch"]


def _start(args, replicas, ckpt=None, restarts=0, launcher=LAUNCHER):
    """Start the launcher on ``args`` with ``replicas`` ranks. It leads
    its own process group, so :func:`_finish` can kill a run past its
    timeout with every rank it started."""
    run_env = {
        k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")
    }
    run_env.update(
        PYTHONPATH=str(REPO),
        OMP_NUM_THREADS="1",
        ADAPTDL_NUM_REPLICAS=str(replicas),
        ADAPTDL_NUM_RESTARTS=str(restarts),
    )
    if ckpt is not None:
        run_env["ADAPTDL_CHECKPOINT_PATH"] = str(ckpt)
    return subprocess.Popen(
        [sys.executable, *launcher, *args],
        cwd=REPO, env=run_env, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _finish(proc):
    """(exit code, output) of a started launcher."""
    try:
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch {proc.args} timed out:\n{out}")
    return proc.returncode, out


# -- parity with the JAX trainer on a 2-device mesh ----------------------


def _parity_inputs(out):
    """The converted weights and numpy batches of both accum settings;
    the JAX model and params for the reference side."""
    jax_model, params = jax_init(
        JaxConfig(**worker.SIZES, max_seq_len=32, dtype=jnp.float32, remat=True),
        seq_len=32,
    )
    torch.save(
        flax_to_state_dict(jax.device_get(params)), out / "weights.pt"
    )
    rng = np.random.default_rng(0)
    for accum in (0, 1):
        rows = 2 * worker.ATOMIC * (accum + 1)
        np.save(
            out / f"batches-accum{accum}.npy",
            rng.integers(0, 64, size=(STEPS, rows, 33), dtype=np.int32),
        )
    return jax_model, params


def _jax_reference(out, jax_model, params, accum_steps):
    """The JAX trainer on a 2-device mesh over the same batches: its
    per-step metrics and final state."""
    import adaptdl_tpu.trainer as jax_trainer_mod

    def jax_loss(p, batch, rng):
        tokens = batch["tokens"]
        logits = jax_model.apply({"params": p}, tokens[:, :-1], train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tokens[:, 1:]
        ).mean()

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(
            jax_trainer_mod, "_pcast",
            lambda x, axes, to: jax.lax.pcast(x, axes, to=to),
        )
        patch.setenv("ADAPTDL_NUM_REPLICAS", "2")
        jax_trainer = JaxTrainer(
            jax_loss, params, optax.adamw(3e-4), worker.INIT_BATCH,
            scaling_rule=JaxAdamScale(), precondition="adam",
            mesh=create_mesh(devices=jax.devices()[:2]),
        )
        jstate = jax_trainer.init_state()
        jstep = jax_trainer.train_step(worker.ATOMIC, accum_steps)
        steps = []
        for batch in np.load(out / f"batches-accum{accum_steps}.npy"):
            jstate, jm = jstep(
                jstate, jax_trainer.shard_batch({"tokens": batch})
            )
            steps.append({k: float(v) for k, v in jm.items()})
    return steps, jstate


@pytest.mark.parametrize("accum_steps", [0, 1])
def test_two_replicas_match_jax_two_device_mesh(port_runs, accum_steps):
    out = port_runs["root"] / "parity"
    jax_steps, jstate = port_runs["jax"][accum_steps]
    ranks = [
        torch.load(out / f"rank{r}-accum{accum_steps}.pt") for r in (0, 1)
    ]
    for name, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][name]), name
    assert ranks[0]["steps"] == ranks[1]["steps"]
    got = ranks[0]
    for m, jm in zip(got["steps"], jax_steps):
        for key in ("loss", "gain", "lr_factor", "progress"):
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-5, err_msg=key)
        var = abs(jm["grad_var"])
        np.testing.assert_allclose(m["grad_var"], var, rtol=5e-3)
        np.testing.assert_allclose(
            m["grad_sqr"], jm["grad_sqr"], rtol=5e-3, atol=1e-5 * var,
            err_msg="grad_sqr",
        )
    want = flax_to_state_dict(jax.device_get(jstate.params))
    for name, p in got["params"].items():
        np.testing.assert_allclose(
            p.numpy(), want[name].numpy(), rtol=1e-5, atol=2e-6, err_msg=name
        )
    var = np.abs(np.asarray(jstate.gns.var_biased))
    for name in ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias"):
        np.testing.assert_allclose(
            got["gns"][name].numpy(), np.asarray(getattr(jstate.gns, name)),
            rtol=5e-3,
            atol=1e-5 * float(var.max()) if name == "sqr_biased" else 0,
            err_msg=name,
        )
    assert bool(got["gns"]["ema_is_biased"]) == bool(jstate.gns.ema_is_biased)
    assert got["step"] == int(jstate.step) == STEPS


# -- DCGAN: the generator in lockstep across two ranks --------------------


def _dcgan_inputs(out):
    """The pair's starting weights and DCGAN_STEPS global batches of 8."""
    trainer, _, generator = worker.dcgan_pair(torch.device("cpu"))
    torch.save(
        {"generator": generator.state_dict(),
         "discriminator": trainer.model.state_dict()},
        out / "dcgan-weights.pt",
    )
    rng = np.random.default_rng(5)
    np.savez(
        out / "dcgan-batches.npz",
        image=rng.normal(size=(worker.DCGAN_STEPS, 8, 32, 32, 1)).astype(np.float32),
        z=rng.normal(size=(worker.DCGAN_STEPS, 8, 8)).astype(np.float32),
    )


def test_two_rank_dcgan_keeps_the_generator_equal(port_runs):
    out = port_runs["root"] / "parity"
    ranks = [torch.load(out / f"dcgan-rank{r}.pt") for r in (0, 1)]
    for part in ("generator", "discriminator"):
        for name, p in ranks[0][part].items():
            assert torch.equal(p, ranks[1][part][name]), (part, name)
    assert ranks[0]["g_losses"] == ranks[1]["g_losses"]

    # One process on the whole batch.
    trainer, g_step, generator = worker.dcgan_pair(torch.device("cpu"))
    weights = torch.load(out / "dcgan-weights.pt")
    generator.load_state_dict(weights["generator"])
    trainer.model.load_state_dict(weights["discriminator"])
    assert not torch.equal(
        weights["generator"]["project.weight"],
        ranks[0]["generator"]["project.weight"],
    )
    batches = np.load(out / "dcgan-batches.npz")
    state, step = trainer.init_state(), trainer.train_step(8, 0)
    for i in range(worker.DCGAN_STEPS):
        batch = {k: batches[k][i] for k in ("image", "z")}
        state, _ = step(state, trainer.to_device(batch), generator)
        g_step(torch.as_tensor(batch["z"]))
    for part, model in (("generator", generator), ("discriminator", trainer.model)):
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(
                ranks[0][part][name].numpy(), p.numpy(), rtol=1e-5, atol=1e-6,
                err_msg=f"{part}.{name}",
            )


# -- elastic: preempt one rank, restart at 1, 2 and 3 replicas ------------


def _reports(out, replicas):
    reports = []
    for rank in range(replicas):
        with open(out / f"rank{rank}.json") as f:
            reports.append(json.load(f))
    return reports


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every launch of this module, run side by side where they are
    independent:

    - ``parity``: both accum settings through two port processes;
    - ``dcgan``: the DCGAN pair on two ranks;
    - ``preempted``: incarnation 0 of the elastic program at 2 replicas,
      rank 1 alone raising its exit flag after PREEMPT_AFTER steps; then
      an undisturbed 2-replica run and successors at 2, 1 and 3 replicas
      (the last two with the adaptive batch size), each from its own
      copy of the checkpoint.

    The JAX reference runs here while the launched ranks do. ``jax``
    maps each accum setting to its (metrics per step, final state);
    every elastic name to (exit code, output, one report per rank);
    ``root`` to the runs' dir.
    """
    root = tmp_path_factory.mktemp("runs")
    parity_dir = root / "parity"
    parity_dir.mkdir()
    jax_model, params = _parity_inputs(parity_dir)
    runs = {"root": root}
    launched = []
    plan = {
        "preempted": (2, 0, ["--preempt-after", str(PREEMPT_AFTER)]),
        "undisturbed": (2, 0, []),
        "same-count": (2, 1, []),
        "rescale-1": (1, 1, ["--autoscale"]),
        "rescale-3": (3, 1, ["--autoscale"]),
    }

    def start(name):
        replicas, restarts, extra = plan[name]
        ckpt = root / f"ckpt-{name}"
        if restarts:
            shutil.copytree(root / "ckpt-preempted", ckpt)
        out = root / name
        out.mkdir()
        launched.append(_start(
            [WORKER, "elastic", str(out), *extra], replicas, ckpt=ckpt,
            restarts=restarts,
        ))
        return launched[-1]

    def finish(name, proc):
        code, log = _finish(proc)
        runs[name] = (code, log, _reports(root / name, plan[name][0]))

    _dcgan_inputs(parity_dir)
    try:
        launched.append(_start([WORKER, "parity", str(parity_dir)], replicas=2))
        parity = launched[-1]
        launched.append(_start([WORKER, "dcgan", str(parity_dir)], replicas=2))
        dcgan = launched[-1]
        preempted = start("preempted")
        runs["jax"] = {
            accum: _jax_reference(parity_dir, jax_model, params, accum)
            for accum in (0, 1)
        }
        finish("preempted", preempted)
        started = {name: start(name) for name in plan if name != "preempted"}
        code, log = _finish(parity)
        assert code == 0, log
        code, log = _finish(dcgan)
        assert code == 0, log
        for name, proc in started.items():
            finish(name, proc)
        yield runs
    finally:
        # A set-up that failed part-way leaves launches running.
        for proc in launched:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()


def _completed(port_runs, name):
    """A run's reports, checked to have exited 0 with every rank in
    agreement."""
    code, log, reports = port_runs[name]
    assert code == 0, log
    for report in reports[1:]:
        for key in ("params", "step", "progress", "opened", "closed"):
            assert report[key] == reports[0][key], key
    return reports[0]


def test_preempting_one_rank_stops_every_rank_at_one_step(port_runs):
    code, log, reports = port_runs["preempted"]
    assert code == 143, log
    # The flag raised after step K on rank 1 is agreed at step K + 1's
    # check; both ranks run that step and stop before the next.
    assert [r["steps"] for r in reports] == [PREEMPT_AFTER + 1] * 2
    assert reports[0]["params"] == reports[1]["params"]
    assert checkpoint.latest_checkpoint_dir(
        str(port_runs["root"] / "ckpt-preempted")
    )


def test_restart_at_two_replicas_equals_undisturbed_run(port_runs):
    want = _completed(port_runs, "undisturbed")
    got = _completed(port_runs, "same-count")
    assert got["params"] == want["params"]
    assert got["step"] == want["step"] == worker.EPOCHS * STEPS_PER_EPOCH
    assert got["progress"] == want["progress"]
    # Resumed mid-epoch 0 after the agreed step.
    assert got["epochs"][0] == 0
    assert got["position"] == [0, (PREEMPT_AFTER + 1) * 32]
    # The out-of-loop sync of the interrupted epoch replays its
    # pre-preemption total; every later total equals the undisturbed
    # run's: steps and rows summed over the replicas.
    assert got["opened"] == want["opened"]
    assert got["closed"] == want["closed"]
    assert want["closed"][-1] == [
        2 * worker.EPOCHS * STEPS_PER_EPOCH,
        worker.EPOCHS * worker.DATASET_SIZE,
    ]


@pytest.mark.parametrize("replicas", [1, 3])
def test_rescale_resumes_at_interrupted_epoch_and_converges(
    port_runs, replicas
):
    got = _completed(port_runs, f"rescale-{replicas}")
    assert got["epochs"] == list(range(worker.EPOCHS))
    assert got["position"] == [0, (PREEMPT_AFTER + 1) * 32]
    np.testing.assert_allclose(got["params"][:4], worker.TRUE_W, atol=0.2)
    assert got["losses"][-1] < 0.1
    # Profiles of both incarnations survived the restart.
    assert got["max_profiled_replicas"] == max(2, replicas)
    assert got["profiled_replica_counts"] == sorted({2, replicas})
    # The Accumulator's totals sum every replica's steps and rows, the
    # predecessor's (flushed into the checkpoint) included.
    pre = PREEMPT_AFTER + 1
    assert got["closed"][-1] == [
        2 * pre + replicas * got["steps"],
        32 * pre + sum(
            replicas * atomic * (accum + 1) for atomic, accum in got["configs"]
        ),
    ]


# -- units ---------------------------------------------------------------


@pytest.mark.parametrize(
    "codes, want",
    [
        ([143, 143], 143),
        ([143], 143),
        ([0, 0, 0], 0),
        ([0, 3, 143], 3),
        ([137, 1], 137),
        ([143, 0], 1),
    ],
)
def test_launcher_exit_code_rule(codes, want):
    assert exit_code(codes) == want


def test_launcher_forwards_sigterm_to_every_rank(tmp_path):
    """Each rank marks itself ready, then waits for SIGTERM and exits
    143: the launcher's SIGTERM must reach all of them."""
    child = tmp_path / "child.py"
    child.write_text(
        "import os, signal, sys, time\n"
        "signal.signal(signal.SIGTERM, lambda *a: sys.exit(143))\n"
        "open(os.path.join(sys.argv[1], os.environ['ADAPTDL_REPLICA_RANK']), 'w').close()\n"
        "time.sleep(60)\n"
        "sys.exit(1)\n"
    )
    run_env = {k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")}
    run_env.update(PYTHONPATH=str(REPO), ADAPTDL_NUM_REPLICAS="3")
    proc = subprocess.Popen(
        [sys.executable, "-m", "adaptdl_tpu_torch.launch", str(child),
         str(tmp_path)],
        cwd=REPO, env=run_env, start_new_session=True,
    )
    try:
        deadline = time.monotonic() + 30
        while not all((tmp_path / str(r)).exists() for r in range(3)):
            assert time.monotonic() < deadline, "ranks never started"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 143
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def test_a_sigterm_while_exiting_leaves_the_exit_code(tmp_path):
    """A rank that has finished ignores a SIGTERM landing while it exits:
    Python restores a handler's default action during finalization, where
    the signal would kill the rank and the launcher would read a graceful
    stop (143) -- a runner's rescale racing the end of a job's budget then
    relaunched it from an older checkpoint. The launcher ignores one after
    its ranks have exited."""
    child = tmp_path / "child.py"
    child.write_text(
        "import atexit, os, signal, sys, time\n"
        "def late():\n"
        "    print('ignored at exit', signal.getsignal(signal.SIGTERM) == signal.SIG_IGN,"
        " flush=True)\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "    time.sleep(0.2)\n"
        "atexit.register(late)\n"
        "from adaptdl_tpu_torch import _signal\n"
        "_signal.install_handlers()\n"
    )
    code, log = _finish(_start(
        [str(child)], replicas=1,
        launcher=[
            "-c",
            "import signal, sys; import adaptdl_tpu_torch.launch as launch; "
            "code = launch.main(); "
            "print('launcher ignores', signal.getsignal(signal.SIGTERM) == signal.SIG_IGN); "
            "sys.exit(code)",
        ],
    ))
    assert code == 0, log
    assert "ignored at exit True" in log and "launcher ignores True" in log, log


def test_launcher_kills_the_other_ranks_when_one_fails(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(
        "import os, sys, time\n"
        "if os.environ['ADAPTDL_REPLICA_RANK'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n"
    )
    # Rank 0 would sleep for a minute; the launcher kills it after a
    # grace cut to 0.2 s and reports rank 1's code.
    code, log = _finish(_start(
        [str(child)], replicas=2,
        launcher=[
            "-c",
            "import sys; import adaptdl_tpu_torch.launch as launch; "
            "launch.FAILURE_GRACE_S = 0.2; sys.exit(launch.main())",
        ],
    ))
    assert code == 3, log


@pytest.mark.parametrize(
    "device, local_ranks, cards, want",
    [
        ("cpu", 4, 0, "gloo"),
        ("cuda", 1, 1, "nccl"),
        ("cuda", 4, 4, "nccl"),
        ("cuda", 2, 1, "gloo"),
        ("cuda", 8, 4, "gloo"),
    ],
)
def test_backend_follows_the_topology(
    device, local_ranks, cards, want, monkeypatch
):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert collective.backend_for(torch.device(device), local_ranks) == want


def test_replica_device_maps_local_rank_onto_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert replica_device("cuda", 3) == torch.device("cuda", 1)
    assert replica_device("cuda:0", 3) == torch.device("cuda", 0)
    assert replica_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        replica_device("cuda", 0)


def test_pack_and_unpack_round_trip():
    rng = np.random.default_rng(1)
    tensors = [
        torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        for shape in ((3, 4), (5,), (2, 1, 3), ())
    ]
    flat = collective.pack(tensors)
    assert flat.shape == (12 + 5 + 6 + 1,) and flat.dtype == torch.float32
    targets = [torch.zeros_like(t) for t in tensors]
    collective.unpack(flat, targets)
    for t, want in zip(targets, tensors):
        assert torch.equal(t, want)


def _tiny_trainer():
    from adaptdl_tpu_torch.models import TransformerConfig, init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    model = init_transformer(
        TransformerConfig(**worker.SIZES, dtype=torch.float32), device="cpu"
    )
    return ElasticTrainer(
        lm_loss_fn, model, AdamW(model.parameters(), lr=3e-4),
        init_batch_size=worker.INIT_BATCH, scaling_rule=AdamScale(),
        precondition="adam", device="cpu",
    )


def test_gradient_sync_is_one_all_reduce_per_step(monkeypatch):
    """On a gloo group, one step issues exactly one all-reduce and ends
    where the step without a group ends (a world of one divides by 1)."""
    import socket

    batch = {
        "tokens": np.random.default_rng(2).integers(
            0, 64, size=(2 * worker.ATOMIC, 33), dtype=np.int32
        )
    }
    alone = _tiny_trainer()
    want, _ = alone.train_step(worker.ATOMIC, 1)(
        alone.init_state(), alone.to_device(batch)
    )
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(
        dist, "all_reduce", lambda t, *a, **k: calls.append(t.numel()) or real(t, *a, **k)
    )
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    collective.initialize(
        "127.0.0.1", port, rank=0, world_size=1, device=torch.device("cpu"),
        local_world_size=1,
    )
    try:
        trainer = _tiny_trainer()
        got, m = trainer.train_step(worker.ATOMIC, 1)(
            trainer.init_state(), trainer.to_device(batch)
        )
    finally:
        collective.teardown()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    # Gradients, the group's local_sqr_mean and the loss in one buffer.
    assert calls == [n_params + trainer.num_param_groups + 1]
    for a, b in zip(got.model.parameters(), want.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(got.progress, want.progress)


def test_loader_yields_this_process_block(monkeypatch):
    from adaptdl_tpu_torch.data import AdaptiveDataLoader

    dataset = {"x": np.arange(64, dtype=np.float32)[:, None]}
    monkeypatch.setenv("ADAPTDL_NUM_REPLICAS", "2")

    def first_batch():
        checkpoint._reset_registry()
        loop = iter(AdaptiveDataLoader(dataset, batch_size=16))
        try:
            return next(loop)["x"]
        finally:
            loop.close()

    whole = first_batch()  # one process holding both replicas' rows
    assert whole.shape == (16, 1)
    monkeypatch.setenv("ADAPTDL_NUM_PROCESSES", "2")
    for rank in (0, 1):
        monkeypatch.setenv("ADAPTDL_PROCESS_RANK", str(rank))
        np.testing.assert_array_equal(
            first_batch(), whole[rank * 8 : (rank + 1) * 8]
        )


def test_one_process_per_replica_is_enforced(monkeypatch):
    import adaptdl_tpu_torch

    monkeypatch.setenv("ADAPTDL_NUM_REPLICAS", "2")
    with pytest.raises(NotImplementedError, match="one process per replica"):
        adaptdl_tpu_torch.initialize_job(device="cpu")
    with pytest.raises(NotImplementedError, match="one process per replica"):
        _tiny_trainer()
    monkeypatch.setenv("ADAPTDL_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="ADAPTDL_COORDINATOR_ADDR"):
        adaptdl_tpu_torch.initialize_job(device="cpu")
    with pytest.raises(RuntimeError, match="initialize_job"):
        _tiny_trainer()


def test_profiles_at_two_replica_counts_survive_a_checkpoint(monkeypatch):
    monkeypatch.setenv("ADAPTDL_NUM_REPLICAS", "2")
    for bsz in (8, 16):
        metrics.profile_accum_time(bsz, 0.01 * bsz)
        for _ in range(3):
            metrics.profile_step(bsz, 0, 0.02 * bsz)
    assert metrics.current_state().max_profiled_replicas == 2
    metrics.join_fit()
    saved = io.BytesIO()
    metrics._MetricsCheckpoint().save(saved)
    checkpoint._reset_registry()
    metrics._reset_state()
    saved.seek(0)
    metrics._MetricsCheckpoint().load(saved)
    assert metrics.current_state().max_profiled_replicas == 2
    monkeypatch.setenv("ADAPTDL_NUM_REPLICAS", "1")
    metrics.profile_accum_time(8, 0.07)
    for _ in range(3):
        metrics.profile_step(8, 0, 0.1)
    state = metrics.current_state()
    assert state.max_profiled_replicas == 2
    assert sorted({key[1] for key in state.profile}) == [1, 2]
    metrics.fit_now()
    assert metrics.current_state().perf_params is not None


def _replay_run(acc_cls, ckpt_mod, epoch_mod, name):
    """The JAX package's replay scenario (tests/test_accumulator.py):
    epochs add 10 * (e + 1) and read the total in an out-of-loop sync;
    a save after epoch 1, then a restart re-enters epoch 1."""
    results, acc = [], None
    for e in epoch_mod.remaining_epochs_until(3):
        acc = acc_cls(name=name) if acc is None else acc
        acc["v"] += 10 * (e + 1)
        with acc.synchronized():
            results.append(acc["v"])
        acc.reset()
        if e == 1:
            ckpt_mod.save_all_states()
            break
    ckpt_mod._reset_registry()
    epoch_mod._reset_state()
    acc = None
    for e in epoch_mod.remaining_epochs_until(3):
        acc = acc_cls(name=name) if acc is None else acc
        acc["v"] += 10 * (e + 1)
        with acc.synchronized():
            results.append(acc["v"])
        acc.reset()
    return results


def test_accumulator_replays_like_the_jax_package(tmp_path, monkeypatch):
    from adaptdl_tpu import checkpoint as jax_checkpoint
    from adaptdl_tpu import epoch as jax_epoch
    from adaptdl_tpu.accumulator import Accumulator as JaxAccumulator
    from adaptdl_tpu_torch.accumulator import Accumulator

    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path / "jax"))
    jax_epoch._reset_state()
    try:
        want = _replay_run(JaxAccumulator, jax_checkpoint, jax_epoch, "acc")
    finally:
        jax_epoch._reset_state()
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path / "port"))
    got = _replay_run(Accumulator, checkpoint, epoch, "acc")
    # Epoch 1's sync replays its recorded 20 although its body re-ran.
    assert got == want == [10, 20, 20, 30]


def test_accumulator_keeps_updates_a_save_flushed_past_a_replay(
    tmp_path, monkeypatch
):
    """Updates made after an epoch's out-of-loop sync and flushed by the
    save that preceded a restart still count once the restarted epoch
    replays that sync."""
    from adaptdl_tpu_torch.accumulator import Accumulator

    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    for _ in epoch.remaining_epochs_until(2):
        acc = Accumulator()
        with acc.synchronized():
            assert acc["n"] == 0
        acc["n"] += 5  # a step of the loop the preemption interrupted
        checkpoint.save_all_states()
        break
    checkpoint._reset_registry()
    epoch._reset_state()
    totals = []
    for e in epoch.remaining_epochs_until(2):
        acc = Accumulator() if e == 0 else acc
        with acc.synchronized():  # replayed in epoch 0
            opened = acc["n"]
        acc["n"] += 3  # the loop's remaining steps
        with acc.synchronized():
            totals.append((opened, acc["n"]))
    assert totals == [(0, 8), (8, 11)]


ASYNC_RANK = r"""
import json, os, sys, time
import torch
from adaptdl_tpu_torch import collective
rank, port, flag, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
collective.initialize("127.0.0.1", port, rank=rank, world_size=2,
                      device=torch.device("cpu"), local_world_size=2)
try:
    report = {}
    if rank == 1:
        # Hold back this rank's contribution until rank 0 has looked.
        deadline = time.monotonic() + 60
        while not os.path.exists(flag) and time.monotonic() < deadline:
            time.sleep(0.01)
    start = time.monotonic()
    future = collective.allreduce_async(rank + 1, sum)
    report["return_s"] = time.monotonic() - start
    report["done_on_return"] = future.done()
    if rank == 0:
        time.sleep(0.2)
        report["done_while_held"] = future.done()
        open(flag, "w").close()
    report["async"] = future.result(timeout=60)
    report["blocking"] = collective.allreduce(rank + 1, sum)
    report["async_any"] = collective.allreduce_async(rank == 1, any).result(60)
    report["blocking_any"] = collective.allreduce(rank == 1, any)
    report["async_group_is_default"] = (
        collective._async_group is None
        or collective._async_group == torch.distributed.group.WORLD
    )
finally:
    collective.teardown()
with open(out, "w") as f:
    json.dump(report, f)
"""


def test_allreduce_async_returns_before_the_peer_answers(tmp_path):
    """Rank 0's future is not done while rank 1 holds back its
    contribution; once it arrives both ranks get what the blocking
    ``allreduce`` gives, over a gloo group of its own."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    run_env = {k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")}
    run_env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    flag = tmp_path / "flag"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", ASYNC_RANK, str(rank), str(port), str(flag),
             str(tmp_path / f"rank{rank}.json")],
            cwd=REPO, env=run_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in (0, 1)
    ]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=120)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert [p.returncode for p in procs] == [0, 0], outputs
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert reports[0]["done_on_return"] is False
    assert reports[0]["done_while_held"] is False
    for report in reports:
        assert report["async"] == report["blocking"] == 3
        assert report["async_any"] is report["blocking_any"] is True
        assert report["async_group_is_default"] is False
