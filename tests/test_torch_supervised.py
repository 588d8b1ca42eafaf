"""The port as a job of the real JAX supervisor, and its guarded training
path against the JAX trainer's.

Protocol, against ``Supervisor(ClusterState())`` started in this process
(as tests/test_sched_services.py starts it):
- two port ranks started by ``python -m adaptdl_tpu_torch.launch``
  register their own addresses and rendezvous through ``/discover``
  (the process group's host is the address rank 0 registered),
  heartbeat (both hold leases), and rank 0 alone posts hints, which the
  JAX ``validate_hints`` accepts; the guard's incident of both ranks is
  journalled once;
- a heartbeat renews the lease; an incident is journalled and its
  repeat folds into it; ``state.publish_retune`` is adopted by the
  port's loader at its next re-optimisation, as by the JAX loader;
- the hints the port assembles equal the ones the JAX
  ``metrics.fit_and_report_now`` assembles from the same profile
  samples, at rtol 1e-6, given the same fitted parameters; the two fits
  themselves (scipy over torch autograd against scipy over JAX) predict
  the profiled step times alike at rtol 1e-2, test_torch_goodput.py's
  tolerance for them.

The slice as a whole: the port's trainer and the JAX trainer (its
``_pcast`` bound to a keyword call, as in test_torch_trainer.py) train
the same weights (``weights.py``) on the same numpy tokens through their
loaders, saving every 2 steps, marking a save good after 2 healthy
observations, grading every step, with ``guard.corrupt_grad=fail@7``.
Both roll back to the same save, their losses agree at rtol 1e-5
(float32) at every step, replays included, and their loader positions
and skip tables are equal. Two gloo ranks stay in lockstep through the
rollback: equal states after every step.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu import checkpoint as jax_checkpoint
from adaptdl_tpu import faults as jax_faults
from adaptdl_tpu import guard as jax_guard
from adaptdl_tpu import metrics as jax_metrics
from adaptdl_tpu import rpc as jax_rpc
from adaptdl_tpu import sched_hints as jax_sched_hints
from adaptdl_tpu.data import AdaptiveDataLoader as JaxLoader
from adaptdl_tpu.goodput import GoodputFunction as JaxGoodput
from adaptdl_tpu.goodput import PerfParams as JaxPerfParams
from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.parallel import create_mesh
from adaptdl_tpu.scaling_rules import AdamScale as JaxAdamScale
from adaptdl_tpu.sched.state import ClusterState
from adaptdl_tpu.sched.supervisor import Supervisor
from adaptdl_tpu.trainer import ElasticTrainer as JaxTrainer
from adaptdl_tpu_torch import (
    _signal,
    bootstrap,
    checkpoint,
    epoch,
    faults,
    guard,
    metrics,
    rpc,
    sched_hints,
)
from adaptdl_tpu_torch.data import AdaptiveDataLoader
from adaptdl_tpu_torch.goodput import GoodputFunction, PerfParams
from adaptdl_tpu_torch.models import TransformerConfig, init_transformer, lm_loss_fn
from adaptdl_tpu_torch.optim import AdamW
from adaptdl_tpu_torch.scaling_rules import AdamScale
from adaptdl_tpu_torch.trainer import ElasticTrainer
from adaptdl_tpu_torch.weights import flax_to_state_dict
from tests import torch_replica_worker as worker
from tests.torch_support import private_tempdir  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JOB = "test/job"
GUARDED_JOB = "test/guarded"
# Each rank's own address (loopback aliases, distinct from the
# launcher's 127.0.0.1 rendezvous host).
POD_IPS = ("127.0.0.2", "127.0.0.3")
FAULT_AT = 7
LAUNCH_TIMEOUT_S = 300  # a guard against hangs; the run takes ~10 s
JOB_ENV = (
    "ADAPTDL_SUPERVISOR_URL", "ADAPTDL_JOB_ID", "ADAPTDL_CHECKPOINT_PATH",
    "ADAPTDL_FAULT_SPEC", "ADAPTDL_CKPT_EVERY_STEPS",
    "ADAPTDL_GUARD_CONFIRM_STEPS", "ADAPTDL_HEARTBEAT_INTERVAL",
)


def _reset_all():
    bootstrap.stop_heartbeat()
    for reset in (
        checkpoint._reset_registry, metrics._reset_state, epoch._reset_state,
        guard._reset_state, faults.reset, rpc.reset_default_client,
        jax_guard._reset_state, jax_faults.reset, jax_metrics._reset_state,
        jax_rpc.reset_default_client,
    ):
        reset()
    _signal.set_exit_flag(False)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in JOB_ENV:
        monkeypatch.delenv(name, raising=False)
    _reset_all()
    yield
    _reset_all()


@pytest.fixture
def supervisor(monkeypatch):
    """The JAX supervisor with one job; the port's environment points
    at it."""
    state = ClusterState()
    state.create_job(JOB, spec={"max_replicas": 8})
    sup = Supervisor(state, lease_ttl=30.0)
    url = sup.start()
    monkeypatch.setenv("ADAPTDL_SUPERVISOR_URL", url)
    monkeypatch.setenv("ADAPTDL_JOB_ID", JOB)
    yield state, url
    sup.stop()


@pytest.fixture
def no_refit_threads(monkeypatch):
    """Profile samples start no refit threads: fits run when called."""
    monkeypatch.setattr(jax_metrics, "_maybe_fit_and_report", lambda *a, **k: None)
    monkeypatch.setattr(metrics, "_maybe_fit", lambda: None)


# -- two ranks under the supervisor, through the launcher ----------------


@pytest.fixture(scope="module")
def guarded_run(tmp_path_factory):
    """Two gloo ranks of tests/torch_replica_worker.py ``guarded`` under
    the JAX supervisor: register, discover, heartbeats, hints, a save
    every 2 steps, an injected NaN at observation 7."""
    out = tmp_path_factory.mktemp("guarded")
    state = ClusterState()
    state.create_job(GUARDED_JOB, spec={"max_replicas": 8})
    sup = Supervisor(state, lease_ttl=30.0)
    url = sup.start()
    try:
        run_env = {
            k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")
        }
        run_env.update(
            PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
            ADAPTDL_NUM_REPLICAS="2", ADAPTDL_NUM_RESTARTS="0",
            ADAPTDL_CHECKPOINT_PATH=str(out / "ckpt"),
            ADAPTDL_SUPERVISOR_URL=url, ADAPTDL_JOB_ID=GUARDED_JOB,
            ADAPTDL_HEARTBEAT_INTERVAL="0.2", ADAPTDL_FIT_INTERVAL="0.5",
            ADAPTDL_CKPT_EVERY_STEPS="2", ADAPTDL_GUARD_CONFIRM_STEPS="2",
            ADAPTDL_FAULT_SPEC=f"guard.corrupt_grad=fail@{FAULT_AT}",
        )
        proc = subprocess.Popen(
            [sys.executable, "-m", "adaptdl_tpu_torch.launch",
             "tests/torch_replica_worker.py", "guarded", str(out),
             "--pod-ips", ",".join(POD_IPS)],
            cwd=REPO, env=run_env, start_new_session=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        try:
            output, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            output, _ = proc.communicate()
            pytest.fail(f"guarded launch timed out:\n{output}")
        assert proc.returncode == 0, output
        reports = []
        for rank in (0, 1):
            with open(out / f"guarded-rank{rank}.json") as f:
                reports.append(json.load(f))
        record = state.get_job(GUARDED_JOB)
        yield {
            "reports": reports,
            "workers": dict(record.workers),
            "leases": dict(record.leases),
            "hints": record.hints,
            "incidents": state.incident_info()["incidents"].get(GUARDED_JOB, []),
        }
    finally:
        sup.stop()


def test_two_ranks_register_and_discover_through_the_launcher(guarded_run):
    assert guarded_run["workers"] == dict(enumerate(POD_IPS))
    assert [r["rank"] for r in guarded_run["reports"]] == [0, 1]
    # Both ranks join the group at rank 0's discovered address.
    assert [r["group_host"] for r in guarded_run["reports"]] == [POD_IPS[0]] * 2


@pytest.mark.parametrize("pod_ip,lookup,want", [
    ("10.1.2.3", "10.9.9.9", "10.1.2.3"),  # the deployment's address first
    (None, "10.9.9.9", "10.9.9.9"),  # else the host name's
    (None, OSError("no such name"), "127.0.0.5"),  # else the rendezvous host
])
def test_the_registered_address_is_the_ranks_own(monkeypatch, pod_ip, lookup, want):
    monkeypatch.setenv("ADAPTDL_COORDINATOR_ADDR", "127.0.0.5:29500")
    if pod_ip is None:
        monkeypatch.delenv("ADAPTDL_POD_IP", raising=False)
    else:
        monkeypatch.setenv("ADAPTDL_POD_IP", pod_ip)

    def gethostbyname(name):
        assert name == "worker-3"
        if isinstance(lookup, Exception):
            raise lookup
        return lookup

    monkeypatch.setattr(bootstrap.socket, "gethostname", lambda: "worker-3")
    monkeypatch.setattr(bootstrap.socket, "gethostbyname", gethostbyname)
    assert bootstrap._local_address() == want


def test_both_ranks_heartbeat(guarded_run):
    assert set(guarded_run["leases"]) == {0, 1}


def test_rank_zero_alone_posts_hints_the_jax_validator_accepts(guarded_run):
    posts = [r["hint_posts"] for r in guarded_run["reports"]]
    assert posts[0] and all(posts[0]) and posts[1] == []
    hints = guarded_run["hints"]
    jax_sched_hints.validate_hints(hints)
    assert hints["initBatchSize"] == 32 and hints["maxProfiledReplicas"] == 2
    assert set(hints["perfParams"]) == set(JaxPerfParams._fields)
    assert hints["guardStats"]["policy"] == "rollback"


def test_the_incident_of_both_ranks_is_journalled_once(guarded_run):
    (incident,) = guarded_run["incidents"]
    assert incident["kind"] == "nan_grad"
    assert incident["action"] == "rollback"
    assert incident["step"] == FAULT_AT
    assert incident["data"] == "0:192-224"


def test_ranks_stay_in_lockstep_through_the_rollback(guarded_run):
    rank0, rank1 = guarded_run["reports"]
    assert rank0["steps"] == rank1["steps"]
    assert rank0["skip_ranges"] == rank1["skip_ranges"]
    rollbacks = [s["rollbacks"] for s in rank0["steps"]]
    assert rollbacks.index(1) == FAULT_AT - 1 and rollbacks[-1] == 1
    # Saves after steps 2, 4, 6; the one after step 4 was good by
    # observation 6 and the one after step 6 was still pending at 7.
    restored = rank0["steps"][FAULT_AT - 1]
    assert restored["step"] == 4 and restored["position"] == [0, 4 * 32]
    assert restored["values"] == rank0["steps"][3]["values"]
    poisoned = rank0["steps"][FAULT_AT - 1]["span"]
    assert rank0["skip_ranges"] == [poisoned]
    after = [s["span"] for s in rank0["steps"][FAULT_AT:]]
    assert after[0] == [0, 128, 160]
    assert all(e <= poisoned[1] or s >= poisoned[2] for _, s, e in after)
    assert rank0["guard"]["rollbacks"] == 1 and rank0["guard"]["skippedBatches"] == 1
    assert len(rank0["steps"]) == worker.DATASET_SIZE // 32 + 2


# -- in process, against the supervisor ------------------------------------


def test_heartbeat_renews_the_lease(supervisor):
    state, _ = supervisor
    start = time.monotonic()
    assert sched_hints.send_heartbeat(rank=0, step_time_ewma=0.25)
    first = state.get_job(JOB).leases[0]
    assert first >= start + 30.0
    time.sleep(0.05)
    assert sched_hints.send_heartbeat(rank=0)
    assert state.get_job(JOB).leases[0] > first


def test_heartbeat_thread_beats_and_stops(supervisor, monkeypatch):
    state, _ = supervisor
    monkeypatch.setenv("ADAPTDL_HEARTBEAT_INTERVAL", "0.05")
    stop = bootstrap.start_heartbeat()
    assert bootstrap.start_heartbeat() is stop  # idempotent
    deadline = time.monotonic() + 10
    while 0 not in state.get_job(JOB).leases and time.monotonic() < deadline:
        time.sleep(0.02)
    bootstrap.stop_heartbeat()
    assert 0 in state.get_job(JOB).leases
    assert stop.is_set() and not bootstrap._heartbeat_thread.is_alive()


def test_incident_is_journalled_and_its_repeat_folds(supervisor):
    state, _ = supervisor
    state.update(JOB, allocation=["slot-a"])
    for _ in range(2):
        assert guard.post_incident(
            "loss_spike", step=3, data_id="0:8-16", action="skip"
        )
    (incident,) = state.incident_info()["incidents"][JOB]
    assert incident["kind"] == "loss_spike" and incident["step"] == 3
    assert incident["data"] == "0:8-16" and incident["action"] == "skip"
    # The worker reports its rank; the supervisor resolves its slot.
    assert incident["slot"] == "slot-a"


def test_without_a_supervisor_nothing_is_posted(monkeypatch):
    assert not guard.post_incident("nan_loss")
    assert not sched_hints.send_heartbeat()
    assert not sched_hints.post_sched_hints({"initBatchSize": 1})
    assert sched_hints.fetch_job_config() is None
    assert bootstrap.start_heartbeat() is None


def _retune_configs(loader_cls, state, job, monkeypatch, steps=6):
    """The loader's configuration per step; the job's decision is
    published after its second step."""
    state.create_job(job, spec={"max_replicas": 8})
    state.update(job, allocation=["slot-0"])
    monkeypatch.setenv("ADAPTDL_JOB_ID", job)
    loader = loader_cls({"x": np.arange(256, dtype=np.float32)}, batch_size=32)
    loader.autoscale_batch_size(
        64, local_bsz_bounds=(8, 64), gradient_accumulation=True
    )
    loader._reoptimize_every = 2
    configs = []
    for k, _ in enumerate(loader):
        configs.append((loader.current_atomic_bsz, loader.current_accum_steps))
        if k == 1:
            assert state.publish_retune(job, {"atomicBsz": 16, "accumSteps": 1})
        if k + 1 == steps:
            break
    return configs


def test_published_retune_is_adopted_like_the_jax_loader(
    supervisor, monkeypatch, no_refit_threads
):
    state, _ = supervisor
    want = _retune_configs(JaxLoader, state, "test/jax", monkeypatch)
    got = _retune_configs(AdaptiveDataLoader, state, "test/port", monkeypatch)
    assert got == want == [(32, 0)] * 2 + [(16, 1)] * 4
    assert metrics.current_state().num_retunes == 1


@pytest.mark.parametrize("slots,config,want", [
    (1, {"atomicBsz": 16, "accumSteps": 1}, (16, 1)),
    (1, {"atomicBsz": 20, "accumSteps": 0}, (16, 0)),  # bucketed down
    (2, {"atomicBsz": 16, "accumSteps": 1}, None),  # another allocation
    (1, {"atomicBsz": 64, "accumSteps": 1}, None),  # past max_batch_size
    (1, {"atomicBsz": 0, "accumSteps": 1}, (8, 1)),  # up to the lower bound
])
def test_supervisor_decision_is_checked_like_jax(
    supervisor, monkeypatch, slots, config, want
):
    state, _ = supervisor
    state.update(JOB, allocation=["slot"] * slots)
    assert state.publish_retune(JOB, config)
    data = {"x": np.arange(64, dtype=np.float32)}
    decisions = []
    for loader_cls in (JaxLoader, AdaptiveDataLoader):
        loader = loader_cls(data, batch_size=32)
        loader.autoscale_batch_size(64, local_bsz_bounds=(8, 64))
        decisions.append(loader._supervisor_decision(1))
    assert decisions == [want, want]


# -- hint assembly against the JAX package's --------------------------------

FIXED_PERF = dict(
    alpha_c=0.0123, beta_c=0.00321, alpha_n=0.02, beta_n=0.004,
    alpha_r=0.011, beta_r=0.0025, gamma=1.37,
)
PROFILE = [(8, 0, 0.021), (16, 0, 0.038), (32, 0, 0.072), (16, 1, 0.071),
           (32, 1, 0.139), (8, 3, 0.069)]


def _assembled_hints(module, port, monkeypatch, fixed):
    captured = []
    monkeypatch.setattr(
        module.sched_hints, "post_sched_hints",
        lambda hints: captured.append(hints) or True,
    )
    if fixed:
        perf_cls = PerfParams if port else JaxPerfParams
        monkeypatch.setattr(module, "_fit", lambda: perf_cls(**FIXED_PERF))
    module.set_batch_size_config(32, 256, (8, 64), True)
    for bsz, t in ((8, 0.02), (16, 0.036), (32, 0.07)):
        module.profile_accum_time(bsz, t)
    for k, (bsz, accum, t) in enumerate(PROFILE * 2):
        if k == 3:
            module.note_unhealthy_step()
        module.profile_step(bsz, accum, t * (1 + 0.02 * k))
    module.update_grad_params(0.12, 3.4)
    if port:
        module.record_checkpoint_save(2.5, 0.0, {}, total_bytes=1 << 20)
    else:
        module.record_checkpoint_save(2.5, 0.0, {}, kind="full", total_bytes=1 << 20)
    module.record_checkpoint_restore("elastic_trainer", 1.5)
    module.fit_and_report_now()
    (hints,) = captured
    return hints


def _assert_close(got, want, path="hints"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _assert_close(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for k, (a, b) in enumerate(zip(got, want)):
            _assert_close(a, b, f"{path}[{k}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=path)
    else:
        assert got == want, path


def test_hints_equal_the_jax_assembly(monkeypatch, no_refit_threads):
    want = _assembled_hints(jax_metrics, False, monkeypatch, fixed=True)
    got = _assembled_hints(metrics, True, monkeypatch, fixed=True)
    _assert_close(got, want)
    sched_hints.validate_hints(got)
    jax_sched_hints.validate_hints(got)
    assert got["perfParams"]["gamma"] == FIXED_PERF["gamma"]
    assert got["restartStats"]["restoreS"] == 1.5
    assert got["guardStats"]["unhealthySteps"] == 0  # the guard saw nothing
    assert got["measuredGoodput"] > 0


def test_fits_of_the_same_samples_predict_alike(monkeypatch, no_refit_threads):
    want = _assembled_hints(jax_metrics, False, monkeypatch, fixed=False)
    got = _assembled_hints(metrics, True, monkeypatch, fixed=False)
    _assert_close(
        {k: v for k, v in got.items() if k != "perfParams"},
        {k: v for k, v in want.items() if k != "perfParams"},
    )
    grad = (want["gradParams"]["sqr"], want["gradParams"]["var"])
    ours = GoodputFunction(PerfParams(**got["perfParams"]), grad, 32)
    theirs = JaxGoodput(JaxPerfParams(**want["perfParams"]), grad, 32)
    for bsz, accum, _ in PROFILE:
        np.testing.assert_allclose(
            ours.throughput(1, 1, bsz, accum), theirs.throughput(1, 1, bsz, accum),
            rtol=1e-2, err_msg=str((bsz, accum)),
        )


def test_fit_thread_posts_to_the_supervisor(supervisor, monkeypatch):
    state, _ = supervisor
    monkeypatch.setenv("ADAPTDL_FIT_INTERVAL", "1000")
    metrics.set_batch_size_config(32)
    metrics.profile_accum_time(32, 0.05)
    metrics.profile_step(32, 0, 0.06)  # the first sample starts a refit
    metrics.join_fit()
    hints = state.get_job(JOB).hints
    jax_sched_hints.validate_hints(hints)
    assert hints["initBatchSize"] == 32 and hints["maxProfiledReplicas"] == 1
    assert hints["perfParams"]["alpha_c"] >= 0


# -- the slice as a whole: both trainers roll back alike --------------------

SIZES = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64)
INIT_BATCH = 2
BATCH = 4


def _tokens():
    rng = np.random.default_rng(5)
    return rng.integers(0, 64, size=(64, 33), dtype=np.int32)


def _jax_guarded_run(params):
    jax_model = jax_init(
        JaxConfig(**SIZES, max_seq_len=32, dtype=jnp.float32, remat=True), seq_len=32
    )[0]

    def jax_loss(p, batch, rng):
        tokens = batch["tokens"]
        logits = jax_model.apply({"params": p}, tokens[:, :-1], train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tokens[:, 1:]
        ).mean()

    trainer = JaxTrainer(
        jax_loss, params, optax.adamw(3e-4), INIT_BATCH,
        scaling_rule=JaxAdamScale(), precondition="adam",
        mesh=create_mesh(devices=jax.devices()[:1]),
    )
    trainer.metrics_every = 1
    trainer._steps_since_pull = 0
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    jax_checkpoint.load_state(ckpt)
    loader = JaxLoader({"tokens": _tokens()}, batch_size=BATCH)
    g = jax_guard._get_guard()
    steps = []
    for batch in loader:
        span = loader.current_batch_span()
        rollbacks = g.rollbacks
        new, out = trainer.run_step(holder["state"], batch, loader)
        # The JAX run_step returns the step's own state; after a
        # rollback the restored one is what set_state wrote.
        if g.rollbacks == rollbacks:
            holder["state"] = new
        steps.append({
            "span": span, "loss": float(out["loss"]), "rollbacks": g.rollbacks,
            "step": int(holder["state"].step),
            "position": (loader.sampler.epoch, loader.sampler.index),
        })
    return steps, list(loader._skip_ranges), jax_checkpoint._loaded_from.get(
        "elastic_trainer"
    )


def _port_guarded_run(params):
    model = init_transformer(
        TransformerConfig(**SIZES, dtype=torch.float32, remat=True), device="cpu"
    )
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    trainer = ElasticTrainer(
        lm_loss_fn, model, AdamW(model.parameters(), lr=3e-4),
        init_batch_size=INIT_BATCH, scaling_rule=AdamScale(),
        precondition="adam", device="cpu",
    )
    trainer.metrics_every = 1
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    checkpoint.load_state(ckpt)
    loader = AdaptiveDataLoader({"tokens": _tokens()}, batch_size=BATCH)
    g = guard._get_guard()
    steps = []
    for batch in loader:
        span = loader.current_batch_span()
        holder["state"], out = trainer.run_step(holder["state"], batch, loader)
        steps.append({
            "span": span, "loss": float(out["loss"]), "rollbacks": g.rollbacks,
            "step": int(holder["state"].step),
            "position": (loader.sampler.epoch, loader.sampler.index),
        })
    return steps, list(loader._skip_ranges), checkpoint._loaded_from.get(
        "elastic_trainer"
    )


def test_port_and_jax_trainers_roll_back_alike(tmp_path, monkeypatch):
    import adaptdl_tpu.trainer as jax_trainer_mod

    monkeypatch.setattr(
        jax_trainer_mod, "_pcast",
        lambda x, axes, to: jax.lax.pcast(x, axes, to=to),
    )
    # The JAX loader's periodic saves write in the background; blocking
    # writes register each good-marker candidate before the next
    # observation, as the port's blocking saves do.
    real_save = jax_checkpoint.save_all_states
    monkeypatch.setattr(
        jax_checkpoint, "save_all_states",
        lambda **kw: real_save(**{**kw, "wait": True}),
    )
    monkeypatch.setattr(jax_metrics, "_maybe_fit_and_report", lambda *a, **k: None)
    monkeypatch.setattr(metrics, "_maybe_fit", lambda: None)
    monkeypatch.setenv("ADAPTDL_CKPT_EVERY_STEPS", "2")
    monkeypatch.setenv("ADAPTDL_GUARD_CONFIRM_STEPS", "2")
    monkeypatch.setenv("ADAPTDL_FAULT_SPEC", f"guard.corrupt_grad=fail@{FAULT_AT}")
    params = jax_init(
        JaxConfig(**SIZES, max_seq_len=32, dtype=jnp.float32, remat=True), seq_len=32
    )[1]
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path / "jax"))
    want_steps, want_skips, want_dir = _jax_guarded_run(params)
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path / "port"))
    got_steps, got_skips, got_dir = _port_guarded_run(params)

    assert os.path.basename(got_dir) == os.path.basename(want_dir) == "checkpoint-0.1"
    assert got_skips == want_skips == [(0, 24, 28)]
    assert len(got_steps) == len(want_steps) == 64 // BATCH + 2
    for k, (got, want) in enumerate(zip(got_steps, want_steps)):
        for key in ("span", "rollbacks", "step", "position"):
            assert got[key] == want[key], (k, key)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=str(k))
    rolled = got_steps[FAULT_AT - 1]
    assert rolled["rollbacks"] == 1 and rolled["step"] == 4
    assert rolled["position"] == (0, 4 * BATCH)
    # The replayed steps repeat the losses of the steps they replay.
    for k in (4, 5):
        np.testing.assert_allclose(
            got_steps[k + 3]["loss"], got_steps[k]["loss"], rtol=1e-6
        )
