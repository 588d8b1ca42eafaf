"""The port's warm successor held to the JAX package's.

``adaptdl_tpu_torch.sched.warmup`` is the copy of ``adaptdl_tpu.sched.
warmup``, its successor N processes under the port's launcher. Covered:

- the protocol units: ``candidate_matches`` answers as the JAX function on
  the same inputs, ``fetch_candidate`` reads the port's supervisor as the
  JAX one does, ``_await_cutover`` renders the same verdicts, and a
  ``WarmSuccessor`` runs through ready and cutover, and through discard;
  ``maybe_hold`` on ``abort`` exits 143;
- a two-rank successor under the launcher (``initialize_job`` on the CPU,
  gloo): ready only once both ranks hold, no supervisor traffic before
  the go (the allocation epoch stays pending), and after it both ranks
  register and beat, which commits it;
- the differential pull: after a warm prefetch it moves strictly fewer
  bytes and restores bit-identically, a stale cache degrades to the full
  pull bit-identically, ``ADAPTDL_HANDOFF_DIFF=off`` reuses nothing, and a
  failed prefetch leaves the restore path's verdict alone;
- the runner end to end with a torch-only job whose weights are a pure
  function of its step count (the JAX tests' simulated job), rescaled
  1 -> 2 ranks: a warm cutover loses zero steps and reads no storage, and
  the spawn fault, a successor killed while warming, an incumbent crash
  before the cutover, a mispredicted candidate and a stale restart
  counter each fall back cold, loss-equal (weights bit-equal to
  uninterrupted training), and with the supervisor killed and recovered
  from its journal before the rescale the warm cutover and the weights
  are the same.

Every subprocess has its own timeout, and a runner test its watchdog.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from adaptdl_tpu.sched import warmup as jax_warmup
from adaptdl_tpu_torch import checkpoint, faults, handoff, rpc
from adaptdl_tpu_torch.sched import multi_runner, warmup
from adaptdl_tpu_torch.sched.local_runner import LocalElasticRunner
from adaptdl_tpu_torch.sched.state import ClusterState
from adaptdl_tpu_torch.sched.supervisor import Supervisor
from tests.torch_support import private_tempdir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1234
PROC_TIMEOUT_S = 60
RUNNER_WALL_S = 150.0


@pytest.fixture(autouse=True)
def _clean_state():
    faults.reset()
    rpc.reset_default_client()
    handoff.set_source(None)
    handoff._reset_client_state()
    warmup._reset_state()
    yield
    faults.reset()
    rpc.reset_default_client()
    handoff.set_source(None)
    handoff._reset_client_state()
    warmup._reset_state()
    checkpoint._reset_registry()


def _child_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["ADAPTDL_HANDOFF"] = "off"
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


# ---- protocol units --------------------------------------------------------


CANDIDATES = [
    (None, ["a"], None),
    ({"allocation": ["a", "b"], "topology": None}, ["a", "b"], None),
    ({"allocation": ["a", "b"], "topology": None}, ["a"], None),
    ({"allocation": ["a"], "topology": {"modelShards": 1, "seqShards": 1}},
     ["a"], None),
    ({"allocation": ["a"], "topology": {"modelShards": 2}}, ["a"], None),
    ({"allocation": ["a"], "topology": {"modelShards": 2}}, ["a"],
     {"modelShards": 2}),
    ({"allocation": ["a"], "topology": {"stageShards": 2}}, ["a"],
     {"stageShards": 2, "pipelineMicro": 4}),
    ({"allocation": [], "topology": None}, [], None),
]


@pytest.mark.parametrize("candidate,allocation,topology", CANDIDATES)
def test_candidate_matches_answers_as_the_jax_function(
    candidate, allocation, topology
):
    assert warmup.candidate_matches(
        candidate, allocation, topology
    ) == jax_warmup.candidate_matches(candidate, allocation, topology)


def test_fetch_candidate_reads_the_supervisor_as_the_jax_function():
    state = ClusterState(alloc_commit_timeout=0.0)
    state.create_job("ns/a")
    state.update("ns/a", allocation=["s0"], status="Running")
    sup = Supervisor(state)
    url = sup.start()
    try:
        assert warmup.fetch_candidate(url, "ns/a") is None
        assert warmup.fetch_candidate(url, "ns/missing") is None
        state.publish_candidate(
            "ns/a", ["s0", "s1"], topology={"seqShards": 2},
            batch_config={"atomicBsz": 8, "accumSteps": 1},
        )
        got = warmup.fetch_candidate(url, "ns/a")
        assert got == jax_warmup.fetch_candidate(url, "ns/a")
        assert got["allocation"] == ["s0", "s1"] and got["epoch"] == 1
    finally:
        sup.stop()


@pytest.mark.parametrize("verdict", [None, "go", "abort", ""])
def test_await_cutover_renders_the_jax_verdicts(tmp_path, verdict):
    path = None
    if verdict is not None:
        path = str(tmp_path / "cutover")
        warmup._write_atomic(path, verdict)
    assert warmup._await_cutover(path) == jax_warmup._await_cutover(path)
    assert warmup._await_cutover(path) == (
        warmup.ABORT if verdict == "abort" else warmup.GO
    )


HOLD_SCRIPT = textwrap.dedent(
    """
    import sys
    from adaptdl_tpu_torch.sched import warmup

    held = warmup.maybe_hold()
    print("RELEASED", held, flush=True)
    sys.exit(0)
    """
)


def _hold_script(tmp_path):
    script = tmp_path / "hold.py"
    script.write_text(HOLD_SCRIPT)
    return str(script)


def test_a_warm_successor_holds_until_its_cutover(tmp_path):
    warm = warmup.WarmSuccessor(
        [sys.executable, _hold_script(tmp_path)], _child_env(),
        ["local", "local"], None, restarts=1,
    )
    warm.spawn()
    try:
        assert warm.wait_ready(PROC_TIMEOUT_S), "never marked ready"
        assert warm.alive(), "a ready successor holds"
        assert warm.matches(["local", "local"], None)
        assert warm.matches(["local", "local"], {"modelShards": 1})
        assert not warm.matches(["local"], None)
        proc = warm.cutover()
        assert proc.wait(PROC_TIMEOUT_S) == 0
    finally:
        warm.discard()
    assert not os.path.exists(warm.workdir)


def test_a_discarded_warm_successor_is_killed_and_cleaned(tmp_path):
    warm = warmup.WarmSuccessor(
        [sys.executable, _hold_script(tmp_path)], _child_env(), ["local"],
        None, restarts=2,
    )
    warm.spawn()
    assert warm.wait_ready(PROC_TIMEOUT_S)
    proc = warm.proc
    warm.discard("test discard")
    assert proc.poll() is not None, "discard reaps the successor"
    assert proc.returncode != 0
    assert not os.path.exists(warm.workdir)


def test_maybe_hold_exits_143_on_abort(tmp_path):
    ready, cut = str(tmp_path / "ready"), str(tmp_path / "cutover")
    proc = subprocess.Popen(
        [sys.executable, _hold_script(tmp_path)],
        env=_child_env(ADAPTDL_WARMUP="1", ADAPTDL_WARMUP_READY_FILE=ready,
                       ADAPTDL_WARMUP_CUTOVER_FILE=cut),
        stdout=subprocess.PIPE,
    )
    try:
        deadline = time.monotonic() + PROC_TIMEOUT_S
        while time.monotonic() < deadline and not os.path.exists(ready):
            assert proc.poll() is None, "died before marking ready"
            time.sleep(0.05)
        assert os.path.exists(ready)
        warmup._write_atomic(cut, warmup.ABORT)
        out, _ = proc.communicate(timeout=PROC_TIMEOUT_S)
        assert proc.returncode == 143
        assert b"RELEASED" not in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_maybe_hold_is_a_no_op_in_a_normal_launch(monkeypatch):
    monkeypatch.delenv("ADAPTDL_WARMUP", raising=False)
    assert warmup.maybe_hold() is False
    assert warmup.hold_info()["held"] is False


# ---- a two-rank successor under the launcher -----------------------------------

RANKS_SCRIPT = textwrap.dedent(
    """
    import os, sys, time
    import adaptdl_tpu_torch
    from adaptdl_tpu_torch import collective, env
    from adaptdl_tpu_torch.sched import warmup

    adaptdl_tpu_torch.initialize_job(device="cpu")
    if env.replica_rank() == 1:
        time.sleep(float(os.environ["RANK1_DELAY_S"]))
    warmup.maybe_hold()
    total = collective.allreduce(env.replica_rank() + 1, sum)
    with open(os.environ["RANKS_LOG"], "a") as f:
        f.write("released %d %d\\n" % (env.replica_rank(), total))
    time.sleep(1.5)  # heartbeats land
    sys.exit(0)
    """
)


def test_a_two_rank_successor_is_ready_once_both_ranks_hold(tmp_path):
    job = "ns/two"
    state = ClusterState(alloc_commit_timeout=60.0)
    state.create_job(job)
    state.update(job, allocation=["local"], status="Running")
    state.renew_lease(job, 0, 30.0, group=0)  # the incumbent's epoch
    state.update(job, allocation=["local", "local"])  # pending
    sup = Supervisor(state, lease_ttl=30.0)
    sup.start()
    script = tmp_path / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    log = tmp_path / "ranks.log"
    env = multi_runner.job_environment(
        _child_env(RANK1_DELAY_S="5", RANKS_LOG=str(log),
                   ADAPTDL_HEARTBEAT_INTERVAL="0.2"),
        job, str(tmp_path / "ckpt"), 2, None, 1, sup.url,
    )
    warm = warmup.WarmSuccessor(
        multi_runner.launch_command(str(script)), env,
        ["local", "local"], None, restarts=1,
    )
    warm.spawn()
    try:
        deadline = time.monotonic() + PROC_TIMEOUT_S
        while not os.path.exists(warm.ready_file + ".0"):
            assert time.monotonic() < deadline and warm.alive()
            time.sleep(0.05)
        assert not os.path.exists(warm.ready_file), (
            "ready with rank 1 not yet holding"
        )
        assert warm.wait_ready(PROC_TIMEOUT_S)
        assert os.path.exists(warm.ready_file + ".1")
        record = state.get_job(job)
        assert record.group == 0 and record.alloc_state == "pending", (
            "a held successor's group reached the supervisor"
        )
        assert not record.workers
        proc = warm.cutover()
        assert proc.wait(PROC_TIMEOUT_S) == 0
        lines = sorted(log.read_text().split("\n")[:-1])
        assert lines == ["released 0 3", "released 1 3"]
        record = state.get_job(job)
        assert record.group == 1 and record.alloc_state == "committed"
        assert sorted(record.workers) == [0, 1]
    finally:
        warm.discard()
        sup.stop()


def test_an_aborted_two_rank_successor_exits_143_on_every_rank(tmp_path):
    env = multi_runner.job_environment(
        _child_env(), "ns/x", str(tmp_path / "ckpt"), 2, None, 1,
        "http://127.0.0.1:9",
    )
    env.pop("ADAPTDL_SUPERVISOR_URL")
    warm = warmup.WarmSuccessor(
        multi_runner.launch_command(_hold_script(tmp_path)), env,
        ["local", "local"], None, restarts=1,
    )
    warm.spawn()
    try:
        assert warm.wait_ready(PROC_TIMEOUT_S)
        warmup._write_atomic(warm.cutover_file, warmup.ABORT)
        assert warm.proc.wait(PROC_TIMEOUT_S) == 143, (
            "every rank exits 143, so the launcher does"
        )
    finally:
        warm.discard()


# ---- the differential pull ---------------------------------------------------


class Chunky(checkpoint.State):
    """One chunk per named part."""

    def __init__(self, name, parts=None):
        super().__init__(name)
        self.parts = dict(parts or {})

    def save(self, fileobj):
        pickle.dump(self.parts, fileobj)

    def load(self, fileobj):
        self.parts = pickle.load(fileobj)

    def snapshot_chunks(self, snapshot):
        parts = pickle.loads(snapshot)
        return [(k, pickle.dumps(v)) for k, v in sorted(parts.items())]

    def load_chunks(self, chunks):
        self.parts = {k: pickle.loads(data) for k, data in chunks}


def _big_parts():
    rng = np.random.default_rng(0)
    return {
        "a": rng.integers(0, 255, size=200_000, dtype=np.uint8),
        "b": rng.integers(0, 255, size=100_000, dtype=np.uint8),
        "step": 1,
    }


def _parts_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def _restore_from(state, expected):
    server = handoff.serve_states()
    try:
        handoff.set_source(server.url)
        before = handoff.fetch_stats()
        state.parts = None
        assert checkpoint.load_state(state)
        _parts_equal(state.parts, expected)
        after = handoff.fetch_stats()
        return (after["bytes"] - before["bytes"],
                after["reused"] - before["reused"])
    finally:
        server.stop()


def _warm_prefetch(state):
    server = handoff.serve_states()
    try:
        cached = handoff.warm_prefetch(url=server.url)
    finally:
        server.stop()
    assert cached > 0
    return cached


def test_the_differential_pull_moves_strictly_fewer_bytes(
    tmp_path, monkeypatch
):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    state = Chunky("diff", _big_parts())
    _warm_prefetch(state)
    # The incumbent steps on: only "b" and "step" change.
    state.parts["step"] = 2
    state.parts["b"] = state.parts["b"][::-1].copy()
    expected = dict(state.parts)
    diff_bytes, reused = _restore_from(state, expected)
    assert reused > 0 and diff_bytes > 0
    handoff.set_source(None)
    handoff._reset_client_state()
    state.parts = dict(expected)
    full_bytes, full_reused = _restore_from(state, expected)
    assert full_reused == 0
    assert diff_bytes < full_bytes
    assert diff_bytes + reused == full_bytes


def test_a_stale_warm_cache_degrades_to_the_full_pull(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    state = Chunky("stale", _big_parts())
    _warm_prefetch(state)
    state.parts = {
        "a": state.parts["a"][::-1].copy(),
        "b": state.parts["b"][::-1].copy(),
        "step": 3,
    }
    fetched, reused = _restore_from(state, dict(state.parts))
    assert reused == 0 and fetched > 300_000


def test_the_diff_knob_off_reuses_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("ADAPTDL_HANDOFF_DIFF", "off")
    state = Chunky("nodiff", _big_parts())
    _warm_prefetch(state)
    fetched, reused = _restore_from(state, dict(state.parts))
    assert reused == 0 and fetched > 300_000


def test_a_failed_prefetch_leaves_the_restore_path_alone(
    tmp_path, monkeypatch
):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("ADAPTDL_HANDOFF_TIMEOUT_S", "1")
    state = Chunky("fresh", _big_parts())
    assert handoff.warm_prefetch(url="http://127.0.0.1:9") == 0
    faults.configure("warmup.prefetch=fail@1", seed=SEED)
    server = handoff.serve_states()
    try:
        assert handoff.warm_prefetch(url=server.url) == 0
    finally:
        server.stop()
    faults.configure(None)
    assert not handoff._unavailable and handoff._manifest is None
    expected = dict(state.parts)
    fetched, reused = _restore_from(state, expected)
    assert reused == 0 and fetched > 300_000


# ---- the runner end to end -------------------------------------------------------

# A torch-only elastic job: an EMA toward TRUE_W, so its weights are a
# pure function of the step count and any correct restart discipline
# ends bit-identical. On SIGTERM it saves, leaves a shard server behind
# (the planned path) and exits 143. Every rank writes its lines.
SIM_SCRIPT = textwrap.dedent(
    """
    import os
    import pickle
    import sys
    import time

    import numpy as np

    from adaptdl_tpu_torch import _signal, checkpoint, env, handoff, trace
    from adaptdl_tpu_torch.sched import warmup

    _signal.install_handlers()
    LOG = os.environ["SIM_LOG"]

    def emit(line):
        with open(LOG, "a") as f:
            f.write("%s r%d\\n" % (line, env.replica_rank()))

    if os.environ.get("SIM_WARM_SUICIDE") and os.environ.get("ADAPTDL_WARMUP"):
        os._exit(9)  # the speculative successor dies before ready

    warmup.maybe_hold()  # idempotent: load_state's call is then a no-op

    class Sim(checkpoint.State):
        def __init__(self):
            super().__init__("sim")
            self.w = np.zeros(4)
            self.step = 0

        def save(self, f):
            pickle.dump({"w": self.w, "step": self.step}, f)

        def load(self, f):
            d = pickle.load(f)
            self.w, self.step = d["w"], d["step"]

        def snapshot_chunks(self, snapshot):
            d = pickle.loads(snapshot)
            return [("w", pickle.dumps(d["w"])),
                    ("step", pickle.dumps(d["step"]))]

        def load_chunks(self, chunks):
            d = {k: pickle.loads(v) for k, v in chunks}
            self.w, self.step = d["w"], d["step"]

    state = Sim()
    restarts = env.num_restarts()
    mode = "warm" if warmup.hold_info()["verdict"] == warmup.GO else "cold"
    first = max((r["seq"] for r in trace.snapshot_spans()), default=0)
    checkpoint.load_state(state)
    spans = sorted({r["name"] for r in trace.snapshot_spans()
                    if r["seq"] > first})
    emit("start %d %s %d %s" % (restarts, mode, state.step,
                                "|".join(spans) or "-"))
    TRUE_W = np.array([1.0, -2.0, 3.0, 0.5])
    total = int(os.environ.get("SIM_TOTAL_STEPS", "80"))
    # The first incarnation waits at PAUSE_AT for its rescale however long
    # the successor takes to warm on a loaded machine: it must not finish.
    pause_at = total // 2 if restarts == 0 else total
    while state.step < total:
        if _signal.get_exit_flag():
            if os.environ.get("SIM_CRASH_ON_TERM"):
                emit("crash %d %d" % (restarts, state.step))
                os._exit(7)
            serve = env.handoff_enabled()
            handle = checkpoint.save_all_states(retain_snapshots=serve)
            if serve:
                handoff.spawn_server(snapshots=handle.snapshots)
            emit("drain %d %d" % (restarts, state.step))
            sys.exit(143)
        if state.step >= pause_at:
            time.sleep(0.04)
            continue
        state.w = state.w + 0.1 * (TRUE_W - state.w)
        state.step += 1
        if state.step % 25 == 0:
            checkpoint.save_all_states()
        time.sleep(0.04)
    checkpoint.save_all_states()
    emit("done %d %d %s" % (restarts, state.step,
                            ",".join("%.17g" % v for v in state.w)))
    sys.exit(0)
    """
)

TRUE_W = np.array([1.0, -2.0, 3.0, 0.5])
ALLOC = ["local", "local"]


def _expected_w(steps):
    w = np.zeros(4)
    for _ in range(steps):
        w = w + 0.1 * (TRUE_W - w)
    return w


def _log_lines(log):
    with open(log, encoding="utf-8") as f:
        return [line.split() for line in f.read().splitlines() if line]


def _make_runner(tmp_path, job, handoff_on=True, sim_env=None, state_dir=None):
    script = tmp_path / "sim.py"
    script.write_text(SIM_SCRIPT)
    log = str(tmp_path / "sim.log")
    extra = {
        "SIM_LOG": log, "OMP_NUM_THREADS": "1",
        # Generous for a loaded machine: the runner waits only until ready.
        "ADAPTDL_WARMUP_DEADLINE_S": "60",
    }
    extra.update(sim_env or {})
    runner = LocalElasticRunner(
        str(script), num_chips=2, checkpoint_dir=str(tmp_path / "ckpt"),
        job_name=job, max_replicas=1, allocator_interval=9999.0,
        extra_env=extra, handoff=handoff_on, state_dir=state_dir,
    )
    # Every decision comes from the test: the allocator stays out.
    runner.allocator.optimize_once = lambda: {}
    runner.state.update(job, allocation=["local"])
    return runner, log


def _run_elastic(tmp_path, monkeypatch, *, sim_env=None, fault_spec=None,
                 restart_control_plane=False):
    """One job, 1 rank -> 2 ranks once the incumbent has stepped a while:
    the candidate is published just ahead of the decision, as the
    allocator does. ``restart_control_plane``: the supervisor, allocator
    and journaled state are restarted before the decision."""
    monkeypatch.setenv("ADAPTDL_WARMUP_ENABLED", "on")
    if fault_spec:
        faults.configure(fault_spec, seed=SEED)
    job = "test/warm"
    runner, log = _make_runner(
        tmp_path, job, sim_env=sim_env,
        state_dir=str(tmp_path / "sched") if restart_control_plane else None,
    )
    errors = []

    def drive():
        deadline = time.monotonic() + RUNNER_WALL_S
        try:
            while not (os.path.exists(log) and any(
                    line[:2] == ["start", "0"] for line in _log_lines(log))):
                if time.monotonic() > deadline:
                    raise AssertionError("the incumbent never started")
                time.sleep(0.05)
            time.sleep(0.8)
            if restart_control_plane:
                recovered = runner.restart_control_plane()[job]
                assert recovered["allocation"] == ["local"]
                assert recovered["restarts"] == 0
                runner.allocator.optimize_once = lambda: {}
            runner.state.publish_candidate(job, ALLOC, None)
            runner.state.update(job, allocation=ALLOC)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    fired = []

    def watchdog():
        fired.append(True)
        runner.state.update(job, status="Failed")
        proc = runner.proc
        if proc is not None and proc.poll() is None:
            multi_runner.kill_incarnation(proc)

    driving = threading.Thread(target=drive, daemon=True)
    timer = threading.Timer(RUNNER_WALL_S, watchdog)
    timer.daemon = True
    driving.start()
    timer.start()
    try:
        code = runner.run()
    finally:
        timer.cancel()
        timer.join()
        driving.join(10)
    assert not fired, f"the runner exceeded {RUNNER_WALL_S} s"
    assert not errors, errors
    return code, _log_lines(log), runner


def _check_loss_equal(code, lines, runner, modes):
    assert code == 0
    assert runner.state.get_job("test/warm").status == "Succeeded"
    starts = sorted(line for line in lines if line[0] == "start")
    assert [line[1:3] for line in starts] == modes, starts
    dones = [line for line in lines if line[0] == "done"]
    assert len(dones) == 2, "both ranks of the last incarnation finish"
    for done in dones:
        assert int(done[2]) == 80
        np.testing.assert_array_equal(
            np.array([float(v) for v in done[3].split(",")]), _expected_w(80)
        )
    return starts


@pytest.mark.parametrize("restart_control_plane", [False, True])
def test_a_warm_cutover_loses_zero_steps(
    tmp_path, monkeypatch, restart_control_plane
):
    """With ``restart_control_plane`` the supervisor is killed between
    the launch and the rescale and recovered from its journal: the job
    keeps its weights, its restart count and its warm cutover."""
    code, lines, runner = _run_elastic(
        tmp_path, monkeypatch, restart_control_plane=restart_control_plane
    )
    starts = _check_loss_equal(
        code, lines, runner, [["0", "cold"], ["1", "warm"], ["1", "warm"]]
    )
    assert runner.restarts == 1
    drains = [line for line in lines if line[0] == "drain"]
    assert len(drains) == 1 and int(drains[0][2]) > 0
    for start in starts[1:]:
        assert start[3] == drains[0][2], "steps lost at the cutover"
        spans = start[4].split("|")
        assert "handoff.fetch" in spans and "handoff.restore" in spans
        assert "ckpt.restore" not in spans, "the cutover read storage"
    kinds = [e["event"] for e in runner.events]
    assert kinds == ["launch", "warm_spawn", "warm_ready", "signal", "exit",
                     "launch", "cutover", "exit"], kinds


@pytest.mark.parametrize("case", ["spawn_fault", "killed_while_warming"])
def test_a_failed_warm_up_falls_back_cold_loss_equal(
    tmp_path, monkeypatch, case
):
    code, lines, runner = _run_elastic(
        tmp_path, monkeypatch,
        fault_spec="warmup.spawn=fail@1" if case == "spawn_fault" else None,
        sim_env={"SIM_WARM_SUICIDE": "1"} if case != "spawn_fault" else None,
    )
    _check_loss_equal(
        code, lines, runner, [["0", "cold"], ["1", "cold"], ["1", "cold"]]
    )
    assert "cutover" not in [e["event"] for e in runner.events]


def test_an_incumbent_crash_before_the_cutover_discards_the_warm_successor(
    tmp_path, monkeypatch
):
    code, lines, runner = _run_elastic(
        tmp_path, monkeypatch, sim_env={"SIM_CRASH_ON_TERM": "1"}
    )
    assert [line[0] for line in lines].count("crash") == 1
    _check_loss_equal(
        code, lines, runner, [["0", "cold"], ["1", "cold"], ["1", "cold"]]
    )
    discards = [e["reason"] for e in runner.events
                if e["event"] == "warm_discard"]
    assert discards == ["incumbent crashed before cutover"]


@pytest.mark.parametrize("case", ["mispredicted", "stale_restart_counter"])
def test_a_warm_successor_that_does_not_fit_is_never_adopted(tmp_path, case):
    job = "test/warm-gate"
    runner, _ = _make_runner(tmp_path, job, handoff_on=False)
    inner = runner._runner
    spec = inner.jobs[job]
    runner.supervisor.start()
    try:
        inner._spawn_warm(spec, ALLOC, None)  # no candidate: no speculation
        assert job not in inner._warms
        runner.state.publish_candidate(job, ALLOC, None)
        inner._spawn_warm(spec, ALLOC, None)
        warm = inner._warms[job]
        assert warm.alive()
        if case == "mispredicted":
            inner.restart_counts[job] += 1  # the graceful exit's bump
            adopted = inner._adopt_warm(spec, ["local"], None)
        else:
            # A crash and a cold retry burned the index it was built for.
            inner.restart_counts[job] += 2
            adopted = inner._adopt_warm(spec, ALLOC, None)
        assert adopted is None, "a speculation that does not fit is adopted"
        assert job not in inner._warms
        assert warm.proc.poll() not in (None, 0)
        assert not os.path.exists(warm.workdir)
    finally:
        runner.supervisor.stop()
        runner.state.update(job, status="Failed")
