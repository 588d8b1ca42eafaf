"""The port's local elastic runner, end to end on the CPU.

``LocalElasticRunner`` hosts the port's supervisor and allocator over
one node of two slots and runs the port's linear-regression example
(``--cpu``, a step budget) through ``python -m adaptdl_tpu_torch.
launch``. Spec edits, as an operator edits a job's bounds (each edited
spec passes ``validate_job_spec``), drive it 1 -> 2 -> 1 replicas; the
allocator publishes each allocation and the runner carries it out with
SIGTERM, exit 143 and a relaunch. The test checks:

- the job ends ``Succeeded`` with exit code 0 and posted hints;
- every launch's replica count equals the allocation the allocator
  published last before it, and the counts run 1, 2, 1;
- each incarnation resumes at the step its predecessor saved (its
  report's ``start_step`` is the previous one's ``end_step``), with
  finite losses, and both ranks of the two-rank incarnation end with
  equal parameters;
- an injected ``runner.launch.pre`` fault spends the retry budget: one
  failed launch is retried and the job succeeds; failing every launch
  exhausts the budget and ends ``Failed``.

Every test ends itself within its stated wall time: a watchdog kills the
runner's incarnation and fails the test.
"""

import glob
import json
import os
import threading
import time

import pytest

from adaptdl_tpu_torch import faults
from adaptdl_tpu_torch.sched import local_runner, multi_runner
from adaptdl_tpu_torch.sched.local_runner import LocalElasticRunner
from adaptdl_tpu_torch.sched.validator import validate_job_spec
from tests.torch_support import private_tempdir  # noqa: F401

JOB = "test/elastic-port"
SCRIPT = "adaptdl_tpu_torch/examples/linear_regression.py"
RESCALE_WALL_S = 240.0
FAULT_WALL_S = 120.0
JOB_ENV = {
    "ADAPTDL_FIT_INTERVAL": "1",
    "ADAPTDL_HEARTBEAT_INTERVAL": "1",
    "OMP_NUM_THREADS": "1",
}


class Watchdog:
    """Kills the runner's live incarnation once ``seconds`` pass."""

    def __init__(self, runner, seconds):
        self.fired = False
        self._runner = runner
        self._timer = threading.Timer(seconds, self._fire)
        self._timer.daemon = True

    def _fire(self):
        self.fired = True
        self._runner.state.update(self._runner.job_name, status="Failed")
        proc = self._runner.proc
        if proc is not None and proc.poll() is None:
            multi_runner.kill_incarnation(proc)

    def __enter__(self):
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()
        self._timer.join()


def _edit_spec(runner, **bounds):
    record = runner.state.get_job(runner.job_name)
    spec = dict(record.spec, **bounds)
    validate_job_spec(spec)
    runner.state.update(runner.job_name, spec=spec)


def _wait(predicate, deadline, what):
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


@pytest.fixture(autouse=True)
def _no_fault_schedule():
    faults.reset()
    yield
    faults.reset()


def test_runner_rescales_the_port_job_1_2_1(tmp_path):
    reports = tmp_path / "reports"
    runner = LocalElasticRunner(
        SCRIPT, num_chips=2, checkpoint_dir=str(tmp_path / "ckpt"),
        job_name=JOB, max_replicas=1, allocator_interval=0.3,
        extra_env=JOB_ENV, term_grace_period=60.0,
        script_args=["--cpu", "--epochs", "100000", "--steps", "1500",
                     "--report-dir", str(reports)],
    )
    errors = []

    def drive():
        deadline = time.monotonic() + RESCALE_WALL_S
        try:
            _wait(lambda: runner.state.get_job(JOB).hints, deadline,
                  "the first incarnation's hints")
            _edit_spec(runner, min_replicas=2, max_replicas=2)
            # The two-rank incarnation's own hints profile two replicas.
            _wait(lambda: (runner.state.get_job(JOB).hints or {}).get(
                "maxProfiledReplicas", 0) >= 2, deadline,
                "the two-rank incarnation's hints")
            _edit_spec(runner, min_replicas=1, max_replicas=1)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    editor = threading.Thread(target=drive, daemon=True)
    with Watchdog(runner, RESCALE_WALL_S) as dog:
        editor.start()
        code = runner.run()
        editor.join(timeout=10)
    assert not dog.fired, f"runner exceeded {RESCALE_WALL_S} s"
    assert not errors, errors
    record = runner.state.get_job(JOB)
    assert code == 0 and record.status == "Succeeded"
    assert record.hints is not None
    launches = [e for e in runner.events if e["event"] == "launch"]
    assert [e["replicas"] for e in launches] == [1, 2, 1]
    assert [e["restarts"] for e in launches] == [0, 1, 2]
    exits = [e["code"] for e in runner.events if e["event"] == "exit"]
    assert exits == [143, 143, 0]
    # Each launch carries out the allocation the allocator published.
    for launch in launches:
        published = [
            alloc for at, key, alloc in runner.allocator.published
            if key == JOB and at <= launch["time"]
        ]
        assert published and published[-1] == launch["allocation"]
    # Each incarnation resumes where its predecessor saved.
    by_restart = {}
    for path in glob.glob(str(reports / "report-*.json")):
        with open(path) as f:
            report = json.load(f)
        by_restart.setdefault(report["restarts"], []).append(report)
    assert sorted(by_restart) == [0, 1, 2]
    assert [len(by_restart[k]) for k in range(3)] == [1, 2, 1]
    end = 0
    for restarts in range(3):
        ranks = by_restart[restarts]
        assert all(r["start_step"] == end for r in ranks), (restarts, end)
        assert all(r["losses_finite"] and r["losses"] for r in ranks)
        assert len({r["params_sha256"] for r in ranks}) == 1
        assert len({r["end_step"] for r in ranks}) == 1
        end = ranks[0]["end_step"]
    assert end == 1500


@pytest.mark.parametrize("spec,status,code,launches", [
    ("runner.launch.pre=fail@1", "Succeeded", 0, 2),
    ("runner.launch.pre=fail@1+", "Failed", 1, 2),
])
def test_launch_faults_spend_the_retry_budget(
    tmp_path, spec, status, code, launches
):
    runner = LocalElasticRunner(
        SCRIPT, num_chips=2, checkpoint_dir=str(tmp_path / "ckpt"),
        job_name=JOB, max_replicas=1, allocator_interval=0.3,
        max_failures=1, extra_env=JOB_ENV,
        script_args=["--cpu", "--steps", "20"],
    )
    faults.configure(spec)
    with Watchdog(runner, FAULT_WALL_S) as dog:
        got = runner.run()
    assert not dog.fired, f"runner exceeded {FAULT_WALL_S} s"
    assert got == code
    assert runner.state.get_job(JOB).status == status
    assert runner.failures == 1 + (status == "Failed")
    assert faults.hit_count("runner.launch.pre") == launches
    assert len([e for e in runner.events if e["event"] == "launch"]) == launches


def test_main_parses_the_script_arguments(monkeypatch, tmp_path):
    seen = {}

    class Fake:
        def __init__(self, script, **kw):
            seen.update(kw, script=script)

        def run(self):
            return 0

    monkeypatch.setattr(local_runner, "LocalElasticRunner", Fake)
    assert local_runner.main([
        SCRIPT, "--chips", "2", "--checkpoint-dir", str(tmp_path),
        "--", "--cpu", "--steps", "3",
    ]) == 0
    assert seen["num_chips"] == 2 and seen["script"] == SCRIPT
    assert seen["script_args"] == ["--cpu", "--steps", "3"]
    env = multi_runner.job_environment(
        {"PYTHONPATH": "/x"}, JOB, "/ckpt", 2, None, 3, "http://s:1"
    )
    assert env["ADAPTDL_NUM_REPLICAS"] == env["ADAPTDL_NUM_PROCESSES"] == "2"
    assert env["ADAPTDL_NUM_RESTARTS"] == "3"
    assert "ADAPTDL_REPLICA_RANK" not in env
    assert env["PYTHONPATH"].split(os.pathsep)[1] == "/x"
    assert multi_runner.launch_command(SCRIPT, ["--cpu"])[1:] == [
        "-m", "adaptdl_tpu_torch.launch", SCRIPT, "--cpu",
    ]


@pytest.mark.parametrize("environ,interval,failures", [
    ({}, 5.0, 2),
    ({"ADAPTDL_ALLOCATOR_INTERVAL": "0.5", "ADAPTDL_MAX_FAILURES": "4"},
     0.5, 4),
])
def test_the_runner_takes_its_defaults_from_the_environment(
    monkeypatch, tmp_path, environ, interval, failures
):
    """Unset, the allocator cycles every 5 s and two failures are
    forgiven; ``ADAPTDL_ALLOCATOR_INTERVAL`` and ``ADAPTDL_MAX_FAILURES``
    override both, and an explicit argument overrides the environment."""
    for name in ("ADAPTDL_ALLOCATOR_INTERVAL", "ADAPTDL_MAX_FAILURES"):
        monkeypatch.delenv(name, raising=False)
    for name, value in environ.items():
        monkeypatch.setenv(name, value)
    runner = LocalElasticRunner(SCRIPT, num_chips=2,
                                checkpoint_dir=str(tmp_path))
    assert runner.allocator._interval == interval
    assert runner._runner.max_failures == failures
    runner = LocalElasticRunner(SCRIPT, num_chips=2,
                                checkpoint_dir=str(tmp_path),
                                allocator_interval=9.0, max_failures=0)
    assert runner.allocator._interval == 9.0
    assert runner._runner.max_failures == 0
