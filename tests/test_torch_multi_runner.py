"""The port's multi-job runner: two port jobs co-scheduled on the CPU.

``MultiJobRunner`` hosts one supervisor and one allocator over a node of
two slots and runs two linear-regression jobs of the port (``--cpu``,
step budgets). Each job's spec asks for at least one slot, so the
allocator gives each one while both run. Both end ``Succeeded`` with
exit code 0, both posted hints, every launch carries out an allocation
the allocator published, and each job's last loss is near the noise
floor of its data (0.1² = 0.01 per sample). A second test submits a
job while another holds both slots, so that Pollux must shrink the
running job to place it. Each test ends itself within its stated wall
time: a watchdog stops every job's incarnations and fails it.
"""

import glob
import json
import threading
import time

from adaptdl_tpu_torch.sched import multi_runner
from adaptdl_tpu_torch.sched.multi_runner import JobSpec, MultiJobRunner
from tests.torch_support import private_tempdir  # noqa: F401

SCRIPT = "adaptdl_tpu_torch/examples/linear_regression.py"
WALL_S = 240.0
JOB_ENV = {
    "ADAPTDL_FIT_INTERVAL": "1",
    "ADAPTDL_HEARTBEAT_INTERVAL": "1",
    "OMP_NUM_THREADS": "1",
}


def test_two_port_jobs_share_the_node(tmp_path):
    jobs = [
        JobSpec(
            name=f"test/mj-{i}", script=SCRIPT,
            checkpoint_dir=str(tmp_path / f"ckpt{i}"),
            min_replicas=1, max_replicas=2, extra_env=JOB_ENV,
            script_args=["--cpu", "--epochs", "100000", "--steps", str(steps),
                         "--report-dir", str(tmp_path / f"rep{i}")],
        )
        for i, steps in enumerate((300, 400))
    ]
    runner = MultiJobRunner(jobs, num_chips=2, allocator_interval=0.3)
    fired = []

    def stop_all():
        fired.append(True)
        for job in jobs:
            runner.state.update(job.name, status="Failed")
            proc = runner.procs.get(job.name)
            if proc is not None and proc.poll() is None:
                multi_runner.kill_incarnation(proc)

    # Both jobs hold a slot at the same instant at least once.
    overlap = []

    def watch():
        while not fired and len(runner.exit_codes) < 2:
            allocs = [runner.state.get_allocation(j.name) for j in jobs]
            running = [runner.state.get_job(j.name).status for j in jobs]
            if all(allocs) and running == ["Running", "Running"]:
                overlap.append([len(a) for a in allocs])
                return
            time.sleep(0.05)

    timer = threading.Timer(WALL_S, stop_all)
    timer.daemon = True
    watcher = threading.Thread(target=watch, daemon=True)
    timer.start()
    watcher.start()
    try:
        codes = runner.run()
    finally:
        timer.cancel()
        timer.join()
    watcher.join(timeout=10)
    assert not fired, f"runner exceeded {WALL_S} s"
    assert codes == {job.name: 0 for job in jobs}
    assert overlap and all(n >= 1 for n in overlap[0]), overlap
    for i, job in enumerate(jobs):
        record = runner.state.get_job(job.name)
        assert record.status == "Succeeded"
        assert record.hints is not None and record.hints["initBatchSize"] == 32
        for launch in (e for e in runner.events[job.name]
                       if e["event"] == "launch"):
            published = [a for at, key, a in runner.allocator.published
                         if key == job.name and at <= launch["time"]]
            assert published and published[-1] == launch["allocation"]
        reports = [json.load(open(p))
                   for p in glob.glob(str(tmp_path / f"rep{i}" / "*.json"))]
        assert max(r["end_step"] for r in reports) == (300, 400)[i]
        assert all(r["losses_finite"] for r in reports)
        last = max(reports, key=lambda r: r["end_step"])
        assert last["losses"][-1] < 0.05, last["losses"][-5:]


def _published_at(published, job, when):
    return [a for at, key, a in published if key == job and at <= when]


def test_a_late_job_makes_pollux_shrink_the_running_one(tmp_path):
    """Co-scheduling forces a decision: job A holds both slots (min =
    max = 2); once it has posted hints, job B (min = max = 1) is
    submitted and A's bounds relaxed to 1..2 in one step. Pollux must
    shrink A to place B: A is SIGTERMed, exits 143 and is relaunched at
    one replica in the same cycle that gives B its slot, and both end
    ``Succeeded``."""
    def spec(i, lo, hi, steps):
        return JobSpec(
            name=f"test/late-{i}", script=SCRIPT,
            checkpoint_dir=str(tmp_path / f"ckpt{i}"),
            min_replicas=lo, max_replicas=hi, extra_env=JOB_ENV,
            script_args=["--cpu", "--epochs", "100000", "--steps", str(steps),
                         "--report-dir", str(tmp_path / f"rep{i}")],
        )

    first, late = spec(0, 2, 2, 1500), spec(1, 1, 1, 100)
    runner = MultiJobRunner([first], num_chips=2, allocator_interval=0.3)
    fired, errors = [], []

    def stop_all():
        fired.append(True)
        for name in list(runner.jobs):
            runner.state.update(name, status="Failed")
            proc = runner.procs.get(name)
            if proc is not None and proc.poll() is None:
                multi_runner.kill_incarnation(proc)

    def drive():
        deadline = time.monotonic() + WALL_S
        try:
            while runner.state.get_job(first.name).hints is None:
                assert time.monotonic() < deadline and not fired
                time.sleep(0.05)
            assert runner.state.get_job(first.name).status == "Running"
            # One step for the allocator: no cycle sees one change
            # without the other.
            with runner.state._cond:
                runner.submit(late)
                record = runner.state.get_job(first.name)
                runner.state.update(
                    first.name, spec=dict(record.spec, min_replicas=1))
        except Exception as exc:  # noqa: BLE001 - checked below
            errors.append(exc)

    timer = threading.Timer(WALL_S, stop_all)
    timer.daemon = True
    driver = threading.Thread(target=drive, daemon=True)
    timer.start()
    driver.start()
    try:
        codes = runner.run()
    finally:
        timer.cancel()
        timer.join()
    driver.join(timeout=10)
    assert not fired, f"runner exceeded {WALL_S} s"
    assert not errors, errors
    assert codes == {first.name: 0, late.name: 0}
    published = runner.allocator.published
    events = {name: runner.events[name] for name in (first.name, late.name)}
    # A may grow back once B has ended; its first two launches are fixed.
    for name, expected in ((first.name, [2, 1]), (late.name, [1])):
        launches = [e for e in events[name] if e["event"] == "launch"]
        counts = [e["replicas"] for e in launches]
        assert counts[:len(expected)] == expected, (name, counts)
        for launch in launches:
            assert _published_at(published, name, launch["time"])[-1] == \
                launch["allocation"]
        assert runner.state.get_job(name).status == "Succeeded"
    exits = [e["code"] for e in events[first.name] if e["event"] == "exit"]
    assert exits == [143] * (len(exits) - 1) + [0] and len(exits) >= 2
    # The cause: the cycle that placed B is the one that shrank A.
    cycles = list(runner.allocator.cycles)
    placed = next(i for i, c in enumerate(cycles)
                  if c["allocations"].get(late.name))
    assert cycles[placed]["allocations"] == {
        first.name: ["local"], late.name: ["local"]}
    assert cycles[placed - 1]["allocations"][first.name] == ["local"] * 2
    reports = [json.load(open(p))
               for p in glob.glob(str(tmp_path / "rep0" / "*.json"))]
    assert max(r["end_step"] for r in reports) == 1500
    saved = {r["restarts"]: r["end_step"] for r in reports}
    for r in reports:
        assert r["start_step"] == saved.get(r["restarts"] - 1, 0)


def test_a_stopped_job_is_never_launched(tmp_path):
    """``stop_job`` turns the job terminal at once: its supervising loop
    launches nothing and records exit code 143, and the allocator never
    grants it a slot again."""
    job = JobSpec(name="test/stopped", script=SCRIPT,
                  checkpoint_dir=str(tmp_path / "ckpt"))
    runner = MultiJobRunner([job], num_chips=2)
    runner.stop_job(job.name)
    runner._run_job(job)
    assert runner.exit_codes == {job.name: 143}
    assert runner.events[job.name] == []
    record = runner.state.get_job(job.name)
    assert record.status == "Stopped" and record.allocation == []
    assert runner.allocator.optimize_once() == {}
