"""The port's cluster simulator (``adaptdl_tpu_torch.sim``) against the JAX
package's: the same trace records, job populations, event order and, run
through each package's own Pollux, allocator and cluster state, the same
deterministic summary and watch summary, byte for byte.

Each comparison runs each package once. The 1k-job replay at the simgate's
settings is ``slow``-marked (about 75 s per package on one CPU core).
"""

from __future__ import annotations

import json
import os
import random

import pytest

from adaptdl_tpu import sim as jax_sim
from adaptdl_tpu.sim import events as jax_events
from adaptdl_tpu.sim import workload as jax_workload
from adaptdl_tpu_torch import sim as port_sim
from adaptdl_tpu_torch.sim import events as port_events
from adaptdl_tpu_torch.sim import workload as port_workload
from tests.torch_support import private_tempdir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "traces", "smoke-32.jsonl")
POLLUX_1K = os.path.join(REPO, "traces", "pollux-1k.jsonl")
SMOKE_ARGS = dict(slices=8, seed=3, interval=30.0)


def _spec_json(spec) -> str:
    payload = dict(vars(spec))
    payload["perf"] = spec.perf._asdict()
    payload["grad"] = spec.grad._asdict()
    return json.dumps(payload, sort_keys=True, default=list)


# ---- workload --------------------------------------------------------


@pytest.mark.parametrize(
    "num_jobs,duration,seed",
    [(200, 1000.0, 11), (64, 500.0, 9), (24, 300.0, 5), (1, 10.0, 0)],
)
def test_generate_trace_equals_the_jax_trace(num_jobs, duration, seed):
    port = port_sim.generate_trace(num_jobs, duration, seed=seed)
    assert port == jax_sim.generate_trace(num_jobs, duration, seed=seed)
    mix = {"small": 0.1, "mega": 0.9}
    assert port_sim.generate_trace(
        num_jobs, duration, seed=seed, mix=mix
    ) == jax_sim.generate_trace(num_jobs, duration, seed=seed, mix=mix)


def test_trace_files_are_interchangeable(tmp_path):
    records = port_sim.generate_trace(20, 100.0, seed=3)
    port_path = str(tmp_path / "port.jsonl")
    jax_path = str(tmp_path / "jax.jsonl")
    port_sim.write_trace(port_path, records)
    jax_sim.write_trace(jax_path, records)
    with open(port_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    assert port_sim.load_trace(jax_path) == jax_sim.load_trace(port_path)
    assert port_sim.load_trace(SMOKE) == jax_sim.load_trace(SMOKE)


@pytest.mark.parametrize("dp_only", [False, True])
def test_resolve_job_and_hints_equal_on_the_smoke_trace(dp_only):
    records = port_sim.load_trace(SMOKE)
    assert len(records) == 32
    for record in records:
        port_spec = port_sim.resolve_job(record)
        jax_spec = jax_sim.resolve_job(record)
        assert _spec_json(port_spec) == _spec_json(jax_spec)
        for profiled in (1, 4):
            assert json.dumps(
                port_workload.hints_payload(port_spec, profiled, dp_only),
                sort_keys=True,
            ) == json.dumps(
                jax_workload.hints_payload(jax_spec, profiled, dp_only),
                sort_keys=True,
            )


def test_percentile_equals():
    rng = random.Random(7)
    values = [rng.uniform(0, 100) for _ in range(101)]
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert port_workload.percentile(values, q) == (
            jax_workload.percentile(values, q)
        )
    assert port_workload.percentile([], 0.5) == 0.0


# ---- clock and events ------------------------------------------------


def test_event_queue_pops_a_seeded_same_time_mix_in_the_jax_order():
    rng = random.Random(1234)
    kinds = ("arrive", "hints", "alloc", "finish", "preempt", "slot_return")
    pushes = [
        (float(rng.choice((0.0, 1.0, 2.5, 2.5, 7.0))), rng.choice(kinds), i)
        for i in range(200)
    ]
    orders = []
    for events in (port_events, jax_events):
        queue = events.EventQueue()
        for t, kind, i in pushes:
            queue.push(events.Event(t, kind, {"i": i}))
        orders.append(
            [(e.time, e.kind, e.payload["i"])
             for e in (queue.pop() for _ in range(len(queue)))]
        )
    assert orders[0] == orders[1]
    # Same-time events pop in push order.
    assert orders[0] == sorted(orders[0], key=lambda e: (e[0], e[2]))


def test_virtual_clock_equals():
    port, ref = port_sim.VirtualClock(), jax_sim.VirtualClock()
    for t in (0.0, 3.5, 3.5, 1e6):
        port.advance_to(t)
        ref.advance_to(t)
        assert (port.monotonic(), port.time(), port.now()) == (
            ref.monotonic(), ref.time(), ref.now()
        )
    with pytest.raises(ValueError):
        port.advance_to(1.0)


# ---- the simulator ---------------------------------------------------


ARMS = {
    "smoke": (lambda: port_sim.load_trace(SMOKE), SMOKE_ARGS),
    "generated": (
        lambda: port_sim.generate_trace(24, 300.0, seed=5),
        dict(slices=8, chips_per_slice=8, seed=2, interval=30.0),
    ),
    "fixed": (lambda: port_sim.load_trace(SMOKE), dict(SMOKE_ARGS, fixed=True)),
    "dp_only": (
        lambda: port_sim.load_trace(SMOKE), dict(SMOKE_ARGS, dp_only=True)
    ),
    "preemption": (
        lambda: port_sim.load_trace(SMOKE),
        dict(SMOKE_ARGS, spot_fraction=0.5, reclaims_per_slot_hour=30.0),
    ),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_summary_and_watch_summary_equal_the_jax_sim(arm):
    make, kwargs = ARMS[arm]
    records = make()
    port = port_sim.ClusterSim(records, **kwargs)
    port_report = port.run()
    jax_report = jax_sim.run_trace(records, **kwargs)
    assert port_report.summary_json() == jax_report.summary_json()
    assert port_report.watch_summary_json() == jax_report.watch_summary_json()
    summary = port_report.summary()
    assert summary["completed"] == summary["jobs"] == len(records)
    if arm == "preemption":
        # The notices went through the real hazard machinery.
        assert summary["preempt_notices"] > 0
        rates = port.state.hazard_rates(now=port.clock.time())
        assert rates.get("spot", 0.0) > 0.0
    if arm == "dp_only":
        assert summary["mesh_shaped_jobs"] == 0
    if arm == "smoke":
        assert summary["mesh_shaped_jobs"] >= 1


def test_port_summary_is_bit_identical_across_runs():
    records = port_sim.generate_trace(24, 300.0, seed=5)
    kwargs = dict(
        slices=8, chips_per_slice=8, seed=2, interval=30.0,
        spot_fraction=0.5, reclaims_per_slot_hour=30.0,
        reclaim_outage_s=120.0,
    )
    first = port_sim.run_trace(records, **kwargs)
    second = port_sim.run_trace(records, **kwargs)
    assert first.summary_json() == second.summary_json()
    assert first.watch_summary_json() == second.watch_summary_json()
    latency = first.latency()
    assert latency["alloc_decisions"] > 0
    assert "makespan_s" in first.render()


@pytest.mark.slow
def test_the_1k_replay_equals_the_jax_sim():
    """The simgate's trace and settings (1,250 slices x 8 chips, seed 42,
    interval 60), adaptive and fixed, summary for summary."""
    records = port_sim.load_trace(POLLUX_1K)
    assert len(records) == 1000
    gate = dict(slices=1250, chips_per_slice=8, seed=42, interval=60.0)
    for fixed in (False, True):
        port = port_sim.run_trace(records, fixed=fixed, **gate)
        ref = jax_sim.run_trace(records, fixed=fixed, **gate)
        assert port.summary_json() == ref.summary_json()
        assert port.watch_summary_json() == ref.watch_summary_json()
        assert port.summary()["completed"] == 1000


# ---- the CLI verb ----------------------------------------------------


def _deterministic_lines(text: str) -> list[str]:
    """The verb's stdout without its wall-clock latency lines."""
    return [
        line for line in text.splitlines()
        if not line.startswith(("  alloc_", "  sim_wall_s"))
    ]


@pytest.mark.parametrize("compare", ["--compare-fixed", "--compare-dp-only"])
def test_sim_verb_prints_the_jax_verb_output(compare, capsys, tmp_path):
    from adaptdl_tpu import cli as jax_cli
    from adaptdl_tpu_torch import cli as port_cli

    args = ["sim", SMOKE, "--slices", "8", "--seed", "3", "--interval", "30",
            compare]
    outputs = []
    for cli, name in ((port_cli, "port"), (jax_cli, "jax")):
        report = str(tmp_path / f"{name}.json")
        assert cli.main(args + ["--json", report]) == 0
        outputs.append(capsys.readouterr().out)
        with open(report) as f:
            payload = json.load(f)
        payload.pop("latency")
        outputs.append(json.dumps(payload, sort_keys=True))
    port_out, port_json, jax_out, jax_json = outputs
    assert _deterministic_lines(port_out) == _deterministic_lines(jax_out)
    assert port_json == jax_json
    key = (
        "goodput_retention_vs_fixed" if compare == "--compare-fixed"
        else "goodput_retention_vs_dp_only"
    )
    assert json.loads(port_json)[key] >= 1.0


def test_sim_verb_generates_the_jax_trace(capsys, tmp_path):
    from adaptdl_tpu import cli as jax_cli
    from adaptdl_tpu_torch import cli as port_cli

    paths = []
    for cli, name in ((port_cli, "port"), (jax_cli, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        assert cli.main(["sim", "--generate", "64", "--duration", "500",
                         "--seed", "9", "-o", path]) == 0
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert port_cli.main(["sim", "--generate", "3", "--duration", "10"]) == 0
    port_out = capsys.readouterr().out
    assert jax_cli.main(["sim", "--generate", "3", "--duration", "10"]) == 0
    assert port_out == capsys.readouterr().out
    assert port_cli.main(["sim"]) == 2
