"""The port's elastic tuner (``adaptdl_tpu_torch.tune``) against the JAX
package's.

- ``sample_configs`` gives the same configs for the same space, count and
  seed in both packages.
- The halving rule stops the same trials, promotes the survivors through
  the same rung gates and ungates a lone survivor, on the same reported
  results in both packages (the runners' ``stop_job`` stubbed).
- A crashed trial leaves the halving pool.
- Three trials of the committed linear-regression trial script
  (``examples/tune_trial.py``, on the CPU) run elastically through the
  port's ``MultiJobRunner`` on four slots: the hopeless ``lr`` 1e-6 is
  stopped at a rung (exit 143 after a checkpoint) and the best trial is
  one of the two good ones, ``DONE`` with its loss under 0.1 (the bounds
  of ``tests/test_tune.py``'s elastic run).
"""

import json
import os
from pathlib import Path

import pytest

from adaptdl_tpu import tune as jax_tune
from adaptdl_tpu_torch import tune
from tests.torch_support import private_tempdir  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "space, samples, seed",
    [
        ({"lr": [0.1, 0.01], "wd": [0, 1]}, None, 0),
        ({"lr": [0.1, 0.01], "wd": [0, 1]}, 2, 1),
        ({"b": [1, 2, 3], "a": ["x", "y"], "c": [0.5]}, 4, 7),
        ({"lr": [0.05, 0.02, 1e-6]}, 10, 3),
    ],
)
def test_sample_configs_match_jax(space, samples, seed):
    got = tune.sample_configs(space, samples, seed=seed)
    assert got == jax_tune.sample_configs(space, samples, seed=seed)
    grid = tune.sample_configs(space, None)
    assert all(c in grid for c in got)


def _schedulers(tmp_path, **kwargs):
    """A JAX and a port scheduler over the same space, each with a stub
    ``stop_job`` that records what it stops."""
    out = []
    for name, module in (("jax", jax_tune), ("port", tune)):
        sched = module.TrialScheduler(
            "unused.py", {"lr": [0.1, 0.01, 0.001, 0.0001]}, num_chips=2,
            metric="loss", mode="min", checkpoint_root=str(tmp_path / name),
            **kwargs,
        )
        stopped = []
        sched.runner.stop_job = stopped.append
        out.append((sched, stopped))
    return out


def _post(sched, key, *losses):
    with open(sched.trials[key].result_file, "a") as f:
        f.writelines(json.dumps({"loss": loss}) + "\n" for loss in losses)


def _gates(sched):
    gates = {}
    for key, trial in sched.trials.items():
        path = trial.result_file + ".gate"
        gates[key] = Path(path).read_text() if os.path.exists(path) else None
    return gates


def _view(sched, stopped):
    return (
        list(stopped), {k: t.status for k, t in sched.trials.items()},
        _gates(sched), sched._next_rung,
    )


def test_halving_matches_jax(tmp_path):
    sides = _schedulers(tmp_path, grace_results=2, reduction_factor=2)
    rounds = [
        # Rung 2 incomplete (trial-0 one short): no decision.
        {"tune/trial-0": [1.0], "tune/trial-1": [0.9, 0.8],
         "tune/trial-2": [0.7, 0.6], "tune/trial-3": [0.95, 0.9]},
        # Rung complete: the two worst stop, the rest move to rung 4.
        {"tune/trial-0": [1.0]},
        # The survivors fill rung 4: the worse one stops.
        {"tune/trial-1": [0.5, 0.4], "tune/trial-2": [0.3, 0.35]},
    ]
    for step, posts in enumerate(rounds):
        views = []
        for sched, stopped in sides:
            for key, losses in posts.items():
                _post(sched, key, *losses)
            sched._refresh_results()
            sched._maybe_halve()
            views.append(_view(sched, stopped))
        assert views[1] == views[0], step
    stopped, statuses, gates, rung = views[1]
    assert stopped == ["tune/trial-3", "tune/trial-0", "tune/trial-1"]
    assert statuses["tune/trial-2"] == "RUNNING" and rung == 8
    # A lone survivor that fills its rung is ungated.
    for sched, stopped in sides:
        _post(sched, "tune/trial-2", 0.3, 0.2, 0.1, 0.05)
        sched._refresh_results()
        sched._maybe_halve()
    assert _gates(sides[0][0]) == _gates(sides[1][0])
    assert _gates(sides[1][0])["tune/trial-2"] is None


def test_crashed_trial_leaves_the_halving_pool(tmp_path):
    sched = tune.TrialScheduler(
        "unused.py", {"lr": [0.1, 0.01, 0.001]}, num_chips=2, metric="loss",
        mode="min", grace_results=1, checkpoint_root=str(tmp_path),
    )
    stopped = []
    sched.runner.stop_job = stopped.append
    sched.runner.state.update("tune/trial-2", status="Failed")
    for key, loss in (("tune/trial-0", 1.0), ("tune/trial-1", 0.1)):
        _post(sched, key, loss)
    sched._refresh_results()
    assert sched.trials["tune/trial-2"].status == "FAILED"
    sched._maybe_halve()
    assert stopped == ["tune/trial-0"]


def test_report_waits_at_its_rung_gate(tmp_path, monkeypatch):
    """``report`` appends a row and returns at once without a gate;
    with one it returns below the gate's count, and waits at it until
    the exit flag rises."""
    from adaptdl_tpu_torch import _signal

    results = tmp_path / "r.jsonl"
    monkeypatch.setenv("ADAPTDL_TRIAL_RESULT_FILE", str(results))
    monkeypatch.setenv("ADAPTDL_TRIAL_CONFIG", json.dumps({"lr": 0.5}))
    assert tune.get_trial_config() == {"lr": 0.5}
    tune.report(loss=1.0)
    Path(str(results) + ".gate").write_text("3")
    tune.report(loss=0.5)
    _signal.set_exit_flag(True)
    try:
        tune.report(loss=0.25)  # at the gate: returns on the flag
    finally:
        _signal.set_exit_flag(False)
    rows = [json.loads(line) for line in results.read_text().splitlines()]
    assert rows == [{"loss": 1.0}, {"loss": 0.5}, {"loss": 0.25}]
    monkeypatch.delenv("ADAPTDL_TRIAL_CONFIG")
    assert tune.get_trial_config() == {}


def test_three_trials_elastic_with_early_stop(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("ADAPTDL_FIT_INTERVAL", "2")
    script = tmp_path / "trial.py"
    script.write_text(
        "from adaptdl_tpu_torch.examples import tune_trial\n"
        "tune_trial.main(['--cpu'])\n"
    )
    sched = tune.TrialScheduler(
        str(script), {"lr": [0.05, 0.02, 1e-6]}, num_chips=4, metric="loss",
        mode="min", grace_results=2, reduction_factor=2,
        checkpoint_root=str(tmp_path / "tune"),
        runner_kwargs={"allocator_interval": 2.0, "pop_size": 8, "generations": 4},
        poll_interval=0.25,
    )
    best = sched.run()
    assert sched.stopped_trials, "early stopping never fired"
    stopped_cfgs = [sched.trials[k].config["lr"] for k in sched.stopped_trials]
    assert 1e-6 in stopped_cfgs, stopped_cfgs
    assert best.config["lr"] in (0.05, 0.02)
    assert best.status == "DONE"
    assert best.last("loss") < 0.1
    stopped_key = sched.stopped_trials[0]
    assert sched.trials[stopped_key].status == "STOPPED"
    # The stopped trial checkpointed on its way out (graceful 143).
    assert sched.runner.exit_codes[stopped_key] == 143
    exits = [e["code"] for e in sched.runner.events[stopped_key] if e["event"] == "exit"]
    assert exits and exits[-1] == 143
    ckpt_dir = tmp_path / "tune" / stopped_key.split("/")[1]
    assert any(p.name.startswith("checkpoint-") for p in ckpt_dir.iterdir())
