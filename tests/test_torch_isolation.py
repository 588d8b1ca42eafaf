"""The port stands alone: importing ``adaptdl_tpu_torch`` (every module)
and ``chip_smoke.py``, and running ``initialize_job`` under a supervisor
(a stub that answers every request), loads neither JAX, the JAX package,
``requests`` nor ``aiohttp`` (the card's machine has neither of the
last two); no source imports them, and the entry points refuse to run
anywhere but where they were asked to (CUDA by default)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from tests.torch_support import private_tempdir  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {
    "jax", "jaxlib", "flax", "optax", "orbax", "adaptdl_tpu", "requests",
    "aiohttp",
}


# The control plane's modules (the port's copies of the JAX package's
# sched/*), each of which must import without the JAX package or aiohttp.
SCHED_MODULES = tuple(
    f"adaptdl_tpu_torch.sched.{name}"
    for name in (
        "policy.utils", "policy.nsga2", "policy.speedup", "policy.pollux",
        "validator", "config", "state", "http_server", "supervisor",
        "allocator", "local_runner", "multi_runner", "journal", "warmup",
        "shard", "router",
    )
) + ("adaptdl_tpu_torch.sched.policy",)
# The cluster simulator: like the JAX package's copy, no framework.
SIM_MODULES = tuple(
    f"adaptdl_tpu_torch.sim.{name}"
    for name in ("clock", "events", "workload", "engine")
) + ("adaptdl_tpu_torch.sim",)
# The operator's surface: the watch store, the CLI, the tuner and its
# trial script. Like the JAX package's copies they need no framework:
# the control plane, the CLI and the tuner's scheduler import no torch.
OPERATOR_MODULES = (
    "adaptdl_tpu_torch.watch", "adaptdl_tpu_torch.cli", "adaptdl_tpu_torch.tune",
    "adaptdl_tpu_torch.examples.tune_trial",
)
# Modules of the MoE, chunked-head, loader-option and tutorial paths and
# the control plane, which the walk below must reach.
NEW_MODULES = (
    "adaptdl_tpu_torch.models.moe", "adaptdl_tpu_torch.ops.chunked_xent",
    "adaptdl_tpu_torch.iterator", "adaptdl_tpu_torch.flops",
) + OPERATOR_MODULES + tuple(
    f"adaptdl_tpu_torch.tutorial.mnist_step_{i}" for i in range(1, 6)
) + SCHED_MODULES + SIM_MODULES


def _port_sources():
    return sorted((REPO / "adaptdl_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"
    ]


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, os, pkgutil, sys, time\n"
        "import adaptdl_tpu_torch\n"
        "for m in pkgutil.walk_packages(adaptdl_tpu_torch.__path__, "
        "'adaptdl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for name in " + repr(NEW_MODULES) + ":\n"
        "    assert name in sys.modules, name\n"
        "import chip_smoke\n"
        # A supervisor that answers 200 to everything, in a thread.
        "recorder = chip_smoke.SupervisorRecorder({'ns/job': ['slot-0']})\n"
        "os.environ.update(ADAPTDL_SUPERVISOR_URL=recorder.start(), "
        "ADAPTDL_JOB_ID='ns/job', ADAPTDL_HEARTBEAT_INTERVAL='0.05')\n"
        "from adaptdl_tpu_torch import bootstrap, guard, metrics, sched_hints\n"
        "bootstrap.initialize_job(device='cpu')\n"
        "assert sched_hints.fetch_job_config()['allocation'] == ['slot-0']\n"
        "assert guard.post_incident('nan_loss', step=1)\n"
        "time.sleep(0.2)\n"
        "bootstrap.stop_heartbeat()\n"
        "recorder.stop()\n"
        "assert recorder.seen('ns/job', 'heartbeat')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_control_plane_runs_without_jax_or_aiohttp():
    """A fresh interpreter imports only the control plane, serves a job's
    register and hints and runs one Pollux cycle: none of FORBIDDEN
    loads."""
    code = (
        "import importlib, json, sys, urllib.request\n"
        f"for name in {SCHED_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from adaptdl_tpu_torch.sched.allocator import Allocator\n"
        "from adaptdl_tpu_torch.sched.policy import NodeInfo, PolluxPolicy\n"
        "from adaptdl_tpu_torch.sched.state import ClusterState\n"
        "from adaptdl_tpu_torch.sched.supervisor import Supervisor\n"
        "state = ClusterState()\n"
        "state.create_job('ns/job', {'max_replicas': 2})\n"
        "sup = Supervisor(state)\n"
        "url = sup.start()\n"
        "req = urllib.request.Request(url + '/register/ns/job/0/0', "
        "data=json.dumps({'address': 'h:1'}).encode(), method='PUT')\n"
        "assert json.load(urllib.request.urlopen(req)) == {'ok': True}\n"
        "alloc = Allocator(state, {'local': NodeInfo(resources={'tpu': 2})}, "
        "policy=PolluxPolicy(pop_size=8, generations=2))\n"
        "assert alloc.optimize_once() == {'ns/job': ['local']}\n"
        "sup.stop()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_operator_surface_loads_no_torch():
    """The control plane, the watch store, the CLI and the tuner's scheduler
    import neither torch nor anything in FORBIDDEN, and the supervisor
    serves /watch, /explain and /metrics from them."""
    code = (
        "import importlib, sys, urllib.request\n"
        f"for name in {SCHED_MODULES + OPERATOR_MODULES[:3]!r}:\n"
        "    importlib.import_module(name)\n"
        "from adaptdl_tpu_torch import cli\n"
        "from adaptdl_tpu_torch.sched.allocator import Allocator\n"
        "from adaptdl_tpu_torch.sched.policy import NodeInfo, PolluxPolicy\n"
        "from adaptdl_tpu_torch.sched.state import ClusterState\n"
        "from adaptdl_tpu_torch.sched.supervisor import Supervisor\n"
        "state = ClusterState()\n"
        "state.create_job('ns/job', {'max_replicas': 2})\n"
        "sup = Supervisor(state)\n"
        "url = sup.start()\n"
        "Allocator(state, {'local': NodeInfo(resources={'tpu': 2})}, "
        "policy=PolluxPolicy(pop_size=8, generations=2)).optimize_once()\n"
        "for route in ('/watch', '/explain/ns/job', '/metrics'):\n"
        "    assert urllib.request.urlopen(url + route).status == 200\n"
        "assert cli.main(['top', '--supervisor', url]) == 0\n"
        "sup.stop()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN | {'torch'}!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_simulator_and_the_shards_load_no_torch():
    """The simulator replays a trace through the port's Pollux, and a
    two-shard cluster serves a tenant through the router and migrates it:
    neither torch nor anything in FORBIDDEN loads."""
    code = (
        "import importlib, json, sys, urllib.request\n"
        f"for name in {SIM_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from adaptdl_tpu_torch import sim\n"
        "from adaptdl_tpu_torch.sched.router import Router\n"
        "from adaptdl_tpu_torch.sched.shard import ShardedCluster, migrate_tenant\n"
        "report = sim.run_trace(sim.generate_trace(6, 60.0, seed=1), slices=4)\n"
        "assert report.summary()['completed'] == 6\n"
        "cluster = ShardedCluster(2, lease_ttl=30.0, sweep_interval=3600.0)\n"
        "shard_map = cluster.start()\n"
        "router = Router(shard_map)\n"
        "url = router.start()\n"
        "cluster.create_job('ns/job', {})\n"
        "req = urllib.request.Request(url + '/register/ns/job/0/0', "
        "data=json.dumps({'address': 'h:1'}).encode(), method='PUT')\n"
        "assert json.load(urllib.request.urlopen(req)) == {'ok': True}\n"
        "owner = shard_map.assign('ns/job')\n"
        "flipped = migrate_tenant(shard_map, 'ns', owner, 1 - owner)\n"
        "assert cluster.shards[1 - owner].state.get_job('ns/job') is not None\n"
        "router.stop()\n"
        "cluster.stop()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN | {'torch'}!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_source_imports_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import adaptdl_tpu_torch
    from adaptdl_tpu_torch.examples import transformer_lm
    from adaptdl_tpu_torch.models import TransformerConfig, init_transformer
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        adaptdl_tpu_torch.initialize_job()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer_lm.main(["--epochs", "1"])
    tiny = TransformerConfig(vocab_size=16, num_layers=1, num_heads=1,
                             d_model=8, d_ff=16, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_transformer(tiny)
    model = init_transformer(tiny, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ElasticTrainer(lambda m, b: 0, model, AdamW(model.parameters(), lr=1.0), 4)


@pytest.mark.parametrize(
    "example",
    ["cifar_resnet18", "ncf", "dcgan", "bert_mlm", "linear_regression", "tune_trial"]
    + [f"tutorial.mnist_step_{i}" for i in range(1, 6)],
)
def test_zoo_examples_refuse_to_run_without_cuda(monkeypatch, example):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("ADAPTDL_NUM_REPLICAS", "1")
    package = "adaptdl_tpu_torch" if "." in example else "adaptdl_tpu_torch.examples"
    module = importlib.import_module(f"{package}.{example}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--epochs", "1"])


def test_zoo_models_default_to_cuda(monkeypatch):
    from adaptdl_tpu_torch import models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
        lambda: models.init_resnet18(width=8),
        lambda: models.init_cnn(),
        lambda: models.init_ncf(4, 4),
        lambda: models.init_dcgan(base_features=8),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_unported_job_settings_raise(monkeypatch):
    import adaptdl_tpu_torch
    from adaptdl_tpu_torch.examples import transformer_lm

    # A supervisor is no longer among them: with no job id there is
    # nothing to register or beat for, and the job starts.
    monkeypatch.setenv("ADAPTDL_SUPERVISOR_URL", "http://localhost:1")
    monkeypatch.delenv("ADAPTDL_JOB_ID", raising=False)
    assert adaptdl_tpu_torch.initialize_job(device="cpu") == torch.device("cpu")
    monkeypatch.delenv("ADAPTDL_SUPERVISOR_URL")
    monkeypatch.setenv("ADAPTDL_NUM_REPLICAS", "2")
    with pytest.raises(NotImplementedError, match="multi-replica"):
        adaptdl_tpu_torch.initialize_job(device="cpu")
    with pytest.raises(ValueError, match="--seq-shards 2 runs one process per chip"):
        transformer_lm.main(["--cpu", "--seq-shards", "2"])
