"""The port's save pipeline: a snapshot at the step boundary, the write on
a thread, against the JAX package's ``save_all_states(wait=False)``.

- An async save's directory holds the same bytes as a blocking save's,
  for the trainer's state (the 2-layer LM of tests/torch_rescale_worker.py,
  random weights from a seed) and for a byte state, and the two packages
  write the byte state's payload identically.
- The loader's periodic save blocks for the snapshot alone: with the
  write held on a gate, the loop takes its next step.
- A load while a write is in flight sees the new save, in both packages.
- A GOOD marker lands only on a completed write, never during it, and an
  unhealthy observation during the write keeps it unmarked.
- The guard's rollback restores the newest good dir while a write is
  still in flight, without waiting for it, and that write's prune keeps
  the good dir.
- The interpreter's exit joins a write in flight, in both packages.
- ``restartStats`` carries the measured ``writeS`` (nonzero) beside
  ``snapshotS``, as the JAX package's does.
- The trainer's snapshot reuses its host buffers across saves, and its
  handoff chunks restore bit for bit.

Every thread and process a test starts is joined with a timeout.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from adaptdl_tpu import checkpoint as jax_checkpoint
from adaptdl_tpu import metrics as jax_metrics
from adaptdl_tpu_torch import _signal, checkpoint, epoch, metrics
from adaptdl_tpu_torch.data import AdaptiveDataLoader
from tests import torch_rescale_worker as worker
from tests.torch_support import private_tempdir  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
GATE_TIMEOUT_S = 30


def _reset():
    checkpoint._reset_registry()
    jax_checkpoint._reset_registry()
    metrics._reset_state()
    jax_metrics._reset_state()
    epoch._reset_state()
    _signal.set_exit_flag(False)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in ("ADAPTDL_CKPT_EVERY_STEPS", "ADAPTDL_GUARD_CONFIRM_STEPS",
                 "ADAPTDL_HANDOFF", "ADAPTDL_NUM_RESTARTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(metrics, "_maybe_fit", lambda: None)
    _reset()
    yield
    _reset()


def _blob_class(module, gate=None):
    """A byte state of ``module`` whose write waits on ``gate``."""

    class Blob(module.State):
        def __init__(self, name, value):
            super().__init__(name)
            self.value = value

        def save(self, fileobj):
            fileobj.write(self.value)

        def load(self, fileobj):
            self.value = fileobj.read()

        def write_snapshot(self, snapshot, fileobj):
            if gate is not None:
                assert gate.wait(GATE_TIMEOUT_S), "gate never opened"
            fileobj.write(snapshot)

    return Blob


def _payloads(ckpt):
    return {
        name: (Path(ckpt) / name).read_bytes()
        for name in sorted(os.listdir(ckpt)) if name != "manifest.json"
    }


def test_async_save_writes_the_same_bytes_as_a_blocking_save(tmp_path, monkeypatch):
    value = np.random.default_rng(0).bytes(4096)
    dirs = {}
    for module in (checkpoint, jax_checkpoint):
        for wait in (True, False):
            root = tmp_path / f"{module.__name__.split('.')[0]}-{wait}"
            monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(root))
            module._reset_registry()
            _blob_class(module)("blob", value)
            if module is checkpoint:
                trainer, holder, ckpt = worker.build(seed=3)
                batch = trainer.to_device(worker.tokens())
                holder["state"], _ = trainer.train_step(worker.BATCH)(
                    holder["state"], {"tokens": batch["tokens"][: worker.BATCH]}
                )
            module.save_all_states(wait=wait)
            module.wait_for_inflight_save()
            dirs[module, wait] = module.latest_checkpoint_dir(str(root))
    for module in (checkpoint, jax_checkpoint):
        assert _payloads(dirs[module, True]) == _payloads(dirs[module, False])
    assert (
        _payloads(dirs[checkpoint, True])["blob"]
        == _payloads(dirs[jax_checkpoint, True])["blob"]
        == value
    )


def test_periodic_save_blocks_the_loop_for_the_snapshot_only(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("ADAPTDL_CKPT_EVERY_STEPS", "2")
    gate = threading.Event()
    _blob_class(checkpoint, gate)("blob", b"x")
    loader = AdaptiveDataLoader({"x": np.arange(64.0)}, batch_size=8)
    steps = 0
    try:
        for _ in loader:
            steps += 1
            if steps == 3:
                # The save after step 2 is still writing: the loop went on.
                inflight = checkpoint.inflight_save()
                assert inflight is not None and not inflight.done()
                assert not checkpoint.latest_checkpoint_dir(str(tmp_path))
                assert inflight.snapshot_s < 1.0
                break
        assert steps == 3
    finally:
        gate.set()
        checkpoint.wait_for_inflight_save()
    assert checkpoint.latest_checkpoint_dir(str(tmp_path))


@pytest.mark.parametrize("module", [checkpoint, jax_checkpoint], ids=["port", "jax"])
def test_load_during_an_inflight_write_sees_the_new_save(tmp_path, monkeypatch, module):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    gate = threading.Event()
    blob = _blob_class(module, gate)("blob", b"first")
    gate.set()
    module.save_all_states()
    gate.clear()
    blob.value = b"second"
    module.save_all_states(wait=False)
    opener = threading.Timer(0.2, gate.set)
    opener.start()
    try:
        blob.unregister()
        fresh = _blob_class(module)("blob", b"")
        assert module.load_state(fresh)
        assert fresh.value == b"second"
    finally:
        gate.set()
        opener.join(GATE_TIMEOUT_S)
        module.wait_for_inflight_save()


def test_good_marker_lands_only_on_a_completed_write(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("ADAPTDL_GUARD_CONFIRM_STEPS", "2")
    gate = threading.Event()
    _blob_class(checkpoint, gate)("blob", b"v")
    try:
        handle = checkpoint.save_all_states(wait=False)
        for _ in range(3):
            checkpoint.note_healthy_step()
        assert not handle.done() and not os.path.exists(handle.path)
    finally:
        gate.set()
    checkpoint.wait_for_inflight_save()
    # Confirmed during the write: the marker lands with the write.
    assert checkpoint.is_good_checkpoint(handle.path)
    assert os.path.isfile(os.path.join(handle.path, "manifest.json"))

    # An unhealthy observation during the write keeps it unmarked.
    gate.clear()
    try:
        handle = checkpoint.save_all_states(wait=False)
        checkpoint.note_healthy_step()
        checkpoint.reset_health_confirmation()
    finally:
        gate.set()
    checkpoint.wait_for_inflight_save()
    for _ in range(3):
        checkpoint.note_healthy_step()
    assert not checkpoint.is_good_checkpoint(handle.path)
    # Every good-marked dir is complete and verifies.
    for name in os.listdir(tmp_path):
        ckpt = tmp_path / name
        if checkpoint.is_good_checkpoint(str(ckpt)):
            assert checkpoint._verify(str(ckpt), "blob") == "ok"


def test_rollback_does_not_wait_for_the_write_in_flight(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("ADAPTDL_GUARD_CONFIRM_STEPS", "1")
    gate = threading.Event()
    gate.set()
    blob = _blob_class(checkpoint, gate)("blob", b"good")
    good = checkpoint.save_all_states().path
    checkpoint.note_healthy_step()
    assert checkpoint.is_good_checkpoint(good)
    gate.clear()
    blob.value = b"poisoned"
    opener = threading.Timer(3.0, gate.set)
    try:
        handle = checkpoint.save_all_states(wait=False)
        opener.start()
        checkpoint.reset_health_confirmation()  # the unhealthy observation
        assert checkpoint.rollback_to_good() == os.path.basename(good)
        assert not handle.done()  # the write is still held at the gate
        assert blob.value == b"good"
    finally:
        gate.set()
        opener.join(GATE_TIMEOUT_S)
    checkpoint.wait_for_inflight_save()
    # The write landed unmarked; its prune kept the good dir.
    assert os.path.isdir(handle.path) and not checkpoint.is_good_checkpoint(handle.path)
    assert checkpoint._verify(good, "blob") == "ok"


EXIT_SCRIPT = r"""
import os, sys, time
package = sys.argv[1]
if package == "port":
    from adaptdl_tpu_torch import checkpoint
else:
    from adaptdl_tpu import checkpoint

class Slow(checkpoint.State):
    def save(self, f):
        f.write(b"landed")
    def load(self, f):
        pass
    def write_snapshot(self, snap, f):
        time.sleep(1.0)
        f.write(snap)

Slow("slow")
checkpoint.save_all_states(wait=False)
sys.exit(0)
"""


@pytest.mark.parametrize("package", ["port", "jax"])
def test_the_exit_joins_an_inflight_write(tmp_path, package):
    run_env = {k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")}
    run_env.update(
        PYTHONPATH=str(REPO), ADAPTDL_CHECKPOINT_PATH=str(tmp_path),
        JAX_PLATFORMS="cpu",
    )
    proc = subprocess.run(
        [sys.executable, "-c", EXIT_SCRIPT, package], cwd=REPO, env=run_env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    ckpt = checkpoint.latest_checkpoint_dir(str(tmp_path))
    assert ckpt and (Path(ckpt) / "slow").read_bytes() == b"landed"


def test_restart_stats_carry_the_measured_write(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setattr(jax_metrics, "_maybe_fit_and_report", lambda *a, **k: None)
    stats = {}
    for module, metrics_mod in ((checkpoint, metrics), (jax_checkpoint, jax_metrics)):
        gate = threading.Event()
        opener = threading.Timer(0.05, gate.set)
        module._reset_registry()
        _blob_class(module, gate)("blob", b"v" * 1024)
        opener.start()
        module.save_all_states(wait=False)
        module.wait_for_inflight_save()
        opener.join(GATE_TIMEOUT_S)
        stats[module] = metrics_mod.restart_stats()
    port, jax = stats[checkpoint], stats[jax_checkpoint]
    assert set(port) == set(jax)
    for got in (port, jax):
        assert got["writeS"] >= 0.04 and got["snapshotS"] >= 0
        assert 0.5 < got["overlapFrac"] <= 1.0
        assert got["saveKind"] == "full"
    assert port["saveBytes"] == jax["saveBytes"] == 1024


def test_trainer_snapshot_reuses_its_host_buffers_and_chunks_round_trip(
    tmp_path, monkeypatch
):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    trainer, holder, ckpt = worker.build(seed=5)
    batch = trainer.to_device(worker.tokens())
    holder["state"], _ = trainer.train_step(worker.BATCH)(
        holder["state"], {"tokens": batch["tokens"][: worker.BATCH]}
    )
    first = ckpt.snapshot()
    buffers = [id(t) for t in ckpt._host]
    second = ckpt.snapshot()
    assert [id(t) for t in ckpt._host] == buffers
    n_bytes = sum(
        t.numel() * t.element_size()
        for t in trainer.model.state_dict().values()
    )
    assert ckpt.host_buffer_bytes > 3 * n_bytes  # weights and two moments
    assert first["model"].keys() == second["model"].keys()
    chunks = ckpt.snapshot_chunks(second)
    assert chunks[0][0] == "meta" and len(chunks) == 1 + len(ckpt._host)
    want = worker.digest(holder["state"])
    ckpt.unregister()
    trainer2, holder2, ckpt2 = worker.build(seed=6)
    assert worker.digest(holder2["state"]) != want
    ckpt2.load_chunks(chunks)
    assert worker.digest(holder2["state"]) == want
    assert torch.equal(holder2["state"].step, holder["state"].step)
