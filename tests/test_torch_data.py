"""The port's loader, checkpoint registry and metrics state.

The loader's batch-size decision is held to the JAX package's
``AdaptiveDataLoader`` given the same fitted goodput model; the
checkpoint registry must restore what it saved, refuse a corrupt
payload rather than cold-start, and prune superseded versions; the
metrics state must survive a checkpoint round trip.
"""

import os

import numpy as np
import pytest

from adaptdl_tpu import data as jdata
from adaptdl_tpu import metrics as jmetrics
from adaptdl_tpu_torch import checkpoint, data, metrics
from adaptdl_tpu_torch.goodput import GradParams, PerfParams
from tests.test_goodput import GRAD, PERF
from tests.torch_support import private_tempdir  # noqa: F401


@pytest.fixture(autouse=True)
def _port_state():
    checkpoint._reset_registry()
    metrics._reset_state()
    jmetrics._reset_state()
    yield
    checkpoint._reset_registry()
    metrics._reset_state()
    jmetrics._reset_state()


def test_bucket_grid_matches_jax():
    for atomic in range(1, 700):
        assert data.bucket_atomic_bsz(atomic) == jdata.bucket_atomic_bsz(atomic)


@pytest.mark.parametrize(
    "bounds, accumulation", [((4, 128), True), ((8, 64), False), (None, True)]
)
def test_batch_size_decision_matches_jax(bounds, accumulation):
    dataset = {"x": np.zeros((4096, 2), np.float32)}
    loaders = []
    for package in (data, jdata):
        loader = package.AdaptiveDataLoader(dataset, batch_size=32)
        loader.autoscale_batch_size(1024, bounds, accumulation)
        assert loader._rank0_decision() == (
            32 if bounds is None else int(np.clip(32, *bounds)), 0
        ), "no fitted model yet: the initial batch"
        loaders.append(loader)
    metrics._state.perf_params = PerfParams(*PERF)
    jmetrics._state.perf_params = PERF
    decisions = set()
    for sqr, var in ((GRAD.sqr, GRAD.var), (1e-4, 1e-1), (1e-1, 1e-4)):
        metrics._state.grad_params = GradParams(sqr, var)
        jmetrics._state.grad_params = type(GRAD)(sqr, var)
        port, reference = (loader._rank0_decision() for loader in loaders)
        assert port == reference, (sqr, var)
        decisions.add(port)
    # One replica scales its batch only through accumulation.
    assert (len(decisions) > 1) == accumulation, decisions


def test_checkpoint_round_trip_prunes_and_refuses_corruption(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))

    class Blob(checkpoint.State):
        def __init__(self, name, value):
            super().__init__(name)
            self.value = value

        def save(self, fileobj):
            fileobj.write(self.value)

        def load(self, fileobj):
            self.value = fileobj.read()

    a, b = Blob("a", b"first"), Blob("b", b"other")
    checkpoint.save_all_states()
    a.value = b"second"
    newest = checkpoint.save_all_states()
    assert [os.path.basename(newest)] == sorted(
        d for d in os.listdir(tmp_path) if d.startswith("checkpoint-")
    ), "the superseded version is pruned"
    a.value = b.value = b""
    assert checkpoint.load_state(a) and checkpoint.load_state(b)
    assert (a.value, b.value) == (b"second", b"other")

    with open(os.path.join(newest, "a"), "r+b") as f:
        f.write(b"X")
    checkpoint._reset_registry()
    fresh = Blob("a", b"")
    with pytest.raises(checkpoint.CheckpointUnreadableError):
        checkpoint.load_state(fresh)
    assert fresh.value == b""


def test_metrics_state_survives_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    metrics.set_batch_size_config(32, 1024, (4, 128), True)
    metrics.profile_accum_time(32, 0.25)
    metrics.update_grad_params(0.5, 2.0)
    metrics.update_progress(7.0)
    metrics._state.perf_params = PerfParams(*PERF)
    metrics.ensure_checkpoint_registered()
    checkpoint.save_all_states()
    saved = metrics._state

    checkpoint._reset_registry()
    metrics._reset_state()
    metrics.ensure_checkpoint_registered()
    assert checkpoint.load_state(checkpoint._registry["adaptdl_metrics"])
    restored = metrics._state
    assert restored is not saved
    assert restored.perf_params == saved.perf_params
    assert restored.grad_params == saved.grad_params
    assert restored.progress == 7.0
    assert dict(restored.profile) == dict(saved.profile)
    assert metrics.get_goodput_fn() is not None


def test_collectives_are_identities_without_a_group_and_reduce_within_one():
    import socket

    import torch
    import torch.distributed as dist

    from adaptdl_tpu_torch import collective

    t = torch.ones(3)
    assert collective.broadcast({"a": 1}) == {"a": 1}
    assert collective.allreduce_async(True, any).result() is True
    assert collective.allreduce_mean([t])[0] is t
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1
    )
    try:
        assert collective.broadcast((32, 1)) == (32, 1)
        assert collective.allreduce(3, sum) == 3
        assert collective.allreduce_async(False, any).result() is False
        (mean,) = collective.allreduce_mean([torch.full((3,), 2.0)])
        assert torch.equal(mean, torch.full((3,), 2.0))
    finally:
        dist.destroy_process_group()


def test_bucketing_never_takes_the_batch_below_the_initial_one(monkeypatch):
    """At 3 replicas and an initial batch of 32 the optimizer may pick
    atomic 11 (global 33); the bucket grid rounds it to 8, a global 24
    the goodput model is not defined at. The JAX loader fails its
    assertion there; the port takes the next bucket up, 16."""
    monkeypatch.setenv("ADAPTDL_NUM_REPLICAS", "3")
    perf = dict(alpha_c=1e-4, beta_c=1e-3, alpha_n=1e-3, beta_n=0.0,
                alpha_r=1e-3, beta_r=0.0, gamma=1.0)
    dataset = {"x": np.zeros((512, 2), np.float32)}
    loaders = []
    for package in (data, jdata):
        loader = package.AdaptiveDataLoader(dataset, batch_size=32)
        loader.autoscale_batch_size(128, (8, 64), True)
        loaders.append(loader)
    metrics._state.perf_params = PerfParams(**perf)
    jmetrics._state.perf_params = type(PERF)(**perf)
    metrics._state.grad_params = GradParams(1.0, 1e-3)
    jmetrics._state.grad_params = type(GRAD)(1.0, 1e-3)
    goodput_fn = metrics.get_goodput_fn()
    assert goodput_fn.optimize(
        1, 3, max_batch_size=128, atomic_bsz_range=(8, 64), accumulation=True
    )[1:] == (11, 0)
    assert loaders[0]._rank0_decision() == (16, 0)
    with pytest.raises(AssertionError):
        loaders[1]._rank0_decision()
    assert [data.bucket_atomic_bsz(a, minimum=m) for a, m in
            ((3, 4), (8, 9), (120, 121), (130, 129), (500, 100))] == [4, 16, 128, 192, 448]
