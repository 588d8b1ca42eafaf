"""The port's TensorBoard writer against the JAX package's.

At one fixed wall time (``time.time`` patched in both modules), the same
scalars and the same uint8 image grid give event records equal byte for
byte; the port reads them back, and its MetricsWriter files under the
port's share path and replica rank.
"""

import os

import numpy as np

from adaptdl_tpu import tensorboard as jax_tb
from adaptdl_tpu_torch import tensorboard as tb
from tests.torch_support import private_tempdir  # noqa: F401

WALL = 1_700_000_000.25


def _write(module, logdir):
    writer = module.EventFileWriter(str(logdir))
    writer.add_scalars(3, {"dcgan/d_loss": 1.25, "dcgan/g_loss": 0.5})
    grid = np.random.default_rng(0).integers(0, 256, size=(8, 12, 3))
    writer.add_image(3, "dcgan/samples", grid.astype(np.uint8))
    writer.add_scalars(4, {"dcgan/d_loss": 1.0})
    writer.close()
    with open(writer.path, "rb") as f:
        return writer.path, f.read()


def test_records_equal_the_jax_writer_byte_for_byte(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_tb.time, "time", lambda: WALL)
    monkeypatch.setattr(tb.time, "time", lambda: WALL)
    want_path, want = _write(jax_tb, tmp_path / "jax")
    got_path, got = _write(tb, tmp_path / "port")
    assert got == want
    assert os.path.basename(got_path) == os.path.basename(want_path)
    assert tb.read_events(got_path) == [
        (3, {"dcgan/d_loss": 1.25, "dcgan/g_loss": 0.5}),
        (4, {"dcgan/d_loss": 1.0}),
    ]


def test_metrics_writer_files_under_the_share_path_by_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_SHARE_PATH", str(tmp_path))
    monkeypatch.setenv("ADAPTDL_REPLICA_RANK", "1")
    writer = tb.MetricsWriter()
    writer.write(7, {"loss": 2.0, "gain": 1.5, "ignored": 9.0})
    writer.close()
    assert writer.path.startswith(str(tmp_path / "replica-1" / "adaptdl"))
    assert tb.read_events(writer.path) == [
        (7, {"adaptdl/loss": 2.0, "adaptdl/gain": 1.5})
    ]
