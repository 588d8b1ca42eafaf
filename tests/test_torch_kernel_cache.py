"""The kernel-library cache on the share path (``ops/_build.py``), placed
as the JAX package's ``bootstrap._enable_compilation_cache`` places XLA's.

- The directory per knob: ``ADAPTDL_COMPILE_CACHE``, else
  ``ADAPTDL_SHARE_PATH``, else ``ADAPTDL_CHECKPOINT_PATH``, each with
  ``.kernel_cache``; ``off`` or none of them keeps ``build/kernels/``.
  The JAX package resolves the same precedence for its cache.
- The library's digest changes with the arch flags and with the torch
  and CUDA versions, not with the cache directory.
- Builders use names of their own (no shared temp name between
  processes or threads), and two builders of one library under the lock
  compile once: the second loads the first's result.

No ``nvcc`` here: the compiler is a stand-in that writes its outputs.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from adaptdl_tpu_torch.ops import _build
from tests.torch_support import private_tempdir  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
KNOBS = ("ADAPTDL_COMPILE_CACHE", "ADAPTDL_SHARE_PATH", "ADAPTDL_CHECKPOINT_PATH")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize(
    "knobs, want",
    [
        ({}, None),
        ({"ADAPTDL_CHECKPOINT_PATH": "ckpt"}, "ckpt"),
        ({"ADAPTDL_CHECKPOINT_PATH": "ckpt", "ADAPTDL_SHARE_PATH": "share"}, "share"),
        ({"ADAPTDL_SHARE_PATH": "share", "ADAPTDL_COMPILE_CACHE": "cache"}, "cache"),
        ({"ADAPTDL_SHARE_PATH": "share", "ADAPTDL_COMPILE_CACHE": "off"}, None),
        ({"ADAPTDL_CHECKPOINT_PATH": "ckpt", "ADAPTDL_COMPILE_CACHE": "none"}, None),
    ],
)
def test_the_cache_directory_follows_the_knobs(tmp_path, monkeypatch, knobs, want):
    for key, value in knobs.items():
        monkeypatch.setenv(key, value if value in ("off", "none") else str(tmp_path / value))
    got = _build.cache_dir()
    if want is None:
        assert got == _build.BUILD_DIR
    else:
        assert got == tmp_path / want / ".kernel_cache"
    # The JAX package's precedence for its executable cache.
    from adaptdl_tpu import env as jax_env

    knob = jax_env.compile_cache_knob()
    jax_path = None if knob.lower() in ("off", "none") else (
        knob or jax_env.share_path() or jax_env.checkpoint_path()
    )
    assert (jax_path and Path(jax_path).name) == want


def test_the_digest_follows_arch_flags_and_versions(tmp_path, monkeypatch):
    name = _build.sources()[0]
    base = _build._digest(name)
    assert _build._digest(name, ("-gencode", "arch=compute_90,code=sm_90")) != base
    monkeypatch.setattr(torch, "__version__", "0.0.0-other")
    assert _build._digest(name) != base
    monkeypatch.undo()
    monkeypatch.setattr(torch.version, "cuda", "99.9")
    assert _build._digest(name) != base
    monkeypatch.undo()
    monkeypatch.setenv("ADAPTDL_SHARE_PATH", str(tmp_path))
    assert _build._digest(name) == base
    assert _build._library_path(name).name == f"{name}-{base}.so"


def test_temp_names_are_per_process_and_thread(tmp_path):
    out = tmp_path / "lib.so"
    here = _build._temp_stem(out)
    other = subprocess.run(
        [sys.executable, "-c",
         "import sys; from pathlib import Path; "
         "from adaptdl_tpu_torch.ops import _build; "
         "print(_build._temp_stem(Path(sys.argv[1])))", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    ).stdout.strip()
    names = []
    thread = threading.Thread(target=lambda: names.append(_build._temp_stem(out)))
    thread.start()
    thread.join(10)
    assert len({here, other, names[0]}) == 3
    assert all(n.startswith("lib.so.") for n in (here, other, names[0]))


def test_two_builders_share_one_build(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_COMPILE_CACHE", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    outputs, started, release = [], threading.Event(), threading.Event()

    def fake_nvcc(cmd, what):
        out = Path(cmd[cmd.index("-o") + 1])
        outputs.append(out.name)
        started.set()
        assert release.wait(30)
        out.write_bytes(b"built")
        return ""

    monkeypatch.setattr(_build, "_nvcc_run", fake_nvcc)
    name = "flash_attention_fwd_sm90"
    results = []
    builders = [
        threading.Thread(target=lambda: results.append(_build.build(name)))
        for _ in range(2)
    ]
    builders[0].start()
    assert started.wait(30)
    builders[1].start()
    release.set()
    for thread in builders:
        thread.join(30)
    want = tmp_path / ".kernel_cache" / _build._library_path(name).name
    assert results == [want, want] and want.read_bytes() == b"built"
    # One builder compiled (its parts, then the link), each output under
    # its own name; the other waited on the lock and took the result.
    stems = {n.split(".part")[0].removesuffix(".tmp") for n in outputs}
    assert len(stems) == 1
    assert not [p for p in want.parent.iterdir() if ".part" in p.name or p.suffix == ".tmp"]
