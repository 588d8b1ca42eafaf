"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers:
a build takes seconds, not minutes). A source that declares
``adaptdl-build: parts=N`` compiles as N objects in parallel, each with
``-DADAPTDL_PART=p``, linked into one library.

Libraries are cached across restarts as the JAX package caches XLA's
executables: in ``<dir>/.kernel_cache`` for the first of
``ADAPTDL_COMPILE_CACHE``, ``ADAPTDL_SHARE_PATH`` and
``ADAPTDL_CHECKPOINT_PATH`` that is set (``ADAPTDL_COMPILE_CACHE=off``,
or none set, keeps them in ``build/kernels/`` under the repository
root), so a successor on another machine loads what its predecessor
built. A library is named by a digest of its sources, the arch flags and
the torch and CUDA versions: a changed source or toolkit rebuilds, an
unchanged one is reused. Each builder compiles into names of its own
(process and thread) and renames the library into place, under a file
lock, so two ranks or incarnations sharing the cache build once and the
second loads the first's result.

Nothing is built at import time: the first launch of a kernel (or
:func:`build_all`) builds it. A missing or failing ``nvcc`` raises
:class:`KernelBuildError` with the compiler's output; there is no
fallback.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from adaptdl_tpu_torch import env

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

LAUNCHES: collections.Counter = collections.Counter()
_PARTS = re.compile(r"adaptdl-build:\s*parts=(\d+)")

_libraries: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """A kernel library could not be compiled or loaded."""


def reset_launches() -> None:
    LAUNCHES.clear()


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise KernelBuildError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
        "of adaptdl_tpu_torch need the CUDA toolkit to build"
    )


def cache_dir() -> Path:
    """Where the libraries live: ``<dir>/.kernel_cache`` for the first of
    ``ADAPTDL_COMPILE_CACHE``, the share path and the checkpoint path
    that is set; ``build/kernels/`` when the knob is ``off`` or none is
    set."""
    knob = env.compile_cache_knob()
    if knob.lower() in ("off", "0", "false", "none"):
        return BUILD_DIR
    path = knob or env.share_path() or env.checkpoint_path()
    if not path:
        return BUILD_DIR
    return Path(os.path.abspath(path)) / ".kernel_cache"


def _digest(name: str, arch_flags=ARCH_FLAGS) -> str:
    """Digest of a library's sources, arch flags and torch and CUDA
    versions."""
    import torch

    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    digest = hashlib.sha256()
    for path in [src, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(arch_flags).encode())
    digest.update(f"torch {torch.__version__} cuda {torch.version.cuda}".encode())
    return digest.hexdigest()[:16]


def _library_path(name: str) -> Path:
    return cache_dir() / f"{name}-{_digest(name)}.so"


def _temp_stem(out: Path) -> str:
    """This builder's own prefix for temporary objects and libraries."""
    return f"{out.name}.{os.getpid()}.{threading.get_ident()}"


def _nvcc_run(cmd: list[str], what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed for {what} (exit {proc.returncode}):\n"
            f"{proc.stderr}{proc.stdout}"
        )
    return proc.stderr + proc.stdout


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    The ptxas report (registers, shared memory, spills) is kept beside
    the library as ``<library>.log``."""
    out = _library_path(name)
    if out.exists():
        return out
    _nvcc()  # raises before anything is created without a toolkit
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".so.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # Another builder may have finished while this one waited.
        if not out.exists():
            _compile(name, out)
    return out


def _compile(name: str, out: Path) -> None:
    src = CSRC_DIR / f"{name}.cu"
    stem = _temp_stem(out)
    compile_flags = [
        *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
        "-Xptxas=-v",
    ]
    found = _PARTS.search(src.read_text())
    parts = int(found.group(1)) if found else 1
    objects = [out.parent / f"{stem}.part{p}.o" for p in range(parts)]
    tmp = out.parent / f"{stem}.tmp"

    def compile_part(p: int) -> str:
        define = [f"-DADAPTDL_PART={p}"] if found else []
        return _nvcc_run(
            [_nvcc(), *compile_flags, *define, "-c", "-o", str(objects[p]),
             str(src)],
            f"{name} part {p}",
        )

    try:
        with ThreadPoolExecutor(max_workers=parts) as pool:
            logs = list(pool.map(compile_part, range(parts)))
        _nvcc_run(
            [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *map(str, objects)],
            f"{name} link",
        )
        out.with_suffix(".so.log").write_text("".join(logs))
        os.replace(tmp, out)
    finally:
        for path in [*objects, tmp]:
            path.unlink(missing_ok=True)


def build_all() -> dict[str, Path]:
    """Build every kernel source at once, the sources in parallel."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: future.result() for name, future in futures.items()}


def build_log(name: str) -> str:
    """The ptxas report of the built library for ``name``."""
    return _library_path(name).with_suffix(".so.log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it on first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise KernelBuildError(
                    f"cannot load kernel library {path}: {exc}"
                ) from exc
            lib.adaptdl_cuda_error_string.argtypes = [ctypes.c_int]
            lib.adaptdl_cuda_error_string.restype = ctypes.c_char_p
            _libraries[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        message = lib.adaptdl_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({message})")
