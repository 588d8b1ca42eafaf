"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers:
a build takes seconds, not minutes). A source that declares
``adaptdl-build: parts=N`` compiles as N objects in parallel, each with
``-DADAPTDL_PART=p``, linked into one library. Libraries land in
``build/kernels/`` under the repository root, named by a hash of the
sources, so a changed source rebuilds and an unchanged one is reused.
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
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    digest = hashlib.sha256()
    for path in [src, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = CSRC_DIR / f"{name}.cu"
    stem = f"{out.name}.{os.getpid()}.{threading.get_ident()}"
    compile_flags = [
        *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
        "-Xptxas=-v",
    ]
    found = _PARTS.search(src.read_text())
    parts = int(found.group(1)) if found else 1
    objects = [BUILD_DIR / f"{stem}.part{p}.o" for p in range(parts)]
    tmp = BUILD_DIR / f"{stem}.tmp"

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
    return out


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
