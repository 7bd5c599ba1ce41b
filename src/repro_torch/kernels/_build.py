"""Build the CUDA kernels with ``nvcc`` at first use and load them by ctypes.

Each source in ``kernels/csrc/`` compiles on its own into a shared library
with a plain C interface, under ``<repo>/build/repro_torch/`` (``.gitignore``
lists ``build/``), named by a hash of the source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source or header rebuilds and an
unchanged one loads from the cache.  Nothing here runs when the module is
imported; :func:`load` compiles on the first call for a
source and keeps the handle for the process.

``nvcc`` is ``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``) or the one
on ``PATH``.  The target is ``sm_90a`` (Hopper).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# source name -> {"seconds": build time (0 when loaded from cache), "log": ptxas output}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA kernels "
            "build only where the CUDA toolkit is installed"
        )
    return found


def library_path(source: str, csrc: Path = CSRC) -> Path:
    """Where the library for ``csrc/<source>`` lands: keyed by the source
    text, the text of every shared header ``csrc/*.cuh`` (a source may
    include any of them) and the flags."""
    digest = hashlib.sha256((csrc / source).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def compile_source(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is cached; returns the path."""
    out = library_path(source)
    if out.exists():
        build_info.setdefault(source, {"seconds": 0.0, "log": "cached"})
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile beside the target, then rename: a concurrent loader never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info[source] = {
        "seconds": time.perf_counter() - t0,
        "log": (proc.stdout + proc.stderr).strip(),
    }
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(source)))
            _libs[source] = lib
        return lib
