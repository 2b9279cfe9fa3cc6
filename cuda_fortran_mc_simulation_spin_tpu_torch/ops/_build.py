"""Build and load the CUDA kernels (``csrc/*.cu``) with nvcc and ctypes.

Each source compiles on first use, by hand, into a plain shared library
with a C interface: no PyTorch headers, so a build takes seconds rather
than minutes.  The library lands in ``.build/`` at the repo root and is
rebuilt when any file under ``csrc/`` is newer than it.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / ".build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
BUILD_TIMEOUT_S = 600

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return newest > lib.stat().st_mtime


def build_command(name: str, out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: list[str], force: bool = False) -> dict[str, float]:
    """Compile the named sources (``csrc/<name>.cu``) that are stale, or
    all of them with ``force``; one nvcc process each, all started
    together.  Returns the seconds each took; raises with nvcc's stderr
    on a failure or a timeout.  The compiler's register report goes to
    ``.build/lib<name>.log``."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        if not (force or _stale(name)):
            continue
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            build_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    secs = {}
    failures = []
    for name, (tmp, t0, proc) in procs.items():
        try:
            out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failures.append(f"nvcc {name}: timed out after "
                            f"{BUILD_TIMEOUT_S} s")
            continue
        secs[name] = time.perf_counter() - t0
        library_path(name).with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            failures.append(f"nvcc {name} exited {proc.returncode}:\n{err}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("\n".join(failures))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built if stale."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib

