"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, which is
loaded with ``ctypes``. Libraries go to ``elvis_tpu_torch/_build/`` (listed
in ``.gitignore``), named by a hash of their source and of the headers it
includes from ``csrc/``, and are built at first use; ``build_all`` starts
one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "build_all", "load"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
SOURCES: Dict[str, Path] = {
    "block_transform": _HERE / "csrc" / "block_transform.cu",
    "block_transform_batched": _HERE / "csrc" / "block_transform_batched.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build in this process
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_files(path: Path, seen: Optional[list] = None) -> list:
    """``path`` and every file it includes with ``#include "..."`` (beside
    it, recursively), each once, in include order."""
    seen = [] if seen is None else seen
    if path not in seen:
        seen.append(path)
        for rel in _INCLUDE.findall(path.read_text()):
            _source_files((path.parent / rel).resolve(), seen)
    return seen


def _lib_path(name: str) -> Path:
    """Library path named by a hash of the source and its own headers: a
    changed header rebuilds every source that includes it."""
    sha = hashlib.sha256()
    for path in _source_files(SOURCES[name]):
        sha.update(path.read_bytes())
    digest = sha.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source (default: all) whose library is missing,
    all ``nvcc`` processes started together. Returns seconds per build;
    raises with the compiler's output if one fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not _lib_path(n).is_file()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = {}
    try:
        for n in todo:
            tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
            procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
        times, errors = {}, []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            times[n] = time.time() - t0
            BUILD_LOGS[n] = log
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {SOURCES[n]} (rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, _lib_path(n))
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first when missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib
