"""Build and load the port's native libraries.

Each source has a plain C interface and is compiled into its own shared
library, which is loaded with ``ctypes``: the hand-written CUDA kernels
under ``csrc/`` by ``nvcc`` for Hopper (``sm_90a``), and the NVC codec's
range coder (``codec/nvc/csrc/rangecoder.cpp``) by the host's ``g++``, so
that it builds on a machine without the CUDA toolkit. Libraries go to
``elvis_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
their source and of the headers it includes beside it, and are built at
first use; ``build_all`` starts one compiler per source at once.
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
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["SOURCES", "build_all", "load"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
NVCC = ("nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")
# name -> (source, compiler and its flags)
SOURCES: Dict[str, Tuple[Path, Tuple[str, ...]]] = {
    "block_transform": (_HERE / "csrc" / "block_transform.cu", NVCC),
    "block_transform_batched": (_HERE / "csrc" / "block_transform_batched.cu", NVCC),
    "conv_epilogue": (_HERE / "csrc" / "conv_epilogue.cu", NVCC),
    "tail_conv": (_HERE / "csrc" / "tail_conv.cu", NVCC),
    "dcn": (_HERE / "csrc" / "dcn.cu", NVCC),
    "ffn_fold": (_HERE / "csrc" / "ffn_fold.cu", NVCC),
    "nvc_rc": (_HERE.parent / "codec" / "nvc" / "csrc" / "rangecoder.cpp", GXX),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output of each build in this process (nvcc's: the ptxas report of
# registers, shared memory and spills)
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
    for path in _source_files(SOURCES[name][0]):
        sha.update(path.read_bytes())
    digest = sha.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source (default: all) whose library is missing,
    all compilers started together. Returns seconds per build; raises with
    the compiler's output if one fails, and names a missing compiler after
    the other sources are built."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not _lib_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs, times, errors = {}, {}, []
    try:
        for n in todo:
            source, (compiler, *flags) = SOURCES[n]
            tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            try:
                cmd = [_nvcc() if compiler == "nvcc" else compiler, *flags, "-o", str(tmp),
                       str(source)]
                procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
            except (RuntimeError, OSError) as exc:  # no such compiler
                errors.append(f"{n}: {exc}")
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            times[n] = time.time() - t0
            BUILD_LOGS[n] = log
            if proc.returncode != 0:
                source, (compiler, *_) = SOURCES[n]
                errors.append(f"{compiler} failed for {source} (rc {proc.returncode}):\n{log}")
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
