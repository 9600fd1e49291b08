"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<stem>.cu`` is compiled once per source hash, at first use, into
``jpeg_gpu_tpu_torch/_build/`` as a shared library with a plain C interface
(``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``).  A failed
build raises: a kernel that does not build must stop the program, never
fall back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict

_CSRC = pathlib.Path(__file__).parent / "csrc"
_BUILD = pathlib.Path(__file__).parent / "_build"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# stem -> {"seconds": build time (0.0 when cached), "log": nvcc's output}
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    """The nvcc of ``$CUDA_HOME`` (or PyTorch's guess of it), else PATH's."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<stem>.cu``; raises on failure."""
    with _LOCK:
        if stem in _LIBS:
            return _LIBS[stem]
        src_path = _CSRC / f"{stem}.cu"
        src = src_path.read_bytes()
        tag = hashlib.sha256(src + repr(_FLAGS).encode()).hexdigest()[:16]
        _BUILD.mkdir(parents=True, exist_ok=True)
        out = _BUILD / f"{stem}_{tag}.so"
        info = {"seconds": 0.0, "log": ""}
        if not out.exists():
            # Private tmp name per process, then an atomic rename: concurrent
            # cold builds never interleave into one file.
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *_FLAGS, "-o", tmp, str(src_path)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            info["seconds"] = time.perf_counter() - t0
            info["log"] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src_path.name} (rc {proc.returncode}):\n"
                    f"{info['log']}"
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _LIBS[stem] = lib
        BUILD_INFO[stem] = info
        return lib
