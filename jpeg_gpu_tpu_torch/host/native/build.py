"""On-demand build of the native host decoder (g++ -> shared object).

The .so is compiled once per source hash into the package directory (or
``TPU_JPEG_NATIVE_CACHE`` if set) and loaded via ctypes.  No external build
system or bindings dependency needed; falls back cleanly if no compiler.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

from jpeg_gpu_tpu_torch.utils.logging import get_logger

log = get_logger("entropy")

_LOCK = threading.Lock()
_CACHED: dict = {}   # stem -> Optional[pathlib.Path] (None = build failed)


def _cache_dir() -> pathlib.Path:
    env = os.environ.get("TPU_JPEG_NATIVE_CACHE")
    if env:
        p = pathlib.Path(env)
    else:
        p = pathlib.Path(__file__).parent / "_build"
    p.mkdir(parents=True, exist_ok=True)
    return p


def _build(stem: str, extra_flags=()) -> Optional[pathlib.Path]:
    """Build (if needed) <stem>.cpp beside this file -> .so path, or None."""
    with _LOCK:
        if stem in _CACHED:
            return _CACHED[stem]
        src_path = pathlib.Path(__file__).with_name(f"{stem}.cpp")
        src = src_path.read_bytes()
        tag = hashlib.sha256(src + repr(extra_flags).encode()).hexdigest()[:16]
        out = _cache_dir() / f"{stem}_{tag}.so"
        if not out.exists():
            # Per-process tmp name: concurrent cold-cache builds (parallel
            # pytest workers, two CLIs) must not interleave g++ output into
            # one file; each builds privately, the os.replace is atomic and
            # last-writer-wins with identical content.
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [
                "g++", "-std=c++17", "-O3", "-march=native", "-fPIC",
                "-shared", "-pthread", str(src_path), "-o", tmp,
                *extra_flags,
            ]
            try:
                subprocess.run(
                    cmd, check=True, capture_output=True, timeout=120
                )
                os.replace(tmp, out)
                log.info("built native %s: %s", stem, out)
            except (subprocess.SubprocessError, OSError) as e:
                stderr = getattr(e, "stderr", b"")
                log.warning(
                    "native %s build failed (%s); falling back. stderr: %s",
                    stem, e,
                    (stderr or b"").decode(errors="replace")[:500],
                )
                _CACHED[stem] = None
                return None
        _CACHED[stem] = out
        return out


def shared_object_path() -> Optional[pathlib.Path]:
    """The xjpeg host entropy decoder .so (no external deps)."""
    return _build("xjpeg_host")


def oracle_object_path() -> Optional[pathlib.Path]:
    """The libjpeg-turbo oracle shim .so (links the system -ljpeg)."""
    return _build("jpeg_oracle", extra_flags=("-ljpeg",))
