"""Host C++ of ``csrc/`` compiled with the host's ``g++`` into ``_build/``
at first use, for ``ctypes``: named by a hash of the source and the flags
(as the CUDA library of ``ops/cuda_build.py``, which does not build these),
with no ``-march=native``, so a library built on one host loads on another.
A missing ``g++`` or a failed build raises; no caller has a fallback."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless a library for its hash exists."""
    out = library_path(source)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source.name} is built with the "
                           "host's g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        lib = os.path.join(tmpdir, out.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", lib],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent loader sees all or none
    return out
