"""Build the port's host C++ sources into shared libraries.

Each ``csrc/<name>.cpp`` has a plain C interface and compiles with the host
C++ compiler (``g++``) into ``_build/lib<name>-<hash>.so`` beside the CUDA
kernels' libraries (:mod:`.cuda_build`); the hash covers the source and the
flags, so an edited source rebuilds.  Nothing is built at import time: the
first :func:`load` runs the compiler.  A host without ``g++``, or a failed
build, raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from .cuda_build import BUILD_DIR, CSRC_DIR

CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LOADED = {}


def library_path(name):
    src = CSRC_DIR / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name, timeout=300):
    """Compile ``csrc/<name>.cpp`` unless its library exists; returns the
    library's path."""
    out = library_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host libraries cannot be "
                           "built on this host")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cpp")],
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders agree
    return out


def load(name):
    """The ctypes handle of ``csrc/<name>.cpp``'s library, built on first
    use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
