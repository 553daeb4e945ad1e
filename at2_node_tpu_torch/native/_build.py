"""Build-on-first-use helpers for the port's shared libraries.

Every library (the g++ host prep, the g++ build of the kernel's lane math
for tests, the nvcc build of the CUDA kernel) is compiled from sources in
this package into ``at2_node_tpu_torch/build/``, which git ignores. A
library is rebuilt when any of its sources is newer than it; each process
compiles to its own temporary name and renames it into place, so two
processes building at once never load a half-written file.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

U8P = ctypes.POINTER(ctypes.c_uint8)
U32P = ctypes.POINTER(ctypes.c_uint32)
U64P = ctypes.POINTER(ctypes.c_uint64)

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")

GXX = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def compile_lib(
    compiler: Sequence[str],
    sources: Sequence[str],
    lib_name: str,
    depends: Sequence[str] = (),
    timeout: float = 600,
    link_args: Sequence[str] = (),
) -> Tuple[str, str]:
    """Compile ``sources`` (paths relative to the package) into
    ``build/lib_name`` unless it is newer than every source and header in
    ``depends``; ``link_args`` (``-l`` flags) follow the sources on the
    command line, where the linker needs them. Returns (library path, compiler output; empty when the
    cached library was fresh). Raises ``OSError`` when the compiler is
    missing and ``subprocess.CalledProcessError`` when it fails."""
    srcs = [os.path.join(PACKAGE_DIR, s) for s in sources]
    deps = srcs + [os.path.join(PACKAGE_DIR, d) for d in depends]
    lib_path = os.path.join(BUILD_DIR, lib_name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= max(
        os.path.getmtime(d) for d in deps
    ):
        return lib_path, ""
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [*compiler, *srcs, *link_args, "-o", tmp],
        capture_output=True, text=True, timeout=timeout,
    )
    if proc.returncode != 0:
        raise subprocess.CalledProcessError(
            proc.returncode, proc.args, proc.stdout, proc.stderr
        )
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


def load_gxx_lib(
    sources: Sequence[str],
    lib_name: str,
    depends: Sequence[str] = (),
    link_args: Sequence[str] = (),
) -> Optional[ctypes.CDLL]:
    """g++ build and load, or None when the toolchain is missing, the build
    or link fails, or the library does not load (callers fall back to their
    Python path)."""
    try:
        path, _ = compile_lib(
            GXX, sources, lib_name, depends, timeout=120, link_args=link_args
        )
        return ctypes.CDLL(path)
    except (OSError, subprocess.SubprocessError) as exc:
        logger.warning("native build of %s failed (%s)", lib_name, exc)
        return None


def pack_ragged(chunks: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten byte chunks into (flat u8 array, u64 offsets) for the C ABI."""
    offsets = np.zeros(len(chunks) + 1, dtype=np.uint64)
    np.cumsum([len(c) for c in chunks], out=offsets[1:])
    flat = (
        np.frombuffer(b"".join(chunks), dtype=np.uint8)
        if chunks
        else np.zeros(0, np.uint8)
    )
    return flat, offsets


def ptr8(a: np.ndarray):
    return a.ctypes.data_as(U8P)
