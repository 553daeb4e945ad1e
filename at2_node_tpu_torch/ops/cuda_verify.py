"""The hand-written CUDA ed25519 verify kernel: build, bind and launch.

Counterpart of ``at2_node_tpu/ops/pallas_verify.py``: the kernel in
``csrc/ed25519_verify.cu`` (four threads per signature; the math in
``csrc/ed25519_lane.cuh``) replaces ``_verify_tile`` for Hopper. It is
compiled with nvcc for ``sm_90a`` into ``at2_node_tpu_torch/build/`` at
first use, from the sources in the package only, and loaded with ctypes.

:func:`verify_packed` is the wrapper: for a tensor on the CPU it runs the
plain PyTorch version (``ops.ed25519.verify_packed``); for a CUDA tensor it
launches the kernel on the current stream or raises. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading

import numpy as np
import torch

from ..native._build import compile_lib
from . import edwards as ed
from . import field as fe
from .ed25519 import PACKED_WIDTH
from .ed25519 import verify_packed as verify_packed_plain

SOURCES = ("csrc/ed25519_verify.cu",)
DEPENDS = ("csrc/ed25519_lane.cuh",)
LIB_NAME = "libed25519_verify.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Four threads (a quad) verify one signature (csrc/ed25519_lane.cuh).
THREADS_PER_SIGNATURE = 4

# What one signature's verification uses in the kernel, once per signature
# (not the quad's repeated or discarded work); the g++ build of the
# kernel's math counts them (tests/test_torch_kernel_host.py). Field
# multiplications: two decompressions (12 + 262 for the square-root chain
# each) and -A's T (1); the cached table of multiples 1..8 of -A (4
# doublings and 3 additions of 8, and one conversion to cached form of 1
# per entry); the carry digits' addition (8); 64 Straus windows of h (4
# doublings of 8 and an addition of a cached entry of 8), 32 additions for
# the radix-256 digits of S (8 each); and the final compare (2).
FIELD_MULS_PER_LANE = (
    2 * (12 + 262) + 1 + (4 * 8 + 3 * 8 + 8) + 8 + 64 * (4 * 8 + 8) + 32 * 8 + 2
)
# Of those, squarings: 255 per decompression and 4 per doubling (4 for the
# table, 256 in the Straus loop).
FIELD_SQUARES_PER_LANE = 2 * 255 + (4 + 256) * 4
# A multiplication is 100 32x32->64-bit products (IMAD.WIDE), a squaring 55
# (ref10's fe_sq), each two int32 multiply-add issue slots.
INT32_MULADD_SLOTS_PER_LANE = 2 * (
    100 * (FIELD_MULS_PER_LANE - FIELD_SQUARES_PER_LANE) + 55 * FIELD_SQUARES_PER_LANE
)
# The plain version (ops/ed25519.py verify_packed) runs other formulas
# (ops/edwards.py): decompressions of 13 + 262, a table of multiples 0..15
# by 7 doublings and 7 additions of 9 (its addition multiplies by 2d), 64
# windows of 4 doublings and 2 additions of 9, and squares through its
# general multiply. A CPU test counts these.
PLAIN_FIELD_MULS_PER_LANE = 2 * (13 + 262) + (7 * 8 + 7 * 9) + 64 * (4 * 8 + 2 * 9) + 2
PLAIN_FIELD_SQUARES_PER_LANE = 2 * 255 + (7 + 256) * 4

# Kernel launches made through verify_packed (not the plain version's runs).
launches = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output from the build of this process, if it built


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build() -> ctypes.CDLL:
    """Compile (unless fresh) and load the kernel library. Raises
    RuntimeError with nvcc's output when the build fails."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        try:
            path, build_log = compile_lib((_nvcc(), *NVCC_FLAGS), SOURCES, LIB_NAME, DEPENDS)
        except subprocess.CalledProcessError as exc:
            raise RuntimeError(f"nvcc failed:\n{exc.stdout}\n{exc.stderr}") from exc
        except OSError as exc:
            raise RuntimeError(f"nvcc not found ({exc})") from exc
        lib = ctypes.CDLL(path)
        lib.ed25519_verify_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.ed25519_verify_launch.restype = ctypes.c_int
        lib.ed25519_verify_error_string.argtypes = [ctypes.c_int]
        lib.ed25519_verify_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _cached(x: int, y: int) -> np.ndarray:
    """Affine (x, y) -> cached form (y - x, y + x, 2z, 2d t) with z = 1."""
    return np.stack([
        fe.int_to_limbs(y - x), fe.int_to_limbs(y + x), fe.int_to_limbs(2),
        fe.int_to_limbs(2 * fe.D_INT * x * y),
    ])


def lane_consts() -> np.ndarray:
    """The int32 constants the kernel reads (``ed25519_lane.cuh``
    ``CONST_*``): d, 2d, sqrt(-1), the base point's affine x and y, then
    multiples 0..128 of B in cached form, limb-major within an entry:
    (129, 10, 4), component last."""
    points, acc = [], (0, 1)
    for _ in range(129):
        points.append(acc)
        acc = ed.affine_add_ints(acc, (ed.BX_INT, ed.BY_INT))
    table = np.stack([_cached(x, y) for x, y in points])
    return np.concatenate([
        fe.D, fe.D2, fe.SQRT_M1, fe.int_to_limbs(ed.BX_INT), fe.int_to_limbs(ed.BY_INT),
        table.transpose(0, 2, 1).reshape(-1),
    ]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_consts(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(lane_consts(), device=device)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None and "cuda" mean cuda:0; a CUDA device without a GPU raises.
    Only an explicit "cpu" selects the plain version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain version"
            )
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def verify_packed(packed: torch.Tensor) -> torch.Tensor:
    """(B, 129) uint8 packed rows -> (ceil(B/8),) uint8 MSB-first verdict
    bitmask. CPU tensor: the plain version. CUDA tensor: the kernel, on the
    current stream, without synchronising."""
    global launches
    if not isinstance(packed, torch.Tensor):
        raise TypeError("packed must be a torch.Tensor")
    if packed.dtype != torch.uint8 or packed.dim() != 2 or packed.shape[1] != PACKED_WIDTH:
        raise ValueError(
            f"packed must be (B, {PACKED_WIDTH}) uint8, got {packed.dtype} {tuple(packed.shape)}"
        )
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if packed.device.type == "cpu":
        return verify_packed_plain(packed)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")

    lib = build()
    n = packed.shape[0]
    bits = torch.empty(((n + 7) // 8,), dtype=torch.uint8, device=packed.device)
    if n == 0:
        return bits
    consts = _device_consts(packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device)
        rc = lib.ed25519_verify_launch(
            packed.data_ptr(), n, consts.data_ptr(), bits.data_ptr(), stream.cuda_stream
        )
    if rc != 0:
        raise RuntimeError(
            f"ed25519_verify launch failed: {lib.ed25519_verify_error_string(rc).decode()}"
        )
    launches += 1
    return bits
