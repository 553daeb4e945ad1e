"""The hand-written CUDA RLC kernels: build, bind and launch.

Counterpart of ``at2_node_tpu/ops/aggregate.py::_rlc_graph_packed``: the
two kernels in ``csrc/ed25519_rlc.cu`` (the lane math in
``csrc/ed25519_lane.cuh``, shared with the verify kernel) replace that XLA
graph for Hopper. ``ed25519_rlc_lanes`` classifies each lane, computes its
residual and folds a block's code-1 residuals into one point;
``ed25519_rlc_fold`` folds the blocks' points and writes eq_ok. They are
compiled with nvcc for ``sm_90a`` into ``at2_node_tpu_torch/build/`` at
first use, from the sources in the package only, and loaded with ctypes.

:func:`rlc_packed` is the wrapper: for a tensor on the CPU it runs the
plain PyTorch version (``ops.aggregate.rlc_graph_packed_plain``); for a
CUDA tensor it launches both kernels on the current stream or raises. It
never falls back.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import torch

from ..native._build import compile_lib
from .aggregate import RLC_PACKED_WIDTH, rlc_graph_packed_plain
from .cuda_verify import NVCC_FLAGS, _device_consts, _nvcc

SOURCES = ("csrc/ed25519_rlc.cu",)
DEPENDS = ("csrc/ed25519_lane.cuh",)
LIB_NAME = "libed25519_rlc.so"

# What one lane uses in ed25519_rlc_lanes, once per lane (the quad's
# repeated or discarded work not charged), as the kernel's g++ build counts
# it (tests/test_torch_kernel_host.py). Field multiplications: two
# decompressions (12 + 262 each) and the two T = xy (1 each); two tables of
# multiples 1..8 (a conversion to cached form of 1, 4 doublings and 3
# additions of 8, and a conversion of 1 per further entry: 64 each); two
# torsion checks of 252 doublings and 30 additions (8 each); the residual's
# two carry additions, 256 doublings, 64 additions each of R's and A's
# entries and 32 of B's.
FIELD_MULS_PER_LANE = (
    2 * (12 + 262) + 2 + 2 * 64 + 2 * (252 + 30) * 8 + (2 + 256 + 2 * 64 + 32) * 8
)
# Of those, squarings: 255 per decompression and 4 per doubling (4
# doublings a table, 252 a torsion check, 256 in the residual).
FIELD_SQUARES_PER_LANE = 2 * 255 + (2 * 4 + 2 * 252 + 256) * 4
# The fold: n - 1 additions for n lanes, each a conversion to cached form
# and an addition, 9 multiplications.
FIELD_MULS_PER_FOLD_ADD = 9
# A multiplication is 100 32x32->64-bit products (IMAD.WIDE), a squaring 55,
# each two int32 multiply-add issue slots.
INT32_MULADD_SLOTS_PER_LANE = 2 * (
    100 * (FIELD_MULS_PER_LANE - FIELD_SQUARES_PER_LANE) + 55 * FIELD_SQUARES_PER_LANE
)
INT32_MULADD_SLOTS_PER_FOLD_ADD = 2 * 100 * FIELD_MULS_PER_FOLD_ADD

# Launches of each kernel made through rlc_packed (not the plain version's
# runs): the lanes kernel and the fold kernel.
launches = 0
fold_launches = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output from the build of this process, if it built


def build() -> ctypes.CDLL:
    """Compile (unless fresh) and load the kernels' library. Raises
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
        lib.ed25519_rlc_lanes_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ed25519_rlc_lanes_launch.restype = ctypes.c_int
        lib.ed25519_rlc_fold_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ed25519_rlc_fold_launch.restype = ctypes.c_int
        lib.ed25519_rlc_lanes_per_block.argtypes = []
        lib.ed25519_rlc_lanes_per_block.restype = ctypes.c_int
        lib.ed25519_rlc_error_string.argtypes = [ctypes.c_int]
        lib.ed25519_rlc_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ed25519_rlc_error_string(rc).decode()}")


def rlc_packed(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 161) uint8 rows -> (eq, (1,) uint8: 1 when the fold of the code-1
    residuals is the identity; codes, (B,) uint8), two views of one (B + 1,)
    tensor on the rows' device. CPU tensor: the plain version. CUDA tensor:
    both kernels, on the current stream, without synchronising."""
    global launches, fold_launches
    if not isinstance(packed, torch.Tensor):
        raise TypeError("packed must be a torch.Tensor")
    if packed.dtype != torch.uint8 or packed.dim() != 2 or packed.shape[1] != RLC_PACKED_WIDTH:
        raise ValueError(
            f"packed must be (B, {RLC_PACKED_WIDTH}) uint8, got {packed.dtype} {tuple(packed.shape)}"
        )
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    n = packed.shape[0]
    out = torch.empty((n + 1,), dtype=torch.uint8, device=packed.device)
    if packed.device.type == "cpu":
        eq_ok, codes = rlc_graph_packed_plain(packed)
        out[:n] = codes
        out[n] = eq_ok
        return out[n:], out[:n]
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if n == 0:
        out.fill_(1)  # no lane in the equation
        return out[n:], out[:n]

    lib = build()
    blocks = -(-n // lib.ed25519_rlc_lanes_per_block())
    partials = torch.empty((blocks, 4, 10), dtype=torch.int32, device=packed.device)
    consts = _device_consts(packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = lib.ed25519_rlc_lanes_launch(
            packed.data_ptr(), n, consts.data_ptr(), out.data_ptr(), partials.data_ptr(), stream
        )
        _check(lib, rc, "ed25519_rlc_lanes")
        launches += 1
        rc = lib.ed25519_rlc_fold_launch(
            partials.data_ptr(), blocks, consts.data_ptr(), out[n:].data_ptr(), stream
        )
        _check(lib, rc, "ed25519_rlc_fold")
        fold_launches += 1
    return out[n:], out[:n]
