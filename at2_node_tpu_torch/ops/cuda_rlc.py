"""The hand-written CUDA RLC kernels: build, bind and launch.

Counterpart of ``at2_node_tpu/ops/aggregate.py::_rlc_graph_packed``: the
two kernels in ``csrc/ed25519_rlc.cu`` (the lane math in
``csrc/ed25519_lane.cuh``, shared with the verify kernel) replace that XLA
graph for Hopper. ``ed25519_rlc_lanes`` classifies each lane, computes its
residual and folds a block's code-1 residuals into one partial point;
``ed25519_rlc_fold`` folds the partials and writes eq_ok. They are
compiled with nvcc for ``sm_90a`` into ``at2_node_tpu_torch/build/`` at
first use, from the sources in the package only, and loaded with ctypes.

The lanes kernel has two layouts, instantiations of one template:

- ``SPLIT``: a lane on four quads in four warps (A's and R's decompression,
  table and [L]P; [zh]A - [zs]B; [z]R), eight lanes a 128-thread block. A
  launch is one lane's chain of ~1,000 quad rounds, K1's, where the whole
  layout's is ~2,300; it does 9% more work (:data:`FIELD_MULS_PER_LANE`).
- ``WHOLE``: a lane on one quad with the joint Straus loop, 16 lanes a
  64-thread block, for launches where total work sets the time.

:func:`choose_layout` takes the split layout while a launch fits in one
wave of its resident blocks (its occupancy times the SM count, queried
once a device), else the whole layout.

:func:`rlc_packed` is the wrapper: for a tensor on the CPU it runs the
plain PyTorch version (``ops.aggregate.rlc_graph_packed_plain``); for a
CUDA tensor it launches both kernels on the current stream or raises. It
never falls back, from one layout to the other or to the plain version.
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

# The lanes kernel's layouts (csrc/ed25519_rlc.cu), by the index its C
# interface takes, and their threads a lane and lanes a block.
WHOLE, SPLIT = 0, 1
LAYOUT_NAMES = ("whole", "split")
THREADS_PER_LANE = (4, 16)
LANES_PER_BLOCK = (16, 8)
POINT_WORDS = 4 * 10

# What one lane uses in each layout of ed25519_rlc_lanes, once per lane
# (the quad's repeated or discarded work not charged), as the kernel's g++
# build counts it (tests/test_torch_kernel_host.py). Whole: two
# decompressions (12 + 262 each) and the two T = xy (1 each); two tables of
# multiples 1..8 (a conversion to cached form of 1, 4 doublings and 3
# additions of 8, and a conversion of 1 per further entry: 64 each); two
# torsion checks of 252 doublings and 30 additions (8 each); the residual's
# two carry additions, 256 doublings, 64 additions each of R's and A's
# entries and 32 of B's. Split: the same decompressions, tables and
# torsion checks; [zh]A - [zs]B's two carry additions, 256 doublings, 64
# additions of A's entries and 32 of B's; [z]R's 128 doublings and 32
# additions.
_SHARED = 2 * (12 + 262) + 2 + 2 * 64 + 2 * (252 + 30) * 8
FIELD_MULS_PER_LANE = (
    _SHARED + (2 + 256 + 2 * 64 + 32) * 8,
    _SHARED + (2 + 256 + 64 + 32) * 8 + (128 + 32) * 8,
)
# Of those, squarings: 255 per decompression and 4 per doubling (4
# doublings a table, 252 a torsion check, 256 in the residual, and in the
# split layout 128 more for [z]R).
FIELD_SQUARES_PER_LANE = (
    2 * 255 + (2 * 4 + 2 * 252 + 256) * 4,
    2 * 255 + (2 * 4 + 2 * 252 + 256 + 128) * 4,
)
# The fold: n - 1 additions for n points, each a conversion to cached form
# and an addition, 9 multiplications.
FIELD_MULS_PER_FOLD_ADD = 9
# A multiplication is 100 32x32->64-bit products (IMAD.WIDE), a squaring 55,
# each two int32 multiply-add issue slots.
INT32_MULADD_SLOTS_PER_LANE = tuple(
    2 * (100 * (m - s) + 55 * s) for m, s in zip(FIELD_MULS_PER_LANE, FIELD_SQUARES_PER_LANE)
)
INT32_MULADD_SLOTS_PER_FOLD_ADD = 2 * 100 * FIELD_MULS_PER_FOLD_ADD

# The fold kernel (csrc FOLD_THREADS): at most 32 quads a block, each
# adding at most FOLD_PER_QUAD partials before the block's tree; more
# partials take more blocks, and the last block to finish folds their
# points.
FOLD_MAX_QUADS = 32
FOLD_PER_QUAD = 4

# Launches of each kernel made through rlc_packed (not the plain version's
# runs): the lanes kernel, in either layout, and the fold kernel; and the
# lanes kernel's by layout (WHOLE, SPLIT).
launches = 0
fold_launches = 0
layout_launches = [0, 0]


def choose_layout(n: int, split_wave_lanes: int) -> int:
    """The lanes kernel's layout for a launch of n lanes: SPLIT while the
    launch fits in one wave of the split layout's resident blocks
    (``split_wave_lanes`` lanes), else WHOLE. Past one wave the split
    layout's blocks queue behind each other and its 9% more work shows,
    where the whole layout's 16 lanes a block keep the SMs full. On an
    H100 80GB HBM3 at 700 W (two split blocks an SM, a wave of 2,112
    lanes; ``chip_smoke.py`` phase 3b) the crossover is that wave: at
    2,112 lanes split 0.648 ms against whole 0.969, at 2,120 split 1.038
    against 0.970."""
    return SPLIT if n <= split_wave_lanes else WHOLE


def partials_for(n: int, layout: int) -> int:
    """The partial points a launch of n lanes writes: one a block."""
    return -(-n // LANES_PER_BLOCK[layout])


def fold_grid(nparts: int) -> tuple[int, int]:
    """(blocks, threads a block) of the fold over nparts partial points:
    each block's quads add at most FOLD_PER_QUAD partials each, then a
    tree in shared memory; a block has as many quads as its share
    rounded up to a power of two, between 8 (a whole warp) and
    FOLD_MAX_QUADS."""
    per_block = FOLD_MAX_QUADS * FOLD_PER_QUAD
    blocks = max(1, -(-nparts // per_block))
    share = -(-nparts // blocks)
    quads = min(FOLD_MAX_QUADS, max(8, 1 << (share - 1).bit_length()))
    return blocks, 4 * quads


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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.ed25519_rlc_lanes_launch.restype = ctypes.c_int
        lib.ed25519_rlc_fold_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.ed25519_rlc_fold_launch.restype = ctypes.c_int
        lib.ed25519_rlc_lanes_per_block.argtypes = [ctypes.c_int]
        lib.ed25519_rlc_lanes_per_block.restype = ctypes.c_int
        lib.ed25519_rlc_lanes_occupancy.argtypes = [ctypes.c_int]
        lib.ed25519_rlc_lanes_occupancy.restype = ctypes.c_int
        lib.ed25519_rlc_error_string.argtypes = [ctypes.c_int]
        lib.ed25519_rlc_error_string.restype = ctypes.c_char_p
        got = tuple(lib.ed25519_rlc_lanes_per_block(x) for x in (WHOLE, SPLIT))
        if got != LANES_PER_BLOCK:
            raise RuntimeError(f"{LIB_NAME} takes {got} lanes a block, this module {LANES_PER_BLOCK}")
        _lib = lib
        return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ed25519_rlc_error_string(rc).decode()}")


_waves: dict = {}  # device index -> lanes in one wave of the split layout


def split_wave_lanes(device: torch.device) -> int:
    """Lanes in one wave of the split layout's resident blocks on
    ``device``: its blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
    times the SM count times its lanes a block, queried once a device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _waves:
        lib = build()
        with torch.cuda.device(index):
            per_sm = lib.ed25519_rlc_lanes_occupancy(SPLIT)
        if per_sm < 0:
            raise RuntimeError(f"ed25519_rlc_lanes occupancy query failed: "
                               f"{lib.ed25519_rlc_error_string(-per_sm).decode()}")
        if per_sm == 0:
            raise RuntimeError("no block of the split layout fits on an SM")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _waves[index] = per_sm * sms * LANES_PER_BLOCK[SPLIT]
    return _waves[index]


class Scratch:
    """One launch's device scratch, one int32 tensor: the lanes kernel's
    partial points (one a block of ``layout``), the fold's block points and
    its ticket (the count of fold blocks done, zeroed by the lanes kernel
    and again by the fold's last block). Each launch has its own, so
    launches on concurrent streams never share a ticket."""

    def __init__(self, n: int, layout: int, device) -> None:
        self.n, self.layout = n, layout
        self.nparts = partials_for(n, layout)
        self.fold_blocks, self.fold_threads = fold_grid(self.nparts)
        self.words = torch.empty(((self.nparts + self.fold_blocks) * POINT_WORDS + 1,),
                                 dtype=torch.int32, device=device)
        base = self.words.data_ptr()
        self.partials = base
        self.level2 = base + 4 * self.nparts * POINT_WORDS
        self.ticket = base + 4 * (self.nparts + self.fold_blocks) * POINT_WORDS

    def points(self) -> torch.Tensor:
        """The partial points, (nparts, 4, 10) int32, a view."""
        return self.words[: self.nparts * POINT_WORDS].view(self.nparts, 4, 10)


def launch_lanes(lib, packed: torch.Tensor, consts: torch.Tensor, codes_ptr: int,
                 work: Scratch, stream) -> None:
    """The lanes kernel over work.n rows in work.layout on ``stream``:
    codes at ``codes_ptr``, the partial points into ``work``. Raises when
    the launch is refused."""
    _check(lib, lib.ed25519_rlc_lanes_launch(packed.data_ptr(), work.n, consts.data_ptr(),
                                             codes_ptr, work.partials, work.ticket, work.layout,
                                             stream), "ed25519_rlc_lanes")


def launch_fold(lib, consts: torch.Tensor, eq_ptr: int, work: Scratch, stream) -> None:
    """The fold kernel over ``work``'s partial points on ``stream``: eq_ok
    at ``eq_ptr``. Raises when the launch is refused."""
    _check(lib, lib.ed25519_rlc_fold_launch(work.partials, work.nparts, consts.data_ptr(),
                                            work.level2, work.ticket, eq_ptr, work.fold_blocks,
                                            work.fold_threads, stream), "ed25519_rlc_fold")


def rlc_packed(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 161) uint8 rows -> (eq, (1,) uint8: 1 when the fold of the code-1
    residuals is the identity; codes, (B,) uint8), two views of one (B + 1,)
    tensor on the rows' device. CPU tensor: the plain version. CUDA tensor:
    both kernels, the lanes kernel in :func:`choose_layout`'s layout, on
    the current stream, without synchronising."""
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
    layout = choose_layout(n, split_wave_lanes(packed.device))
    consts = _device_consts(packed.device)
    work = Scratch(n, layout, packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        launch_lanes(lib, packed, consts, out.data_ptr(), work, stream)
        launches += 1
        layout_launches[layout] += 1
        launch_fold(lib, consts, out.data_ptr() + n, work, stream)
        fold_launches += 1
    return out[n:], out[:n]
