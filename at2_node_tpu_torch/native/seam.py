"""ctypes binding of the CUDA verifier's native seam (``at2_seam.cpp``).

One :class:`Seam` a verifier: a native worker thread and a ring of job
slots that take a flush from host prep to K1's verdicts without Python
(``at2_seam.cpp``'s header says how). The event loop hands a flush over
with :meth:`Seam.submit`, one call that keeps the GIL (``ctypes.PyDLL``:
dropping it would hand it to another thread for up to a switch interval),
and learns of finished jobs through an eventfd read by a
``loop.add_reader`` callback, which takes them in submit order and calls
each job's ``done`` with a :class:`Completion`.

:func:`load_cuda` builds the library with nvcc (``at2_seam_cuda.cpp``, the
CUDA runtime) into the port's ``build/`` directory at first use, and
raises when it does not build, as K1's build does. :func:`load_host` builds the
host stand-in (``at2_seam_host.cpp``: copies as memcpy, K1 as the lane
math of ``csrc/ed25519_lane_host.cpp``) with g++, for the CPU tests.
"""

from __future__ import annotations

import array
import asyncio
import collections
import ctypes
import logging
import os
import subprocess
import threading
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np

from ._build import GXX, compile_lib

logger = logging.getLogger(__name__)

CUDA_SOURCES = ("native/at2_seam.cpp", "native/at2_seam_cuda.cpp")
HOST_SOURCES = ("native/at2_seam.cpp", "native/at2_seam_host.cpp", "csrc/ed25519_lane_host.cpp")
DEPENDS = ("native/at2_prep.h", "native/at2_seam_dev.h")
LIB_NAME = "libat2seam.so"
HOST_LIB_NAME = "libat2seam_host.so"
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC,-pthread")

ERR_CLOSED = -1


class SeamFull(RuntimeError):
    """Every slot of the ring holds a job the loop has not released."""


class _JobInfo(ctypes.Structure):
    _fields_ = [
        ("id", ctypes.c_int64), ("n", ctypes.c_int64),
        ("err", ctypes.c_int32), ("launched", ctypes.c_int32),
        ("t_submit", ctypes.c_int64), ("t_uploaded", ctypes.c_int64), ("t_launched", ctypes.c_int64),
        ("t_done", ctypes.c_int64), ("bits", ctypes.c_void_p),
    ]


class Completion(NamedTuple):
    """A finished job: its verdicts (None when it failed) or its error,
    whether K1 was launched for it, and the worker's stamps in seconds on
    ``time.monotonic()``'s clock: handed over, rows uploaded (prep and the
    copy queued), K1 and the copy back queued, the device done."""

    verdicts: Optional[np.ndarray]
    error: Optional[BaseException]
    launched: bool
    t_submit: float
    t_uploaded: float
    t_launched: float
    t_done: float


class SeamLib:
    """The loaded library. The calls that may wait (create, destroy, the
    stand-in's hooks) go through ``CDLL``, which drops the GIL; the loop's
    own calls through ``PyDLL``, which keeps it."""

    def __init__(self, path: str) -> None:
        c, py = ctypes.CDLL(path), ctypes.PyDLL(path)
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        self.create = c.at2_seam_create
        self.create.argtypes = [ctypes.c_int, ctypes.c_int, i64, vp, vp, vp, vp,
                                ctypes.POINTER(ctypes.c_int)]
        self.create.restype = vp
        self.destroy = c.at2_seam_destroy
        self.destroy.argtypes = [vp]
        self.destroy.restype = None
        self.fd = py.at2_seam_fd
        self.fd.argtypes = [vp]
        self.fd.restype = ctypes.c_int
        self.submit = py.at2_seam_submit
        self.submit.argtypes = [vp, ctypes.c_char_p, vp, ctypes.c_char_p, vp, ctypes.c_char_p, vp, i64, i64]
        self.submit.restype = i64
        self.poll = py.at2_seam_poll
        self.poll.argtypes = [vp, ctypes.POINTER(_JobInfo)]
        self.poll.restype = ctypes.c_int
        self.release = py.at2_seam_release
        self.release.argtypes = [vp]
        self.release.restype = None
        self.shutdown = py.at2_seam_shutdown
        self.shutdown.argtypes = [vp]
        self.shutdown.restype = None
        self.error_string = py.at2_seam_error_string
        self.error_string.argtypes = [ctypes.c_int]
        self.error_string.restype = ctypes.c_char_p
        self.launches = py.at2_seam_launches
        self.launches.argtypes = [vp]
        self.launches.restype = i64
        self.threads_started = py.at2_seam_threads_started
        self.threads_started.argtypes = []
        self.threads_started.restype = i64
        self.cdll = c


_lock = threading.Lock()
_cuda: Optional[SeamLib] = None
build_log = ""  # nvcc's output from the build of this process, if it built


def load_cuda() -> SeamLib:
    """Build (unless fresh) and load the CUDA seam. Raises RuntimeError
    with nvcc's output when the build fails, as ``cuda_verify.build``
    does for K1, built by the same nvcc."""
    global _cuda, build_log
    with _lock:
        if _cuda is not None:
            return _cuda
        from ..ops.cuda_verify import _nvcc

        try:
            path, build_log = compile_lib((_nvcc(), *NVCC_FLAGS), CUDA_SOURCES, LIB_NAME, DEPENDS)
        except subprocess.CalledProcessError as exc:
            raise RuntimeError(f"nvcc failed on the native seam:\n{exc.stdout}\n{exc.stderr}") from exc
        except OSError as exc:
            raise RuntimeError(f"nvcc not found ({exc})") from exc
        _cuda = SeamLib(path)
        return _cuda


def load_host() -> SeamLib:
    """Build (unless fresh) and load the host stand-in. Raises when g++
    fails."""
    path, _ = compile_lib(GXX, HOST_SOURCES, HOST_LIB_NAME, (*DEPENDS, "csrc/ed25519_lane.cuh"))
    return SeamLib(path)


def _flat(chunks: Sequence[bytes]):
    return b"".join(chunks), array.array("I", map(len, chunks))


class Seam:
    """One verifier's native worker and ring of ``depth`` job slots of up
    to ``max_rows`` rows. ``k1`` is the address of
    ``ed25519_verify_launch`` (or the stand-in's), ``consts`` the address
    of its constants; ``copy_stream`` and ``compute_stream`` are raw
    stream handles. Construct off the loop (allocation and the worker's
    start), then :meth:`attach` on it."""

    def __init__(self, lib: SeamLib, *, device_index: int, depth: int, max_rows: int,
                 copy_stream: int, compute_stream: int, k1: int, consts: int) -> None:
        self.lib = lib
        self.depth = depth
        self.max_rows = max_rows
        err = ctypes.c_int(0)
        self._h = lib.create(device_index, depth, max_rows, copy_stream, compute_stream, k1, consts,
                             ctypes.byref(err))
        if not self._h:
            raise RuntimeError(f"native seam not created: {lib.error_string(err.value).decode()}")
        self._fd = lib.fd(self._h)
        self._info = _JobInfo()
        self._launches_seen = 0
        self._pending: collections.deque = collections.deque()  # (job id, done)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._drained: Optional[asyncio.Future] = None
        self._closing = False

    def attach(self, loop: asyncio.AbstractEventLoop) -> None:
        """Read completions on ``loop`` from now on."""
        self._loop = loop
        loop.add_reader(self._fd, self._on_ready)

    def take_launches(self) -> int:
        """K1 launches the worker made since the last take: it counts each
        as the launch returns, whether its job then completes or fails."""
        n = self.lib.launches(self._h)
        grown, self._launches_seen = n - self._launches_seen, n
        return grown

    def submit(self, pks: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes], bucket: int,
               done: Callable[[Completion], None]) -> None:
        """Hand one flush to the worker; ``done`` runs on the loop once it
        finished. Raises :class:`SeamFull` when every slot is taken."""
        if self._closing:
            raise RuntimeError("verifier closed")
        pk, pk_lens = _flat(pks)
        msg, msg_lens = _flat(msgs)
        sig, sig_lens = _flat(sigs)
        job = self.lib.submit(self._h, pk, pk_lens.buffer_info()[0], msg, msg_lens.buffer_info()[0],
                              sig, sig_lens.buffer_info()[0], len(pks), bucket)
        if job == -1:
            raise SeamFull(f"all {self.depth} slots of the native seam are taken")
        if job == -2:
            raise RuntimeError("verifier closed")
        if job < 0:
            raise ValueError(f"a flush of {len(pks)} in a bucket of {bucket} does not fit "
                             f"slots of {self.max_rows} rows")
        self._pending.append((job, done))

    def _on_ready(self) -> None:
        try:
            os.read(self._fd, 8)
        except BlockingIOError:
            pass
        info, lib, h = self._info, self.lib, self._h
        while self._pending and lib.poll(h, ctypes.byref(info)):
            n, err = info.n, info.err
            verdicts, error = None, None
            if err:
                error = RuntimeError(
                    "verifier closed" if err == ERR_CLOSED
                    else f"ed25519_verify job failed: {lib.error_string(err).decode()}")
            else:
                verdicts = np.unpackbits(
                    np.frombuffer(ctypes.string_at(info.bits, (n + 7) // 8), np.uint8), count=n
                ).astype(bool)
            c = Completion(verdicts, error, bool(info.launched), 1e-9 * info.t_submit,
                           1e-9 * info.t_uploaded, 1e-9 * info.t_launched, 1e-9 * info.t_done)
            job, done = self._pending.popleft()
            assert job == info.id, (job, info.id)
            lib.release(h)
            try:
                done(c)
            except Exception:
                logger.exception("native seam completion of job %d raised", job)
        if self._closing and not self._pending and self._drained is not None and not self._drained.done():
            self._drained.set_result(None)

    async def close(self) -> None:
        """Take no more jobs; jobs queued and not started complete as
        failed ("verifier closed"), those running as they would. Once
        every job's ``done`` ran, the worker is joined and the slots
        freed."""
        if self._h is None:
            return
        self._closing = True
        self.lib.shutdown(self._h)
        if self._pending and self._loop is not None:
            self._drained = self._loop.create_future()
            self._on_ready()
            if self._pending:
                await self._drained
        if self._loop is not None:
            self._loop.remove_reader(self._fd)
        h, self._h = self._h, None
        self.lib.destroy(h)
