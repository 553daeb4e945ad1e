"""ctypes binding for the native channel reader (at2_ingest.cpp).

Counterpart of ``at2_node_tpu/native/reader.py``.

One C++ thread per inbound mesh connection owns the socket reads, the
per-frame ChaCha20-Poly1305 decryption, and frame assembly; Python is
woken through a pipe ONCE per batch of frames instead of once per frame
— the event-loop wakeup collapse that the reference's end-to-end profiling
identified as the message plane's asyncio floor. Decrypted frames then
enter the existing `Broadcast.on_frame` path (inbox byte budget, native
chunk parsing, catchup plane — all unchanged).

The reader serves the responder role only: in the mesh's
one-connection-per-ordered-pair design (`net/peers.py`), inbound
connections are read-only, so the fd can be handed to the C++ thread
wholesale after the (rare, Python-side) handshake.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

from ._build import U64P, ptr8
from .ingest import _load

# Queue/copy-out sizing: matches kReaderQueueBytes' spirit — one take()
# drains up to this much; the C++ queue holds at most 32 MiB.
TAKE_BUF_BYTES = 4 * 1024 * 1024
TAKE_MAX_FRAMES = 4096

STATUS_OPEN = 0
STATUS_EOF = 1
STATUS_PROTOCOL_ERROR = 2

_bound = False


def _lib_with_reader():
    global _bound
    lib = _load()
    if lib is None:
        return None
    if not _bound:
        lib.at2_reader_start.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.at2_reader_start.restype = ctypes.c_void_p
        lib.at2_reader_take.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            U64P, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.at2_reader_take.restype = ctypes.c_int64
        lib.at2_reader_stop.argtypes = [ctypes.c_void_p]
        lib.at2_reader_stop.restype = None
        _bound = True
    return lib


def reader_default_on() -> bool:
    """Host-shape heuristic: reader threads need a core to land on. The
    reference's A/B on a 1-core host (its ``BENCH_E2E.json``) measured a
    PENALTY in the multi-process shape: with nowhere to run, the C++
    threads only add context switching. Multi-core hosts (the deployment
    target: at2-node sizes its plane to `num_cpus`,
    at2-node/src/bin/server/rpc.rs:125) keep the reader ON."""
    try:
        # cores this process may actually RUN on (cgroup/affinity aware;
        # a 1-cpu container on a 64-core host must read as 1)
        count = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # non-Linux fallback
        count = os.cpu_count() or 0
    return count > 1


def reader_available() -> bool:
    if os.environ.get("AT2_NO_NATIVE_READER"):
        return False  # kill-switch (A/B benchmarking / incident triage)
    if not reader_default_on() and not os.environ.get(
        "AT2_FORCE_NATIVE_READER"
    ):
        return False  # 1-core host: asyncio plane measured faster
    return _lib_with_reader() is not None


class NativeChannelReader:
    """Owns one inbound connection's read side from handshake to close."""

    def __init__(self, fd: int, recv_key: bytes, wake_write_fd: int) -> None:
        assert len(recv_key) == 32
        lib = _lib_with_reader()
        assert lib is not None, "call reader_available() first"
        self._lib = lib
        key = (ctypes.c_uint8 * 32).from_buffer_copy(recv_key)
        self._handle: Optional[int] = lib.at2_reader_start(
            fd, key, wake_write_fd
        )
        self._buf = np.empty(TAKE_BUF_BYTES, dtype=np.uint8)
        self._offsets = np.empty(TAKE_MAX_FRAMES + 1, dtype=np.uint64)

    def take(self) -> Tuple[List[bytes], int, int]:
        """Drain queued frames: (frames, status, drops). Call repeatedly
        until it returns no frames (more may fit than one buffer)."""
        status = ctypes.c_int32(0)
        drops = ctypes.c_uint64(0)
        buf = self._buf
        while True:
            n = int(
                self._lib.at2_reader_take(
                    self._handle,
                    ptr8(buf),
                    buf.size,
                    self._offsets.ctypes.data_as(U64P),
                    TAKE_MAX_FRAMES,
                    ctypes.byref(status),
                    ctypes.byref(drops),
                )
            )
            if n >= 0:
                break
            # next frame alone exceeds the buffer (frames can be up to
            # transport.MAX_FRAME): use a TEMPORARY buffer for this take
            # so one oversized frame doesn't pin ~16 MiB per connection
            # for the rest of its life
            buf = np.empty(-n, dtype=np.uint8)
        offs = self._offsets[: n + 1].tolist()
        frames = [buf[offs[i] : offs[i + 1]].tobytes() for i in range(n)]
        return frames, int(status.value), int(drops.value)

    def stop(self) -> None:
        """Stop the thread and free the native state (idempotent); the
        caller still owns and closes the fd + pipe afterwards."""
        if self._handle is not None:
            self._lib.at2_reader_stop(self._handle)
            self._handle = None
