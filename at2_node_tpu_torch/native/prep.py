"""ctypes binding of the native batch prep (``at2_prep.cpp``).

Built with g++ on first use into the port's ``build/`` directory. When the
build fails (no compiler, read-only tree) :func:`native_available` is False
and ``ops.ed25519`` uses its Python prep instead.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from ._build import U64P, U8P, load_gxx_lib, pack_ragged, ptr8

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib = load_gxx_lib(["native/at2_prep.cpp"], "libat2prep.so")
        if lib is None:
            return None
        lib.at2_prep_packed.argtypes = [
            U8P, U64P, U8P, U64P, U8P, U64P,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, U8P,
        ]
        lib.at2_prep_packed.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def prep_packed_native(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    out: np.ndarray,
) -> None:
    """Fill every row of ``out`` ((bucket, 129) C-contiguous uint8): the
    packed prep of each item, then zero rows of padding. Same rows as
    ``ops.ed25519.pack_prepared(prepare_batch_py(...))``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native prep did not build; check native_available()")
    n = len(public_keys)
    if not (len(messages) == len(signatures) == n):
        raise ValueError("public_keys, messages and signatures differ in length")
    if out.dtype != np.uint8 or out.ndim != 2 or out.shape[1] != 129:
        raise ValueError(f"out must be (bucket, 129) uint8, got {out.dtype} {out.shape}")
    if not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be C-contiguous")
    if n > out.shape[0]:
        raise ValueError(f"batch of {n} exceeds bucket size {out.shape[0]}")
    pk_flat, pk_off = pack_ragged(public_keys)
    msg_flat, msg_off = pack_ragged(messages)
    sig_flat, sig_off = pack_ragged(signatures)
    lib.at2_prep_packed(
        ptr8(pk_flat), pk_off.ctypes.data_as(U64P),
        ptr8(msg_flat), msg_off.ctypes.data_as(U64P),
        ptr8(sig_flat), sig_off.ctypes.data_as(U64P),
        n, out.shape[0], os.cpu_count() or 1, ptr8(out),
    )
