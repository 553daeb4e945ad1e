"""ctypes binding for the native RLC batch-verification engine.

Counterpart of ``at2_node_tpu/native/rlc.py``.

`at2_rlc.cpp` does the curve arithmetic (decompress, Pippenger MSMs,
randomized torsion rounds, exact [L]P certification); this module owns
the scalar side — per-batch random 128-bit ``z_i`` and the mod-L
products ``z_i*h_i`` / ``z_i*s_i`` as python bigints — and the
build/kick lifecycle, mirroring `ingest.py` (host C++ built with g++,
no device code): never compile on the event
loop, kick a daemon-thread build on first probe and fall back to the
per-signature path until the library is ready.

The verification-relevant outputs:

* :func:`rlc_check` — one RLC equation + k torsion rounds over prepared
  lanes; returns the batch verdict plus a per-lane decompress mask
  (undecompressable lanes are individually invalid, never batch-fatal).
* :func:`certify_keys` — exact [L]A verdict per public key, cached by
  the verifier so the per-key cost amortizes to ~0 across flushes.

Soundness parameters: ``Z_BITS = 128`` random linear coefficients bound
the prime-subgroup forgery probability by 2^-124 (matching
ops/aggregate.py); ``TORSION_ROUNDS = 64`` randomized subset rounds
bound the small-order miss probability by 2^-64 (each round halves the
survival odds of any lane whose R carries a torsion component; see the
soundness argument in TECHNICAL.md).
"""

from __future__ import annotations

import ctypes
import secrets
import threading
from typing import Optional, Sequence

import numpy as np

from ._build import U8P, load_gxx_lib

Z_BITS = 128
TORSION_ROUNDS = 64

L = 2**252 + 27742317777372353535851937790883648493

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib = load_gxx_lib(["native/at2_rlc.cpp"], "libat2rlc.so")
        if lib is None:
            return None
        lib.at2_rlc_selftest.restype = ctypes.c_int
        lib.at2_rlc_certify.restype = None
        lib.at2_rlc_certify.argtypes = [U8P, ctypes.c_uint64, U8P]
        lib.at2_rlc_verify.restype = ctypes.c_int
        lib.at2_rlc_verify.argtypes = [
            U8P, U8P, U8P, U8P, U8P, U8P, U8P,
            ctypes.c_uint64, ctypes.c_uint64, U8P,
        ]
        lib.at2_rlc_scalarmul.restype = ctypes.c_int
        lib.at2_rlc_scalarmul.argtypes = [U8P, U8P, U8P]
        lib.at2_rlc_decompress_check.restype = ctypes.c_int
        lib.at2_rlc_decompress_check.argtypes = [U8P]
        if lib.at2_rlc_selftest() != 0:
            return None
        _lib = lib
        return _lib


def rlc_available() -> bool:
    """Build (if needed), load, and selftest the engine. Blocking."""
    return _load() is not None


def rlc_ready() -> bool:
    """True only when the library is already loaded — never builds."""
    return _lib is not None


_build_kicked = False


def kick_rlc_build() -> None:
    """Start build/load on a daemon thread (once), same contract as
    `ingest.kick_ingest_build`: the caller takes the per-sig path now and
    converges to RLC once the build lands."""
    global _build_kicked
    if _build_kicked or _tried:
        return
    _build_kicked = True
    threading.Thread(
        target=rlc_available, daemon=True, name="at2-rlc-build"
    ).start()


def rlc_ready_or_kick() -> bool:
    if rlc_ready():
        return True
    kick_rlc_build()
    return False


def _as_rows(buf: np.ndarray | Sequence[bytes], n: int) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(buf, dtype=np.uint8)).reshape(n, 32)
    return a


def certify_keys(pks: Sequence[bytes] | np.ndarray) -> np.ndarray:
    """Exact subgroup certification per public key.

    Returns uint8 verdicts: 0 = bad encoding, 1 = decompresses but
    carries torsion, 2 = certified torsion-free. Lanes with verdict < 2
    must be verified on the exact per-signature path (certification
    reroutes; it never flips a verdict).
    """
    lib = _load()
    assert lib is not None, "call rlc_available() first"
    if isinstance(pks, np.ndarray):
        n = pks.shape[0]
        flat = np.ascontiguousarray(pks, dtype=np.uint8).reshape(n, 32)
    else:
        n = len(pks)
        flat = np.frombuffer(b"".join(pks), dtype=np.uint8).reshape(n, 32)
    out = np.zeros(n, dtype=np.uint8)
    if n:
        lib.at2_rlc_certify(
            flat.ctypes.data_as(U8P), ctypes.c_uint64(n),
            out.ctypes.data_as(U8P),
        )
    return out


def make_scalars(
    s_le: np.ndarray, h_le: np.ndarray, *, z_override: Sequence[int] | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random z plus the derived mod-L products, as (n, 32) LE rows.

    ``s_le``/``h_le``: (n, 32) uint8 rows from ``ops.ed25519.prepare_batch``
    (s canonical-checked there; h already reduced mod L).
    Returns (z_rows, zh_rows, zs_rows) for the native call.
    """
    n = s_le.shape[0]
    z_rows = np.zeros((n, 32), dtype=np.uint8)
    zh_rows = np.zeros((n, 32), dtype=np.uint8)
    zs_rows = np.zeros((n, 32), dtype=np.uint8)
    s_bytes = np.ascontiguousarray(s_le, dtype=np.uint8)
    h_bytes = np.ascontiguousarray(h_le, dtype=np.uint8)
    for i in range(n):
        if z_override is not None:
            z = int(z_override[i])
        else:
            z = secrets.randbits(Z_BITS) | 1
        h = int.from_bytes(h_bytes[i].tobytes(), "little")
        s = int.from_bytes(s_bytes[i].tobytes(), "little")
        z_rows[i] = np.frombuffer(z.to_bytes(32, "little"), dtype=np.uint8)
        zh_rows[i] = np.frombuffer(
            (z * h % L).to_bytes(32, "little"), dtype=np.uint8
        )
        zs_rows[i] = np.frombuffer(
            (z * s % L).to_bytes(32, "little"), dtype=np.uint8
        )
    return z_rows, zh_rows, zs_rows


def rlc_check(
    r_rows: np.ndarray,
    a_rows: np.ndarray,
    s_le: np.ndarray,
    h_le: np.ndarray,
    valid: np.ndarray,
    *,
    k_rounds: int = TORSION_ROUNDS,
    z_override: Sequence[int] | None = None,
) -> tuple[bool, np.ndarray]:
    """One RLC check over the lanes with ``valid``.

    Returns ``(batch_ok, decomp_ok)``: when ``batch_ok`` the equation and
    every torsion round passed for all valid lanes that decompressed
    (those lanes are verified); lanes with ``decomp_ok[i] == False`` are
    individually invalid regardless of the batch verdict. When
    ``batch_ok`` is False at least one decompressable lane is bad (or a
    torsion round tripped) — callers bisect.
    """
    lib = _load()
    assert lib is not None, "call rlc_available() first"
    n = int(valid.shape[0])
    decomp_ok = np.ones(n, dtype=np.uint8)
    if n == 0 or not valid.any():
        return True, decomp_ok.astype(bool)
    r_c = _as_rows(r_rows, n)
    a_c = _as_rows(a_rows, n)
    z_rows, zh_rows, zs_rows = make_scalars(
        _as_rows(s_le, n), _as_rows(h_le, n), z_override=z_override
    )
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    tors = np.frombuffer(
        secrets.token_bytes(k_rounds * n), dtype=np.uint8
    ) & np.uint8(7)
    tors = np.ascontiguousarray(tors)
    ok = lib.at2_rlc_verify(
        r_c.ctypes.data_as(U8P),
        a_c.ctypes.data_as(U8P),
        z_rows.ctypes.data_as(U8P),
        zh_rows.ctypes.data_as(U8P),
        zs_rows.ctypes.data_as(U8P),
        valid_u8.ctypes.data_as(U8P),
        tors.ctypes.data_as(U8P),
        ctypes.c_uint64(k_rounds),
        ctypes.c_uint64(n),
        decomp_ok.ctypes.data_as(U8P),
    )
    return bool(ok), decomp_ok.astype(bool)


def scalarmul(enc: bytes, k: int) -> Optional[bytes]:
    """[k]P on a compressed point (test hook); None on bad encoding."""
    lib = _load()
    assert lib is not None, "call rlc_available() first"
    p = np.frombuffer(enc, dtype=np.uint8).copy()
    sc = np.frombuffer(
        (k % (1 << 256)).to_bytes(32, "little"), dtype=np.uint8
    ).copy()
    out = np.zeros(32, dtype=np.uint8)
    if not lib.at2_rlc_scalarmul(
        p.ctypes.data_as(U8P), sc.ctypes.data_as(U8P), out.ctypes.data_as(U8P)
    ):
        return None
    return out.tobytes()


def decompress_check(enc: bytes) -> bool:
    """RFC 8032 decompression verdict alone (test hook)."""
    lib = _load()
    assert lib is not None, "call rlc_available() first"
    p = np.frombuffer(enc, dtype=np.uint8).copy()
    return bool(lib.at2_rlc_decompress_check(p.ctypes.data_as(U8P)))
