"""Dependency-free ed25519 (RFC 8032 §5.1): sign, verify, keys.

``crypto/keys.py`` prefers the ``cryptography`` wheel (OpenSSL) and falls
back here when it is absent from the interpreter, as it is on hosts that
carry only the CUDA toolchain. A straight transcription of the RFC over
python ints: slow (milliseconds per signature) but exact, and byte-for-byte
the signatures OpenSSL makes. The bulk verification path is the batched
GPU verifier (``ops/ed25519.py``), which never depends on this file.
"""

from __future__ import annotations

import hashlib
import os


class InvalidSignature(Exception):
    """Mirror of cryptography.exceptions.InvalidSignature."""


# -- edwards25519 field / group (RFC 8032 §5.1) ---------------------------

_P = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493
_D = (-121665 * pow(121666, _P - 2, _P)) % _P
_I = pow(2, (_P - 1) // 4, _P)  # sqrt(-1)

_BY = 4 * pow(5, _P - 2, _P) % _P


def _recover_x(y: int, sign: int) -> int:
    if y >= _P:
        raise InvalidSignature("y out of range")
    x2 = (y * y - 1) * pow(_D * y * y + 1, _P - 2, _P) % _P
    if x2 == 0:
        if sign:
            raise InvalidSignature("bad point")
        return 0
    x = pow(x2, (_P + 3) // 8, _P)
    if (x * x - x2) % _P != 0:
        x = x * _I % _P
    if (x * x - x2) % _P != 0:
        raise InvalidSignature("not a square")
    if x & 1 != sign:
        x = _P - x
    return x


_BX = _recover_x(_BY, 0)
# extended homogeneous coordinates (X, Y, Z, T), RFC 8032 §5.1.4
_BASE = (_BX, _BY, 1, _BX * _BY % _P)
_IDENT = (0, 1, 1, 0)


def _pt_add(p, q):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % _P
    B = (Y1 + X1) * (Y2 + X2) % _P
    C = 2 * T1 * T2 * _D % _P
    Dv = 2 * Z1 * Z2 % _P
    E, F, G, H = B - A, Dv - C, Dv + C, B + A
    return (E * F % _P, G * H % _P, F * G % _P, E * H % _P)


def _pt_mul(s: int, p):
    q = _IDENT
    while s > 0:
        if s & 1:
            q = _pt_add(q, p)
        p = _pt_add(p, p)
        s >>= 1
    return q


def _pt_equal(p, q) -> bool:
    # cross-multiply out the projective Z factors
    return (
        (p[0] * q[2] - q[0] * p[2]) % _P == 0
        and (p[1] * q[2] - q[1] * p[2]) % _P == 0
    )


def _pt_compress(p) -> bytes:
    zinv = pow(p[2], _P - 2, _P)
    x, y = p[0] * zinv % _P, p[1] * zinv % _P
    return ((y | ((x & 1) << 255))).to_bytes(32, "little")


def _pt_decompress(b: bytes):
    if len(b) != 32:
        raise InvalidSignature("bad point length")
    n = int.from_bytes(b, "little")
    sign = n >> 255
    y = n & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    return (x, y, 1, x * y % _P)


def _sha512_int(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


def _clamp(h32: bytes) -> int:
    a = int.from_bytes(h32, "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def ed25519_public(seed: bytes) -> bytes:
    a = _clamp(hashlib.sha512(seed).digest()[:32])
    return _pt_compress(_pt_mul(a, _BASE))


def ed25519_sign(seed: bytes, message: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h[:32])
    prefix = h[32:]
    A = _pt_compress(_pt_mul(a, _BASE))
    r = _sha512_int(prefix, message) % _L
    R = _pt_compress(_pt_mul(r, _BASE))
    k = _sha512_int(R, A, message) % _L
    s = (r + k * a) % _L
    return R + s.to_bytes(32, "little")


def ed25519_verify(public: bytes, message: bytes, signature: bytes) -> None:
    """Raises InvalidSignature on failure (cryptography-style contract)."""
    if len(signature) != 64:
        raise InvalidSignature("bad signature length")
    A = _pt_decompress(public)
    R = _pt_decompress(signature[:32])
    s = int.from_bytes(signature[32:], "little")
    if s >= _L:
        raise InvalidSignature("non-canonical s")
    k = _sha512_int(signature[:32], public, message) % _L
    if not _pt_equal(_pt_mul(s, _BASE), _pt_add(R, _pt_mul(k, A))):
        raise InvalidSignature("signature mismatch")


def ed25519_generate_seed() -> bytes:
    return os.urandom(32)

