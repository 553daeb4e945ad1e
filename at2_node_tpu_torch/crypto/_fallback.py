"""Dependency-free fallback crypto: ed25519, X25519, ChaCha20-Poly1305, HKDF.

``crypto/keys.py`` and ``net/transport.py`` prefer the ``cryptography``
wheel (OpenSSL) and fall back here when it is absent from the interpreter,
as it is on hosts that carry only the CUDA toolchain. Each is a straight
transcription of its RFC:

* ed25519 — RFC 8032 §5.1 (sign/verify over edwards25519, SHA-512), over
  python ints: slow (milliseconds per signature) but exact, and
  byte-for-byte the signatures OpenSSL makes;
* X25519 — RFC 7748 §5 (Montgomery ladder, clamped scalars);
* ChaCha20-Poly1305 — RFC 8439 (the cipher core is vectorized across
  blocks with numpy so large frames stay off the per-byte Python path);
* HKDF-SHA256 — RFC 5869 via stdlib hmac.

These are the algorithms OpenSSL implements, so a node built on this file
talks to an OpenSSL-built node byte for byte. The bulk verification path
is the batched GPU verifier (``ops/ed25519.py``), which never depends on
this file.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import struct

import numpy as np


class InvalidSignature(Exception):
    """Mirror of cryptography.exceptions.InvalidSignature."""


class InvalidTag(Exception):
    """Mirror of cryptography.exceptions.InvalidTag."""


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


# -- X25519 (RFC 7748 §5) -------------------------------------------------

_A24 = 121665


def _x25519_ladder(k: int, u: int) -> int:
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in reversed(range(255)):
        bit = (k >> t) & 1
        swap ^= bit
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = bit
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = u * z3 * z3 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return x2 * pow(z2, _P - 2, _P) % _P


def x25519(private: bytes, peer_public: bytes) -> bytes:
    k = int.from_bytes(private, "little")
    k &= (1 << 254) - 8
    k |= 1 << 254
    u = int.from_bytes(peer_public, "little") & ((1 << 255) - 1)
    out = _x25519_ladder(k, u)
    if out == 0:
        # RFC 7748 §6.1: an all-zero shared secret means the peer sent a
        # low-order point; OpenSSL's X25519 raises here, so must we
        # (transport.py turns this into HandshakeError)
        raise ValueError("x25519: low-order peer public key")
    return out.to_bytes(32, "little")


_X25519_BASE = (9).to_bytes(32, "little")


def x25519_public(private: bytes) -> bytes:
    return x25519(private, _X25519_BASE)


def x25519_generate_seed() -> bytes:
    return os.urandom(32)


# -- ChaCha20-Poly1305 AEAD (RFC 8439) ------------------------------------

_CHACHA_CONST = np.frombuffer(b"expa" b"nd 3" b"2-by" b"te k", dtype="<u4")


def _rotl(x, n):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _chacha_rounds(state: np.ndarray) -> np.ndarray:
    """20 ChaCha rounds over shape (16, nblocks) uint32 working state —
    all blocks of a message advance in lockstep (numpy vectorization is
    what keeps megabyte frames off the per-byte Python path)."""
    x = state.copy()

    def qr(a, b, c, d):
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    x += state
    return x


def _chacha20_stream(key: bytes, nonce: bytes, counter: int, n: int) -> bytes:
    """n bytes of keystream starting at the given block counter."""
    nblocks = (n + 63) // 64
    state = np.empty((16, nblocks), dtype=np.uint32)
    state[0:4] = _CHACHA_CONST[:, None]
    state[4:12] = np.frombuffer(key, dtype="<u4")[:, None]
    state[12] = np.arange(counter, counter + nblocks, dtype=np.uint64).astype(
        np.uint32
    )
    state[13:16] = np.frombuffer(nonce, dtype="<u4")[:, None]
    with np.errstate(over="ignore"):
        out = _chacha_rounds(state)
    # column-major: each block is one column of 16 words
    return out.T.astype("<u4").tobytes()[:n]


_POLY_P = (1 << 130) - 5


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i : i + 16]
        n = int.from_bytes(chunk, "little") + (1 << (8 * len(chunk)))
        acc = (acc + n) * r % _POLY_P
    return ((acc + s) % (1 << 128)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    rem = len(b) % 16
    return b"\x00" * (16 - rem) if rem else b""


class ChaCha20Poly1305:
    """Drop-in for cryptography.hazmat...aead.ChaCha20Poly1305."""

    def __init__(self, key: bytes) -> None:
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = key

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
        otk = _chacha20_stream(self._key, nonce, 0, 32)
        mac_data = (
            aad
            + _pad16(aad)
            + ct
            + _pad16(ct)
            + struct.pack("<QQ", len(aad), len(ct))
        )
        return _poly1305(otk, mac_data)

    def encrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        aad = aad or b""
        stream = _chacha20_stream(self._key, nonce, 1, len(data))
        ct = bytes(a ^ b for a, b in zip(data, stream)) if len(
            data
        ) < 64 else np.bitwise_xor(
            np.frombuffer(data, dtype=np.uint8),
            np.frombuffer(stream, dtype=np.uint8),
        ).tobytes()
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        if len(data) < 16:
            raise InvalidTag("ciphertext too short")
        aad = aad or b""
        ct, tag = data[:-16], data[-16:]
        if not _hmac.compare_digest(self._tag(nonce, ct, aad), tag):
            raise InvalidTag("poly1305 tag mismatch")
        stream = _chacha20_stream(self._key, nonce, 1, len(ct))
        if len(ct) < 64:
            return bytes(a ^ b for a, b in zip(ct, stream))
        return np.bitwise_xor(
            np.frombuffer(ct, dtype=np.uint8),
            np.frombuffer(stream, dtype=np.uint8),
        ).tobytes()


# -- HKDF-SHA256 (RFC 5869) -----------------------------------------------


def hkdf_sha256(ikm: bytes, salt: bytes, info: bytes, length: int) -> bytes:
    prk = _hmac.new(salt or b"\x00" * 32, ikm, hashlib.sha256).digest()
    out = b""
    t = b""
    counter = 1
    while len(out) < length:
        t = _hmac.new(prk, t + info + bytes([counter]), hashlib.sha256).digest()
        out += t
        counter += 1
    return out[:length]
