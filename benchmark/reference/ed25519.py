"""Plain ed25519 verification: RFC 8032 section 5.1.7 over Python ints.

The benchmark's reference for every verdict it judges. It imports nothing
but ``hashlib``: not the program, not its kernels, not OpenSSL. It is slow
(a few ms a signature) and exact.

:func:`verify` is the guarantee the configurations state: strict decoding
(a y of p or more, or x = 0 with the sign bit set, is refused; so is an S
of L or more) and the cofactorless equation [S]B = R + [k]A.
``cofactored=True`` checks [8][S]B = [8]R + [8][k]A instead: the control
that breaks the cofactorless guarantee, which accepts a signature whose R
or A carries a small-order component.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# points are extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, xy = T/Z
IDENTITY = (0, 1, 1, 0)


def _recover_x(y: int, sign: int):
    """The x of y on the curve with the given sign bit, or None."""
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BY = 4 * pow(5, P - 2, P) % P
_BX = _recover_x(_BY, 0)
BASE = (_BX, _BY, 1, _BX * _BY % P)


def add(p1, p2):
    """Point addition (RFC 8032 section 5.1.4)."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def mul(s: int, p):
    q = IDENTITY
    while s:
        if s & 1:
            q = add(q, p)
        p = add(p, p)
        s >>= 1
    return q


def equal(p1, p2) -> bool:
    x1, y1, z1, _ = p1
    x2, y2, z2, _ = p2
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def encode(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decode(s: bytes):
    """The point a 32-byte encoding names, or None (RFC 8032 5.1.3)."""
    if len(s) != 32:
        return None
    n = int.from_bytes(s, "little")
    y, sign = n & ((1 << 255) - 1), n >> 255
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def challenge(r_enc: bytes, a_enc: bytes, message: bytes) -> int:
    return int.from_bytes(hashlib.sha512(r_enc + a_enc + message).digest(), "little") % L


def verify(public_key: bytes, message: bytes, signature: bytes, cofactored: bool = False) -> bool:
    """RFC 8032 verification of one signature; ``cofactored`` selects the
    [8]-multiplied equation (the control)."""
    if len(public_key) != 32 or len(signature) != 64:
        return False
    a = decode(public_key)
    r = decode(signature[:32])
    if a is None or r is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    k = challenge(signature[:32], public_key, message)
    lhs = mul(s, BASE)
    rhs = add(r, mul(k, a))
    if cofactored:
        lhs, rhs = mul(8, lhs), mul(8, rhs)
    return equal(lhs, rhs)


# -- key derivation and signing (RFC 8032 5.1.5-5.1.6), for test vectors ---


def secret_scalar(seed: bytes) -> int:
    h = bytearray(hashlib.sha512(seed).digest()[:32])
    h[0] &= 248
    h[31] &= 127
    h[31] |= 64
    return int.from_bytes(h, "little")


def public_key(seed: bytes) -> bytes:
    return encode(mul(secret_scalar(seed), BASE))


def sign(seed: bytes, message: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = secret_scalar(seed)
    a_enc = encode(mul(a, BASE))
    r = int.from_bytes(hashlib.sha512(h[32:] + message).digest(), "little") % L
    r_enc = encode(mul(r, BASE))
    s = (r + challenge(r_enc, a_enc, message) * a) % L
    return r_enc + s.to_bytes(32, "little")


def torsion_point():
    """A point of order 8: [L] of a curve point outside the prime-order
    subgroup, the first such from y = 2 upwards."""
    y = 2
    while True:
        x = _recover_x(y, 0)
        if x is not None:
            t = mul(L, (x, y, 1, x * y % P))
            if not equal(mul(4, t), IDENTITY):
                return t
        y += 1
