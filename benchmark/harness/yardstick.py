"""The frozen work of ed25519 verification and the H100's published
ceilings: the arithmetic of every roofline share the benchmark reports.

Copied from the port's ``ops/roofline.py`` and ``ops/cuda_verify.py`` as
they stood when the benchmark was written, and kept here so that a later
change to the kernel cannot change the yardstick: a share of the roofline
is the least time the card needs for the signatures verified, at this
work per signature, over the kernel's measured time. A kernel that does
less work per signature than this reads higher; one that does more, lower.

*Work.* One signature is K1's lane: 3,439 field multiplications, 1,550 of
them squarings (two decompressions, the double-scalar product and the
final encoding); a multiplication is 100 32x32->64-bit products, a
squaring 55, each product two int32 multiply-add issue slots. That is
548,300 slots a signature. It reads a 129-byte packed row and writes one
verdict bit.

*Ceilings.* An SM issues 64 int32 multiply-adds a clock; the H100 SXM has
132 SMs at a 1.98 GHz boost clock, and 3.35 TB/s of HBM3 (NVIDIA's data
sheet, at the full 700 W power limit).
"""

from __future__ import annotations

FIELD_MULS_PER_SIG = 2 * (12 + 262) + 1 + (4 * 8 + 3 * 8 + 8) + 8 + 64 * (4 * 8 + 8) + 32 * 8 + 2
FIELD_SQUARES_PER_SIG = 2 * 255 + (4 + 256) * 4
INT32_MULADD_SLOTS_PER_SIG = 2 * (100 * (FIELD_MULS_PER_SIG - FIELD_SQUARES_PER_SIG)
                                  + 55 * FIELD_SQUARES_PER_SIG)
BYTES_PER_SIG = 129 + 1 / 8

INT32_MULADD_PER_SM_CLOCK = 64
# name as torch.cuda.get_device_name prints it -> (SMs, boost clock Hz, HBM bytes/s)
CARDS = {
    "NVIDIA H100 80GB HBM3": (132, 1.98e9, 3.35e12),
}


def ceilings(card: str) -> tuple:
    """(int32 multiply-add slots per second, bytes per second) of a card
    the table knows; ValueError for any other."""
    if card not in CARDS:
        raise ValueError(f"no published ceilings for {card!r}")
    sms, clock, bw = CARDS[card]
    return sms * INT32_MULADD_PER_SM_CLOCK * clock, bw


def least_seconds(signatures: int, card: str) -> float:
    """The least time the card needs to verify ``signatures``: the larger
    of the issue-bound and the memory-bound time."""
    ops_s, bytes_s = ceilings(card)
    return max(signatures * INT32_MULADD_SLOTS_PER_SIG / ops_s, signatures * BYTES_PER_SIG / bytes_s)


def roofline_pct(signatures: int, kernel_seconds: float, card: str):
    """100 x least time / measured kernel time; None where nothing ran."""
    if signatures <= 0 or kernel_seconds <= 0:
        return None
    return 100.0 * least_seconds(signatures, card) / kernel_seconds
