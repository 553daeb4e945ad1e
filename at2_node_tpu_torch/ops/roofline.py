"""Roofline model of the verify kernels on a Hopper card.

Counterpart of ``at2_node_tpu/ops/roofline.py``, rebuilt for the port's
kernels: it answers "actually fast, or just correct?" for K1
(``csrc/ed25519_verify.cu``) and the RLC kernels (``csrc/ed25519_rlc.cu``)
from their own counts, not the TPU kernel's.

*Work.* Both kernels are int32 multiply-add issue: a field multiplication
is 100 32x32->64-bit products (IMAD.WIDE, two issue slots each), a
squaring 55. ``ops/cuda_verify.py`` and ``ops/cuda_rlc.py`` count a lane's
multiplications and squarings once per lane (the quad's repeated work is
not charged), and ``tests/test_torch_kernel_host.py`` holds those counts to
the g++ build of the kernels' math. The tensor cores play no part.

*Bytes.* K1 reads a 129-byte packed row a lane and writes one verdict
bit; the RLC lanes kernel reads a 161-byte row and writes a code byte a
lane and its partial points; every launch also reads the kernels'
constants (``cuda_verify.lane_consts``).

*Ceilings.* The SM issues 64 int32 multiply-adds a clock (half its 128
float32 lanes); the card's SM count comes from the device's properties.
A card this module has no published clock and memory rate for raises
rather than being scored against an H100's.

:func:`bound_ms` and :func:`rlc_bounds` are the least time of one launch
(the larger of bytes over the memory rate and issue slots over the issue
rate), the ``bound_ms`` of ``chip_smoke.py``'s kernels line.
:func:`model` and :func:`model_rlc` score a measured device-only rate,
with the reference's keys where they mean the same thing; where the
reference counts VPU int32 operations this model counts int32
multiply-add issue slots, and its keys say ``int32_muladd``.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import cuda_rlc, cuda_verify

# ---- the cards this model has ceilings for (published figures) --------
# name as torch.cuda.get_device_name / nvidia-smi print it ->
# (boost clock in Hz, memory bytes per second)
CARDS = {
    "NVIDIA H100 80GB HBM3": (1.98e9, 3.35e12),  # H100 SXM5, HBM3
}
INT32_MULADD_PER_SM_CLOCK = 64

# ---- per-lane work ----------------------------------------------------
PACKED_ROW_BYTES = 129
RLC_ROW_BYTES = 161
POINT_BYTES = 4 * cuda_rlc.POINT_WORDS  # one int32 extended point
FMUL_PER_SIG = cuda_verify.FIELD_MULS_PER_LANE
INT32_MULADD_SLOTS_PER_SIG = cuda_verify.INT32_MULADD_SLOTS_PER_LANE
BYTES_PER_SIG = PACKED_ROW_BYTES + 1 / 8  # row in, verdict bit out
RLC_FMUL_PER_SIG = cuda_rlc.FIELD_MULS_PER_LANE[cuda_rlc.WHOLE]
RLC_INT32_MULADD_SLOTS_PER_SIG = cuda_rlc.INT32_MULADD_SLOTS_PER_LANE[cuda_rlc.WHOLE]
RLC_BYTES_PER_SIG = RLC_ROW_BYTES + 1  # row in, code byte out


def const_bytes() -> int:
    """The constants every verify and lanes launch reads."""
    return 4 * len(cuda_verify.lane_consts())


@dataclass(frozen=True)
class Card:
    """One card's ceilings."""

    name: str
    sm_count: int
    clock_hz: float
    bytes_per_s: float

    @property
    def int32_muladd_per_s(self) -> float:
        return self.sm_count * INT32_MULADD_PER_SM_CLOCK * self.clock_hz


def ceilings(name: str, sm_count: int) -> Card:
    """The ceilings of the card called ``name`` with ``sm_count`` SMs;
    raises ValueError for a card with no entry in :data:`CARDS`."""
    if name not in CARDS:
        raise ValueError(f"no roofline ceilings for {name!r} (known: {sorted(CARDS)})")
    clock_hz, bytes_per_s = CARDS[name]
    return Card(name, int(sm_count), clock_hz, bytes_per_s)


def card_of(device=None) -> Card:
    """The ceilings of a CUDA device (default cuda:0), its SM count read
    from its properties."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"the roofline scores a CUDA device, not {dev}")
    props = torch.cuda.get_device_properties(dev)
    return ceilings(props.name, props.multi_processor_count)


def _least_ms(card: Card, ops: float, nbytes: float) -> tuple[float, str]:
    ops_s, bytes_s = ops / card.int32_muladd_per_s, nbytes / card.bytes_per_s
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes")


def bound_ms(n: int, card: Card) -> tuple[float, str]:
    """K1 on n lanes: (least ms, "operations" or "bytes")."""
    nbytes = n * PACKED_ROW_BYTES + (n + 7) // 8 + const_bytes()
    return _least_ms(card, n * INT32_MULADD_SLOTS_PER_SIG, nbytes)


def rlc_bounds(n: int, nparts: int, card: Card) -> dict:
    """The least time of each RLC kernel on n lanes that leave ``nparts``
    partial points. The lanes kernel reads each row and the constants and
    writes a code a lane and the partials, and does every lane's
    operations (the whole layout's count, the function's least) and the
    n - nparts additions of its block trees; the fold reads the partials,
    writes eq_ok and its final point, and does nparts - 1 additions."""
    add = cuda_rlc.INT32_MULADD_SLOTS_PER_FOLD_ADD
    return {
        "ed25519_rlc_lanes": _least_ms(
            card, n * RLC_INT32_MULADD_SLOTS_PER_SIG + (n - nparts) * add,
            n * RLC_ROW_BYTES + n + nparts * POINT_BYTES + const_bytes()),
        "ed25519_rlc_fold": _least_ms(card, (nparts - 1) * add, nparts * POINT_BYTES + 1 + 40),
    }


def _rates(card: Card, slots: int, nbytes: float) -> tuple[float, float]:
    return card.int32_muladd_per_s / slots, card.bytes_per_s / nbytes


def model(device_only_sigs_per_sec: float, card: Card) -> dict:
    """Roofline summary of K1 at a measured device-only verify rate."""
    achieved = device_only_sigs_per_sec * INT32_MULADD_SLOTS_PER_SIG
    op_rate, hbm_rate = _rates(card, INT32_MULADD_SLOTS_PER_SIG, BYTES_PER_SIG)
    return {
        # the ceilings are THIS card's; another card gets its own or raises
        "chip_model": card.name,
        "sm_count": card.sm_count,
        "fmul_per_sig": FMUL_PER_SIG,
        "int32_muladd_slots_per_sig": INT32_MULADD_SLOTS_PER_SIG,
        "achieved_int32_muladd_tops": round(achieved / 1e12, 3),
        "int32_muladd_peak_tops": round(card.int32_muladd_per_s / 1e12, 3),
        "roofline_pct": round(100.0 * achieved / card.int32_muladd_per_s, 1),
        "int32_muladd_bound_sigs_per_sec": round(op_rate, 0),
        "hbm_bound_sigs_per_sec": round(hbm_rate, 0),
        "compute_vs_memory_bound_ratio": round(hbm_rate / op_rate, 0),
    }


def model_rlc(device_only_sigs_per_sec: float, card: Card) -> dict:
    """Roofline of the RLC lanes kernel (whole layout's count) at a
    measured device-only rate, against the same issue ceiling K1 is
    scored on. ``rlc_vs_per_sig_op_ratio`` is the lane's work over K1's:
    at equal utilisation K1 wins whenever it exceeds 1, which is why
    ``auto`` does not route the card's flushes to RLC."""
    achieved = device_only_sigs_per_sec * RLC_INT32_MULADD_SLOTS_PER_SIG
    op_rate, hbm_rate = _rates(card, RLC_INT32_MULADD_SLOTS_PER_SIG, RLC_BYTES_PER_SIG)
    return {
        "chip_model": card.name,
        "sm_count": card.sm_count,
        "rlc_fmul_per_sig": RLC_FMUL_PER_SIG,
        "rlc_int32_muladd_slots_per_sig": RLC_INT32_MULADD_SLOTS_PER_SIG,
        "rlc_vs_per_sig_op_ratio": round(RLC_INT32_MULADD_SLOTS_PER_SIG / INT32_MULADD_SLOTS_PER_SIG, 2),
        "achieved_int32_muladd_tops": round(achieved / 1e12, 3),
        "roofline_pct": round(100.0 * achieved / card.int32_muladd_per_s, 1),
        "int32_muladd_bound_sigs_per_sec": round(op_rate, 0),
        "hbm_bound_sigs_per_sec": round(hbm_rate, 0),
    }
