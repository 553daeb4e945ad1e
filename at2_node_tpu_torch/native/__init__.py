"""Native (C++) host code around the CUDA verifier.

The runtime around the device compute path is native where the reference's
is (its whole broadcast/crypto stack is Rust). `at2_prep.cpp` implements
SHA-512, the mod-L scalar reduction, the S < L check, and writes each
lane's packed 129-byte row straight into the staging buffer;
`at2_ingest.cpp` parses wire frames, verifies in bulk through libcrypto
and drives the sharded plane's drain; `at2_rlc.cpp` is the host RLC
engine. Each is compiled on first use with the system g++ into the port's
``build/`` and loaded through ctypes (no pybind11). When a build fails the
callers take their pure-Python path. Nothing here imports torch.
"""

from .ingest import (
    counts_add_native,
    ingest_available,
    ingest_ready,
    ingest_ready_or_kick,
    kick_ingest_build,
    parse_frames_native,
    plane_drain_native,
    plane_drain_ready,
    quorum_mask_native,
    verify_bulk_native,
)
from .prep import native_available, prep_packed_native
from .reader import NativeChannelReader, reader_available

__all__ = [
    "NativeChannelReader",
    "reader_available",
    "counts_add_native",
    "ingest_available",
    "ingest_ready",
    "ingest_ready_or_kick",
    "kick_ingest_build",
    "native_available",
    "parse_frames_native",
    "plane_drain_native",
    "plane_drain_ready",
    "prep_packed_native",
    "quorum_mask_native",
    "verify_bulk_native",
]
