"""Transfer types and the canonical signed form of a transfer.

Counterpart of the transfer half of ``at2_node_tpu/types.py``: what a
client signs (:func:`transfer_signing_bytes`) and what it transfers
(:class:`ThinTransaction`). The signed preimage is
``tag || sender(32) || sequence(4, LE) || recipient(32) || amount(8, LE)``
under a versioned domain tag, which binds the sender and the sequence into
the signature so one captured signature is valid for exactly one ledger
slot.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

Sequence = int  # u32, mirrors sieve::Sequence (at2.proto:13)

PUBLIC_KEY_LEN = 32
SIGNATURE_LEN = 64

# Domain tag of the transfer signature (v2: sender + sequence bound in;
# v1 — the reference's recipient||amount form — is not accepted anywhere).
TRANSFER_SIG_TAG = b"at2-node-tpu/transfer/v2"


def transfer_signing_bytes(
    sender: bytes, sequence: int, recipient: bytes, amount: int
) -> bytes:
    """Canonical preimage of a client transfer signature.

    ``tag || sender || sequence(LE u32) || recipient || amount(LE u64)``
    — byte-identical to ``TRANSFER_SIG_TAG`` + the first 76 bytes of the
    wire payload body (broadcast/messages.py ``_PAYLOAD``), so bulk
    verifiers can slice the preimage straight out of parsed frames."""
    if len(sender) != PUBLIC_KEY_LEN or len(recipient) != PUBLIC_KEY_LEN:
        raise ValueError("sender/recipient must be 32-byte public keys")
    return (
        TRANSFER_SIG_TAG
        + sender
        + struct.pack("<I", sequence)
        + recipient
        + struct.pack("<Q", amount)
    )


@dataclass(frozen=True)
class ThinTransaction:
    """Who gets how much (`lib.rs:15-24`); signed together with the
    sender and sequence (:func:`transfer_signing_bytes`)."""

    recipient: bytes  # 32-byte ed25519 public key
    amount: int  # u64

    def __post_init__(self) -> None:
        if len(self.recipient) != PUBLIC_KEY_LEN:
            raise ValueError("recipient must be a 32-byte public key")
        if not 0 <= self.amount < 1 << 64:
            raise ValueError("amount must fit in u64")
