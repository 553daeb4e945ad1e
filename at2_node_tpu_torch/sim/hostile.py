"""Seeded hostile-frame generation, shared by the live-socket byzantine
fuzz campaign (tests/test_byzantine_fuzz.py) and the simulated fabric
campaigns (`at2_node_tpu_torch.sim.campaign`).

Counterpart of ``at2_node_tpu/sim/hostile.py``.

``HostileFrameGen`` is the pure part of the fuzzer: an authenticated
byzantine peer's frame constructors — valid-but-conflicting attestations,
batch equivocation, poison batches, oversized bitmaps, catchup-plane
junk, truncations, verbatim replays — driven entirely by an injected
``random.Random``. It never touches a socket; the live test wraps it
with transport channels, the simulator feeds its frames through
``SimFabric.inject``.

Client/recipient identities are derived from the rng (not
``SignKeyPair.random()``), so a `(seed, config)` pair fixes the entire
hostile byte stream — the property exact replay rests on.
"""

from __future__ import annotations

import random
import struct

from ..broadcast.messages import (
    BATCH_ECHO,
    BATCH_READY,
    ECHO,
    READY,
    Attestation,
    BatchAttestation,
    CertSig,
    ContentRequest,
    DirectoryAnnounce,
    HistoryBatch,
    HistoryIndexRequest,
    HistoryRequest,
    Payload,
    TxBatch,
)
from ..crypto.keys import SignKeyPair
from ..types import ThinTransaction


def mutate_distilled_frame(frame: bytes, rng: random.Random) -> bytes:
    """One hostile mutation of a well-formed distilled-batch frame
    (proto/distill.py). Used by the codec fuzz tests (differential: the
    Python and native parsers must agree on every mutant) and by the
    byzantine-broker campaign's "garbage" mutation. Mutants are not
    guaranteed malformed — a flip inside the signature block decodes
    fine and must then fail per-entry verification instead — which is
    exactly the coverage a corrupting broker needs."""
    choice = rng.randrange(6)
    b = bytearray(frame)
    if choice == 0 and b:  # magic / version stomp
        b[rng.randrange(min(2, len(b)))] ^= 0xFF
    elif choice == 1 and len(b) > 1:  # truncation
        del b[rng.randint(1, len(b) - 1):]
    elif choice == 2:  # trailing junk (length checks must catch it)
        b.extend(rng.getrandbits(8) for _ in range(rng.randint(1, 64)))
    elif choice == 3 and len(b) > 3:  # single bit flip anywhere past magic
        b[rng.randrange(2, len(b))] ^= 1 << rng.randrange(8)
    elif choice == 4 and len(b) > 4:  # stomp the count varints
        b[2] = rng.choice((0x00, 0x7F, 0x80, 0xFF))
        b[3] = rng.choice((0x00, 0x7F, 0x80, 0xFF))
    else:  # pure garbage
        return bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 200)))
    return bytes(b)


def mutate_cert_frame(frame: bytes, rng: random.Random) -> bytes:
    """One hostile mutation of a well-formed kind-16 certificate
    co-signature frame (broadcast/messages.py CertSig). Same contract
    as :func:`mutate_distilled_frame`: mutants are not guaranteed
    malformed — a flip inside the 64-byte signature tail parses fine
    and must then fail the assembler's per-cosig verification
    (``bad_sig``), while kind stomps and truncations must die in the
    frame parser without desyncing the frames behind them."""
    choice = rng.randrange(6)
    b = bytearray(frame)
    if choice == 0 and b:  # kind stomp: reroute to another parser
        b[0] ^= rng.choice((0x01, 0x10, 0xFF))
    elif choice == 1 and len(b) > 1:  # truncation
        del b[rng.randint(1, len(b) - 1):]
    elif choice == 2:  # trailing junk (wire-size discipline must catch)
        b.extend(rng.getrandbits(8) for _ in range(rng.randint(1, 64)))
    elif choice == 3 and len(b) > 65:  # body flip: epoch/wm/ranges/dir
        b[rng.randrange(1, len(b) - 64)] ^= 1 << rng.randrange(8)
    elif choice == 4 and len(b) >= 64:  # signature flip: parses, bad sig
        b[rng.randrange(len(b) - 64, len(b))] ^= 1 << rng.randrange(8)
    else:  # pure garbage
        return bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 300)))
    return bytes(b)


def _rng_keypair(rng: random.Random) -> SignKeyPair:
    return SignKeyPair(bytes(rng.getrandbits(8) for _ in range(32)))


class SaltingClientGen:
    """Batch-poisoning byzantine CLIENT: emits bulk-ingress flushes that
    look honest except ``k_bad`` bad-signature entries at adversarial
    positions — spread so every bisection level has to split a bad pair,
    the worst case for an amortized (RLC) batch verifier. The bad entries
    are REAL signatures with one flipped bit in ``s``: R still decodes
    and is torsion-free, so they survive every cheap classification and
    force the batch equation itself to fail.

    Pure like :class:`HostileFrameGen`: seeded rng in, deterministic
    flush specs out; the sim feeds them through the real
    ``SendAssetBatch`` handler (`SimNet.asubmit_batch`)."""

    def __init__(self, rng: random.Random, k_bad: int = 3):
        self.rng = rng
        self.k_bad = k_bad
        self.key = _rng_keypair(rng)
        self.recipient = _rng_keypair(rng).public
        self._seq = 0

    def positions(self, size: int) -> list:
        """Adversarial placement: endpoints plus an even spread, so the
        bad lanes land in different bisection halves at every depth."""
        k = min(self.k_bad, size)
        if k <= 0:
            return []
        if k == 1:
            return [0]
        return sorted({round(i * (size - 1) / (k - 1)) for i in range(k)})

    def next_flush(self, size: int) -> list:
        """``(sequence, recipient, amount, good_sig)`` rows for one
        salted flush. Sequences advance monotonically — the honest-
        looking entries are individually committable, which is exactly
        what makes the salting adversarial (all-or-nothing admission
        burns them alongside the poison)."""
        bad = set(self.positions(size))
        rows = []
        for j in range(size):
            self._seq += 1
            rows.append(
                (
                    self._seq,
                    self.recipient,
                    1 + self.rng.randint(0, 9),
                    j not in bad,
                )
            )
        return rows


class HostileFrameGen:
    """Authenticated byzantine peer emitting seeded random frame salvos."""

    def __init__(self, sign_key: SignKeyPair, rng: random.Random):
        self.sign = sign_key
        self.rng = rng
        self.sent_log = []  # replay source
        # identities this fuzzer signs client payloads with
        self.clients = [_rng_keypair(rng) for _ in range(3)]
        self.recipients = [_rng_keypair(rng).public for _ in range(3)]
        self.batches = []  # real TxBatches sent: targets for oversized bitmaps

    # -- frame constructors -----------------------------------------------

    def _payload(self, client, seq, recipient, amount, good_sig=True):
        tx = ThinTransaction(recipient, amount)
        if good_sig:
            return Payload.create(client, seq, tx)
        sig = bytes(self.rng.getrandbits(8) for _ in range(64))
        return Payload(client.public, seq, tx, sig)

    def _rand_payload(self):
        rng = self.rng
        return self._payload(
            rng.choice(self.clients),
            rng.randint(1, 4),
            rng.choice(self.recipients),
            rng.randint(1, 50),
            good_sig=rng.random() > 0.25,
        )

    def _rand_batch(self):
        rng = self.rng
        entries = b"".join(
            self._rand_payload().encode()[1:]
            for _ in range(rng.randint(1, 6))
        )
        batch = TxBatch.create(self.sign, rng.randint(1, 5), entries)
        self.batches.append(batch)
        return batch

    def _poison_batch(self):
        """A batch GUARANTEED to carry at least one never-verifiable
        entry among honest-looking ones — the poison-slot resolution
        path's bread and butter (slot must retire, never stall)."""
        rng = self.rng
        payloads = [self._rand_payload() for _ in range(rng.randint(1, 4))]
        payloads.insert(
            rng.randrange(len(payloads) + 1),
            self._payload(
                rng.choice(self.clients),
                rng.randint(1, 4),
                rng.choice(self.recipients),
                rng.randint(1, 50),
                good_sig=False,
            ),
        )
        entries = b"".join(p.encode()[1:] for p in payloads)
        batch = TxBatch.create(self.sign, rng.randint(1, 5), entries)
        self.batches.append(batch)
        return batch

    def _oversized_batch_attestation(self):
        """A correctly signed attestation for a REAL previously-sent
        batch whose bitmap claims far more entries than the batch has:
        exercises the width clamp (phantom bits must not grow nbits or
        spuriously quorate). Falls back to a random one before any batch
        exists."""
        rng = self.rng
        if not self.batches:
            return self._rand_batch_attestation()
        batch = rng.choice(self.batches)
        phase = rng.choice((BATCH_ECHO, BATCH_READY))
        bitmap = bytes(
            rng.getrandbits(8) | 1 for _ in range(rng.choice((16, 64, 128)))
        )
        sig = self.sign.sign(
            BatchAttestation.signing_bytes(
                phase, batch.origin, batch.batch_seq, batch.content_hash(), bitmap
            )
        )
        return BatchAttestation(
            phase,
            self.sign.public,
            batch.origin,
            batch.batch_seq,
            batch.content_hash(),
            bitmap,
            sig,
        )

    def _rand_attestation(self):
        rng = self.rng
        phase = rng.choice((ECHO, READY))
        sender = rng.choice(self.clients).public
        seq = rng.randint(1, 4)
        chash = (
            self._rand_payload().content_hash()
            if rng.random() < 0.6
            else bytes(rng.getrandbits(8) for _ in range(32))
        )
        sig = self.sign.sign(
            Attestation.signing_bytes(phase, sender, seq, chash)
        )
        return Attestation(phase, self.sign.public, sender, seq, chash, sig)

    def targeted_attestation(self, phase, sender, seq, chash):
        """A correctly signed attestation for an EXACT (sender, seq,
        content) — the building block of split-vote schedules, where the
        hostile peer vouches for different contents to different nodes."""
        sig = self.sign.sign(
            Attestation.signing_bytes(phase, sender, seq, chash)
        )
        return Attestation(phase, self.sign.public, sender, seq, chash, sig)

    def _rand_batch_attestation(self):
        rng = self.rng
        phase = rng.choice((BATCH_ECHO, BATCH_READY))
        b_origin = self.sign.public
        b_seq = rng.randint(1, 5)
        b_hash = bytes(rng.getrandbits(8) for _ in range(32))
        bitmap = bytes(
            rng.getrandbits(8) for _ in range(rng.choice((1, 2, 16, 128)))
        )
        sig = self.sign.sign(
            BatchAttestation.signing_bytes(phase, b_origin, b_seq, b_hash, bitmap)
        )
        return BatchAttestation(
            phase, self.sign.public, b_origin, b_seq, b_hash, bitmap, sig
        )

    def _rand_catchup_junk(self):
        rng = self.rng
        kind = rng.randrange(4)
        if kind == 0:
            return HistoryIndexRequest(rng.getrandbits(64))
        if kind == 1:
            return HistoryRequest(
                rng.getrandbits(64),
                rng.choice(self.clients).public,
                1,
                rng.randint(1, 1 << 20),  # absurd range: server must clamp
            )
        if kind == 2:
            return HistoryBatch(
                rng.getrandbits(64),
                tuple(self._rand_payload() for _ in range(rng.randint(1, 4))),
            )
        return ContentRequest(
            rng.choice(self.clients).public,
            rng.randint(1, 4),
            bytes(rng.getrandbits(8) for _ in range(32)),
        )

    def _rand_dir_announce(self):
        """Directory-poisoning attempts: out-of-stride ids, zero keys,
        rebinding collisions. All liveness-only by the trust argument
        (node/directory.py) — the receiver's stride check and
        first-binding-wins rule drop or defang every one of these."""
        rng = self.rng
        entries = tuple(
            (
                rng.getrandbits(rng.choice((4, 16, 62))),
                (
                    b"\x00" * 32
                    if rng.random() < 0.2
                    else bytes(rng.getrandbits(8) for _ in range(32))
                ),
            )
            for _ in range(rng.randint(0, 5))
        )
        return DirectoryAnnounce(self.sign.public, entries)

    def _malformed(self) -> bytes:
        rng = self.rng
        choice = rng.randrange(4)
        if choice == 0:  # unknown kind
            return bytes([rng.randint(14, 255)]) + bytes(
                rng.getrandbits(8) for _ in range(rng.randint(0, 64))
            )
        if choice == 1:  # truncated known message
            full = self._rand_payload().encode()
            return full[: rng.randint(1, len(full) - 1)]
        if choice == 2:  # batch header with an absurd count field
            b = bytearray(self._rand_batch().encode())
            b[41:45] = struct.pack("<I", rng.randint(1025, 1 << 30))
            return bytes(b)
        # random garbage
        return bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 200)))

    def next_frame(self) -> bytes:
        rng = self.rng
        roll = rng.random()
        if roll < 0.22:
            msgs = [self._rand_payload() for _ in range(rng.randint(1, 3))]
            frame = b"".join(m.encode() for m in msgs)
        elif roll < 0.34:
            frame = self._rand_batch().encode()
        elif roll < 0.42:
            frame = self._poison_batch().encode()
        elif roll < 0.58:
            frame = self._rand_attestation().encode()
        elif roll < 0.68:
            frame = self._rand_batch_attestation().encode()
        elif roll < 0.75:
            frame = self._oversized_batch_attestation().encode()
        elif roll < 0.84:
            frame = self._rand_catchup_junk().encode()
        elif roll < 0.89:
            frame = self._rand_dir_announce().encode()
        elif roll < 0.95 and self.sent_log:
            frame = rng.choice(self.sent_log)  # verbatim replay
        else:
            frame = self._malformed()
        self.sent_log.append(frame)
        return frame


class CertAdversary:
    """Byzantine fleet MEMBER attacking the finality-certificate lane
    (finality/certs.py): its sign key is in the epoch member set, so
    its kind-16 co-signatures verify — the attacks below are exactly
    the ones a single compromised member can mount, and the assembler
    must defang every one without help from the honest majority.

    Pure like the other generators: seeded rng in, deterministic frames
    out; the sim injects them through ``SimFabric.inject``."""

    def __init__(self, sign_key: SignKeyPair, rng: random.Random):
        self.sign = sign_key
        self.rng = rng

    def _digests(self):
        rng = self.rng
        wm = bytes(rng.getrandbits(8) for _ in range(16))
        ranges = bytes(rng.getrandbits(8) for _ in range(128))
        dird = bytes(rng.getrandbits(8) for _ in range(8))
        return wm, ranges, dird

    def equivocating_pair(self, epoch: int = 0) -> tuple:
        """Two VALIDLY SIGNED co-signatures for the same (epoch,
        watermark) naming different ledger states — cryptographic
        equivocation. The receiving assembler must latch the culprit
        with both signed statements, and neither statement may ever
        reach a certificate (an honest quorum never co-signs either
        fabricated state)."""
        wm, ranges, dird = self._digests()
        commits = self.rng.getrandbits(16)
        a = CertSig.create(self.sign, epoch, commits, wm, ranges, dird)
        ranges2 = bytes(x ^ 0xFF for x in ranges)
        b = CertSig.create(self.sign, epoch, commits, wm, ranges2, dird)
        return a.encode(), b.encode()

    def off_epoch(self, epoch: int) -> bytes:
        """A validly signed co-signature at a stale (or future) epoch:
        counted as ``epoch_skew`` and never bucketed — a pre-reconfig
        member cannot vote under the new epoch's quorum rule."""
        wm, ranges, dird = self._digests()
        return CertSig.create(
            self.sign, epoch, self.rng.getrandbits(16), wm, ranges, dird
        ).encode()

    def forged(self, epoch: int = 0) -> bytes:
        """A well-formed frame whose signature is garbage: survives the
        wire parser, must die at the assembler's scheme verification
        (``bad_sig``)."""
        wm, ranges, dird = self._digests()
        sig = bytes(self.rng.getrandbits(8) for _ in range(64))
        return CertSig(
            self.sign.public, epoch, self.rng.getrandbits(16),
            wm, ranges, dird, sig,
        ).encode()

    def mutant(self, epoch: int = 0) -> bytes:
        """A mutated kind-16 frame (wire fuzz: parser robustness)."""
        base = self.off_epoch(epoch) if self.rng.random() < 0.5 else (
            self.forged(epoch)
        )
        return mutate_cert_frame(base, self.rng)
