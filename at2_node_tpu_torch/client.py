"""Typed AT2 client library over the gRPC surface.

Counterpart of ``at2_node_tpu/client.py``.

Equivalent of `at2_node::client::Client`
(`at2-node/src/client.rs:44-144`): a thin wrapper around the
`at2.AT2` stub that signs transfers client-side
(`client.rs:77-78`) and decodes replies into the shared types. Used by
the client CLI and the benchmark load generators.

Like the reference, the channel is lazy: nothing connects until the first
RPC (`client.rs:61`, tonic `connect_lazy`).
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import grpc

from .broadcast.messages import MAX_BATCH_ENTRIES as _RPC_BATCH_CAP
from .crypto.keys import SignKeyPair
from .node.overload import parse_retry_after_ms
from .proto import at2_pb2 as pb
from .proto.rpc import At2Stub
from .types import (
    FullTransaction,
    TransactionState,
    parse_rfc3339,
    transfer_signing_bytes,
)


@dataclass
class RetryPolicy:
    """Jittered-exponential retry budget for RESOURCE_EXHAUSTED refusals
    (overload sheds, broker brownout — the [overload] ladder).

    The backoff honors the server's typed ``retry_after_ms`` hint: the
    delay is never shorter than the hint, so a shedding fleet paces its
    own retry wave instead of the wave becoming a second flash crowd.
    Jitter spreads synchronized clients over ``jitter`` of the delay
    (full-window decorrelation is what keeps retries from re-bunching).
    ``budget`` bounds attempts per logical call; once spent, the last
    refusal propagates to the caller unchanged.

    ``rng`` / ``sleep`` are injectable for deterministic tests."""

    budget: int = 4
    base_ms: float = 100.0
    max_ms: float = 5000.0
    multiplier: float = 2.0
    jitter: float = 0.5
    rng: Callable[[], float] = field(default=random.random)
    sleep: Callable[[float], "asyncio.Future"] = field(default=asyncio.sleep)

    def delay_s(self, attempt: int, hint_ms: Optional[int] = None) -> float:
        """Delay before retry number ``attempt`` (0-based), seconds."""
        backoff = min(self.max_ms, self.base_ms * self.multiplier ** attempt)
        if hint_ms is not None:
            backoff = min(self.max_ms, max(backoff, float(hint_ms)))
        spread = 1.0 - self.jitter / 2.0 + self.jitter * self.rng()
        return backoff * spread / 1e3

    async def run(self, attempt_fn):
        """Run ``attempt_fn()`` with the retry budget. Retries only
        RESOURCE_EXHAUSTED — anything else (bad signature, malformed
        request) is not load-induced and must not be re-offered."""
        attempt = 0
        while True:
            try:
                return await attempt_fn()
            except grpc.aio.AioRpcError as exc:
                if exc.code() != grpc.StatusCode.RESOURCE_EXHAUSTED:
                    raise
                if attempt >= self.budget:
                    raise
                hint = parse_retry_after_ms(exc.details())
                await self.sleep(self.delay_s(attempt, hint))
                attempt += 1


def _target(uri: str) -> str:
    """grpc.aio targets are host:port; accept http:// URLs for parity with
    the reference's Uri-based config (`client.rs:51-64`)."""
    for prefix in ("http://", "https://"):
        if uri.startswith(prefix):
            uri = uri[len(prefix):]
    return uri.rstrip("/")


class Client:
    def __init__(self, uri: str, retry: Optional[RetryPolicy] = None) -> None:
        self._channel = grpc.aio.insecure_channel(_target(uri))
        self._stub = At2Stub(self._channel)
        self._retry = retry

    async def _submit(self, attempt_fn):
        """Submission-path RPCs go through the retry budget when one is
        configured; read-path RPCs never retry (a refused read is not
        load the client should re-offer)."""
        if self._retry is None:
            return await attempt_fn()
        return await self._retry.run(attempt_fn)

    async def close(self) -> None:
        await self._channel.close()

    async def __aenter__(self) -> "Client":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def send_asset(
        self,
        keypair: SignKeyPair,
        sequence: int,
        recipient: bytes,
        amount: int,
    ) -> None:
        """Sign and submit a transfer (`client.rs:70-91`). The signature
        covers the v2 tagged transfer form — sender and sequence bound
        in (types.py ``transfer_signing_bytes``) — so no middleman
        (broker or ingress node) can re-submit it at another slot."""
        signature = keypair.sign(
            transfer_signing_bytes(keypair.public, sequence, recipient, amount)
        )
        request = pb.SendAssetRequest(
            sender=keypair.public,
            sequence=sequence,
            recipient=recipient,
            amount=amount,
            signature=signature,
        )
        await self._submit(lambda: self._stub.SendAsset(request))

    async def send_asset_many(
        self,
        keypair: SignKeyPair,
        transfers: List[tuple],
    ) -> None:
        """Sign and submit MANY transfers in one RPC (`SendAssetBatch`,
        a beyond-parity extension — at2.proto documents it). ``transfers``
        is ``[(sequence, recipient, amount), ...]``; each entry is signed
        individually exactly like :meth:`send_asset`, so the node-side
        semantics are identical — only the ingress round-trips amortize.
        Lists beyond the server's per-request cap are chunked
        transparently (one RPC per chunk, in order)."""
        requests = []
        for sequence, recipient, amount in transfers:
            requests.append(
                pb.SendAssetRequest(
                    sender=keypair.public,
                    sequence=sequence,
                    recipient=recipient,
                    amount=amount,
                    signature=keypair.sign(
                        transfer_signing_bytes(
                            keypair.public, sequence, recipient, amount
                        )
                    ),
                )
            )
        for lo in range(0, len(requests), _RPC_BATCH_CAP):
            chunk = pb.SendAssetBatchRequest(
                transactions=requests[lo : lo + _RPC_BATCH_CAP]
            )
            await self._submit(lambda: self._stub.SendAssetBatch(chunk))

    async def register(self, public_key: bytes) -> int:
        """Register a client pubkey into the node's gossiped directory
        (broker ingress tier, at2.proto `Register`). Idempotent — returns
        the same dense client-id on every call."""
        reply = await self._stub.Register(
            pb.RegisterRequest(public_key=public_key)
        )
        return reply.client_id

    async def send_distilled(self, frame: bytes) -> None:
        """Submit one distilled batch frame (proto/distill.py format) —
        the broker's forwarding path; also handy for tests driving the
        node's distilled ingress directly."""
        request = pb.SendDistilledBatchRequest(frame=frame)
        await self._submit(lambda: self._stub.SendDistilledBatch(request))

    async def get_balance(self, user: bytes) -> int:
        reply = await self._stub.GetBalance(pb.GetBalanceRequest(sender=user))
        return reply.amount

    async def get_last_sequence(self, user: bytes) -> int:
        reply = await self._stub.GetLastSequence(
            pb.GetLastSequenceRequest(sender=user)
        )
        return reply.sequence

    async def get_certificates(self) -> tuple:
        """The node's finality-certificate chain tail.

        Returns ``(enabled, epoch, node_commits, certs)`` where *certs*
        are decoded ``finality.Certificate`` objects, oldest first.
        ``enabled`` is False when the node runs without a ``[finality]``
        table — the other fields are still meaningful (``node_commits``
        tracks the commit frontier either way).
        """
        from .finality import Certificate
        from .proto import finality_pb2 as fpb

        reply = await self._stub.GetCertificate(fpb.GetCertificateRequest())
        certs = [Certificate.decode(raw) for raw in reply.certificates]
        return reply.enabled, reply.epoch, reply.node_commits, certs

    async def wait_final(
        self,
        sender: bytes,
        sequence: int,
        *,
        verifier=None,
        timeout_s: float = 30.0,
        poll_s: float = 0.25,
    ) -> "Certificate":
        """Block until ``sender``'s transfer ``sequence`` is covered by a
        finality certificate, and return that certificate.

        Two-phase: first poll ``GetLastSequence`` until the node has
        committed the transfer, noting the node's commit frontier at
        that instant; then poll ``GetCertificate`` until a certificate
        whose ``commits`` reaches that frontier arrives — every commit
        the node had applied (including ours) is inside the certified
        watermark by the additive-digest contract.

        Pass a ``finality.LightVerifier`` as *verifier* to refuse
        certificates the client cannot verify itself (stateless
        trust: f+1 known public keys suffice). Raises ``TimeoutError``
        when the deadline passes, ``RuntimeError`` when the node runs
        without finality certificates.
        """
        from .finality import Certificate  # noqa: F401  (return type)

        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        frontier = None
        while True:
            if frontier is None:
                seq = await self.get_last_sequence(sender)
                if seq >= sequence:
                    _, _, frontier, _ = await self.get_certificates()
            if frontier is not None:
                enabled, _, _, certs = await self.get_certificates()
                if not enabled:
                    raise RuntimeError(
                        "node has no [finality] table; wait_final needs "
                        "certificate production enabled fleet-side"
                    )
                for cert in reversed(certs):
                    if cert.commits < frontier:
                        continue
                    if verifier is not None and not verifier.verify(cert)["ok"]:
                        continue
                    return cert
            if loop.time() >= deadline:
                raise TimeoutError(
                    f"no finality certificate covering seq {sequence} "
                    f"within {timeout_s}s"
                )
            await asyncio.sleep(poll_s)

    async def get_latest_transactions(self) -> List[FullTransaction]:
        reply = await self._stub.GetLatestTransactions(
            pb.GetLatestTransactionsRequest()
        )
        return [
            FullTransaction(
                timestamp=parse_rfc3339(tx.timestamp),
                sender=tx.sender,
                sender_sequence=tx.sender_sequence,
                recipient=tx.recipient,
                amount=tx.amount,
                state=TransactionState(tx.state),
            )
            for tx in reply.transactions
        ]
