"""Simulated network fabric: the mesh surface without sockets.

Counterpart of ``at2_node_tpu/sim/fabric.py``.

``SimFabric`` is the single authority for everything that happens on
the wire in a simulated episode: per-link latency (+ seeded jitter, the
source of reordering), probabilistic loss and duplication, partitions,
and a byzantine *interposer* hook that can drop / replace / multiply
any frame in flight. Every wire event is appended to a trace whose
hash is the episode's determinism fingerprint.

``SimMesh`` implements the duck-type surface ``Broadcast`` and
``Service`` consume from the real ``net.peers.Mesh`` (``peers``,
``by_sign`` / ``by_exchange``, ``send`` / ``broadcast``, ``stats``,
``start`` / ``close``). One ``send`` is one frame is one delivery — no
coalescing — so an interposer can dispatch on the frame's leading kind
byte (GOSSIP=1, ECHO=2, READY=3, BATCH=9, ...).

``SimChannel`` separately implements the low-level transport
``Channel`` surface (``send`` / ``recv`` / ``close`` /
``peer_public``) for tests that exercise channel consumers directly.
"""

from __future__ import annotations

import asyncio
import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..net.peers import Peer
from ..net.transport import ChannelClosed


def _seed_int(*parts) -> int:
    """A stable 64-bit seed derived from arbitrary labeled parts."""
    h = hashlib.sha256("\x1f".join(str(p) for p in parts).encode())
    return int.from_bytes(h.digest()[:8], "big")


@dataclass
class LinkModel:
    """Behavior of one directed link. Jitter is drawn per frame from the
    fabric rng, so equal-latency links still interleave — and reorder —
    deterministically under a fixed seed."""

    latency: float = 0.01
    jitter: float = 0.005
    loss: float = 0.0
    dup: float = 0.0


# interposer(src_sign, dst_sign, frame) -> None to pass through,
# [] to drop, or replacement frames (each delivered independently).
Interposer = Callable[[bytes, bytes, bytes], Optional[List[bytes]]]


class SimFabric:
    """All links between all simulated nodes, plus the wire trace."""

    def __init__(self, loop, seed: int = 0, default_link: Optional[LinkModel] = None) -> None:
        import random

        self.loop = loop
        self.rng = random.Random(_seed_int("fabric", seed))
        self.default_link = default_link or LinkModel()
        self.links: Dict[Tuple[bytes, bytes], LinkModel] = {}
        self.meshes: Dict[bytes, "SimMesh"] = {}
        self._blocked: set = set()  # frozenset({a_sign, b_sign})
        self.interposer: Optional[Interposer] = None
        self.trace: List[tuple] = []
        self.in_flight = 0
        self.delivered = 0
        self.dropped = 0
        self._tasks: set = set()

    # -- topology ----------------------------------------------------------

    def register(self, sign_public: bytes, mesh: "SimMesh") -> None:
        self.meshes[sign_public] = mesh

    def set_link(self, src_sign: bytes, dst_sign: bytes, model: LinkModel) -> None:
        self.links[(src_sign, dst_sign)] = model

    def link(self, src_sign: bytes, dst_sign: bytes) -> LinkModel:
        return self.links.get((src_sign, dst_sign), self.default_link)

    def partition(self, a_sign: bytes, b_sign: bytes) -> None:
        """Block both directions between two nodes."""
        self._blocked.add(frozenset((a_sign, b_sign)))
        self._record("part", a_sign, b_sign, b"")

    def heal(self, a_sign: bytes, b_sign: bytes) -> None:
        self._blocked.discard(frozenset((a_sign, b_sign)))
        self._record("heal", a_sign, b_sign, b"")

    def heal_all(self) -> None:
        for pair in list(self._blocked):
            a, b = tuple(pair)
            self.heal(a, b)

    def is_partitioned(self, a_sign: bytes, b_sign: bytes) -> bool:
        return frozenset((a_sign, b_sign)) in self._blocked

    # -- the wire ----------------------------------------------------------

    def send(self, src_sign: bytes, dst_sign: bytes, frame: bytes) -> None:
        """One frame from src to dst, through partition check, the
        interposer, then loss/dup/latency of the directed link."""
        if self.is_partitioned(src_sign, dst_sign):
            self.dropped += 1
            self._record("cut", src_sign, dst_sign, frame)
            return
        frames: List[bytes] = [frame]
        if self.interposer is not None:
            out = self.interposer(src_sign, dst_sign, frame)
            if out is not None:
                self.dropped += 1 if not out else 0
                self._record("ipose", src_sign, dst_sign, frame)
                frames = out
        model = self.link(src_sign, dst_sign)
        for f in frames:
            if model.loss and self.rng.random() < model.loss:
                self.dropped += 1
                self._record("loss", src_sign, dst_sign, f)
                continue
            copies = 2 if (model.dup and self.rng.random() < model.dup) else 1
            for c in range(copies):
                if c:
                    self._record("dup", src_sign, dst_sign, f)
                delay = model.latency + (
                    self.rng.uniform(0.0, model.jitter) if model.jitter else 0.0
                )
                self.in_flight += 1
                self._record("send", src_sign, dst_sign, f)
                self.loop.call_later(delay, self._deliver, src_sign, dst_sign, f)

    def inject(self, src_sign: bytes, dst_sign: bytes, frame: bytes) -> None:
        """A frame from a hostile identity: same link pipeline, traced as
        an injection. ``src_sign`` must be a configured identity of the
        destination (the real mesh only accepts authenticated peers)."""
        self._record("inj", src_sign, dst_sign, frame)
        self.send(src_sign, dst_sign, frame)

    def _deliver(self, src_sign: bytes, dst_sign: bytes, frame: bytes) -> None:
        self.in_flight -= 1
        mesh = self.meshes.get(dst_sign)
        if mesh is None or mesh.closed:
            self.dropped += 1
            self._record("dead", src_sign, dst_sign, frame)
            return
        peer = mesh.by_sign.get(src_sign)
        if peer is None:  # unauthenticated identity: real mesh refuses too
            self.dropped += 1
            self._record("unauth", src_sign, dst_sign, frame)
            return
        self.delivered += 1
        self._record("dlv", src_sign, dst_sign, frame)
        task = self.loop.create_task(mesh.on_frame(peer, frame))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # -- trace -------------------------------------------------------------

    def _record(self, kind: str, src: bytes, dst: bytes, frame: bytes) -> None:
        digest = hashlib.sha256(frame).hexdigest()[:12] if frame else "-"
        self.trace.append(
            (
                round(self.loop.time(), 9),
                kind,
                src[:4].hex(),
                dst[:4].hex(),
                frame[0] if frame else -1,
                digest,
            )
        )

    def trace_hash(self) -> str:
        h = hashlib.sha256()
        for ev in self.trace:
            h.update(repr(ev).encode())
        return h.hexdigest()


class SimMesh:
    """The ``net.peers.Mesh`` surface, backed by a :class:`SimFabric`."""

    def __init__(
        self,
        fabric: SimFabric,
        own_sign: bytes,
        peers: Iterable[Peer],
        on_frame,
        region_fanout: bool = False,
    ) -> None:
        self.fabric = fabric
        self.own_sign = own_sign
        # [wan] region-aware fanout: broadcast walks peers nearest-first
        # by configured link latency. The sim twin of the real mesh's
        # RTT-EWMA ordering — here latency is declared, so the order is
        # a pure function of topology (deterministic, but it DOES change
        # the fabric-rng draw order vs the off path, hence knob-gated).
        self.region_fanout = region_fanout
        self.peers: List[Peer] = list(peers)
        self.by_exchange: Dict[bytes, Peer] = {
            p.exchange_public: p for p in self.peers
        }
        self.by_sign: Dict[bytes, Peer] = {p.sign_public: p for p in self.peers}
        self.on_frame = on_frame
        self.closed = False
        self.send_overflows = 0
        fabric.register(own_sign, self)

    def stats(self) -> dict:
        # same keys as the real Mesh: health_verdict and the stats loop
        # read these. Every configured peer counts as connected — link
        # faults are the fabric's business, not the channel layer's.
        return {
            "channels": 0 if self.closed else len(self.peers),
            "send_queue_depth": self.fabric.in_flight,
            "redials": 0,
            "dial_failures": 0,
            "peer_reconnects": 0,
            "send_overflows": self.send_overflows,
            "native_readers": 0,
            "reader_drops": 0,
        }

    async def start(self) -> None:
        pass

    async def close(self) -> None:
        self.closed = True

    def send(self, peer: Peer, frame: bytes) -> None:
        if not self.closed:
            self.fabric.send(self.own_sign, peer.sign_public, frame)

    def broadcast(self, frame: bytes, exclude: Iterable[bytes] = ()) -> None:
        skip = set(exclude)
        peers = self.peers
        if self.region_fanout:
            # stable sort: equal-latency (same-region) peers keep their
            # configured order, so the schedule stays deterministic
            peers = sorted(
                peers,
                key=lambda p: self.fabric.link(
                    self.own_sign, p.sign_public
                ).latency,
            )
        for peer in peers:
            if peer.exchange_public not in skip:
                self.send(peer, frame)

    # -- membership (net.peers.Mesh parity) -------------------------------
    # Removal doubles as the post-grace attestation filter exactly like
    # the real mesh: _deliver drops frames whose source is no longer in
    # by_sign ("unauth"), and the broadcast stack rejects origins missing
    # from by_sign.

    def add_peer(self, peer: Peer) -> bool:
        if (
            peer.sign_public == self.own_sign
            or peer.exchange_public in self.by_exchange
        ):
            return False
        self.peers.append(peer)
        self.by_exchange[peer.exchange_public] = peer
        self.by_sign[peer.sign_public] = peer
        return True

    def remove_peer(self, sign_public: bytes) -> bool:
        peer = self.by_sign.pop(sign_public, None)
        if peer is None:
            return False
        self.by_exchange.pop(peer.exchange_public, None)
        self.peers = [
            p for p in self.peers if p.exchange_public != peer.exchange_public
        ]
        return True


class SimChannel:
    """The transport ``Channel`` duck type (send/recv/close/peer_public)
    over an in-memory pipe with optional virtual latency. Built in
    connected pairs — handshake identity is simply asserted."""

    def __init__(self, loop, peer_public: bytes, latency: float = 0.0) -> None:
        self._loop = loop
        self.peer_public = peer_public
        self.latency = latency
        self._queue: asyncio.Queue = asyncio.Queue()
        self._other: Optional["SimChannel"] = None
        self._closed = False

    @classmethod
    def pair(
        cls, loop, a_public: bytes, b_public: bytes, latency: float = 0.0
    ) -> Tuple["SimChannel", "SimChannel"]:
        """(a_end, b_end): a_end talks TO b (sees b's key), and vice versa."""
        a_end = cls(loop, b_public, latency)
        b_end = cls(loop, a_public, latency)
        a_end._other = b_end
        b_end._other = a_end
        return a_end, b_end

    async def send(self, payload: bytes) -> None:
        if self._closed or self._other is None or self._other._closed:
            raise ChannelClosed("simulated channel closed")
        other = self._other
        if self.latency:
            self._loop.call_later(self.latency, other._queue.put_nowait, payload)
        else:
            other._queue.put_nowait(payload)

    async def recv(self) -> bytes:
        if self._closed:
            raise ChannelClosed("simulated channel closed")
        item = await self._queue.get()
        if item is None:
            raise ChannelClosed("peer closed")
        return item

    def close(self) -> None:
        self._closed = True
        if self._other is not None and not self._other._closed:
            self._other._queue.put_nowait(None)
