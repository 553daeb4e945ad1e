"""Full-mesh peer connection manager.

Counterpart of ``at2_node_tpu/net/peers.py``. Equivalent of drop's `System` / `SystemManager` / `NetworkSender`
(`at2-node/src/bin/server/rpc.rs:19,88-125`): bring up an encrypted
listener, dial every configured peer, and expose send/broadcast keyed by
peer identity. Improvements over the reference consciously taken:

* dropped connections ARE re-dialed with jittered exponential backoff —
  the reference leaves this as "TODO readd connections if dropped"
  (`rpc.rs:87`); successful re-dials after a drop are counted as
  `peer_reconnects` (distinct from `redials`, which counts the drops);
* inbound connections from unknown exchange keys are rejected at the
  handshake boundary (the reference relies on drop's Exchanger for the
  same property [dep-inferred]).

Each ordered pair of nodes uses one TCP connection: the initiator writes,
the responder reads. A full mesh of N nodes therefore carries N·(N−1)
connections, each authenticated by the X25519 handshake
(``net/transport.py``).

Delivery is best-effort (murmur semantics, `at2-node/technical.md:9-10`):
sends while a peer is down are buffered in a bounded queue and dropped
oldest-first on overflow.

Messages are coalesced: a wire frame is the plain concatenation of queued
messages (broadcast records are self-delimiting — see
`broadcast.messages.parse_frame`), so under load one AEAD seal and one
syscall carry up to MAX_BATCH_MSGS protocol messages — the amortization
that lets the broadcast plane keep pace with the GPU verifier's batch
throughput.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket as socket_mod
from collections import deque
from dataclasses import dataclass
from typing import Awaitable, Callable, Dict, Iterable, List, Optional

from ..crypto.keys import ExchangeKeyPair
from . import transport

logger = logging.getLogger(__name__)

SEND_QUEUE_CAP = 4096
# Coalescing bounds: one wire frame carries up to MAX_BATCH_MSGS queued
# messages (one AEAD + one syscall for all of them). Broadcast messages
# are self-delimiting fixed-size records (broadcast.messages.parse_frame),
# so coalescing is plain concatenation — no extra framing layer. Batches
# form naturally under load: while a frame drains, the queue refills, so
# the next frame is bigger — idle traffic still goes out one message at a
# time with no added latency.
MAX_BATCH_MSGS = 1024
MAX_BATCH_BYTES = 4 * 1024 * 1024


@dataclass(frozen=True)
class Peer:
    """One row of the config's `[[nodes]]` table
    (`at2-node/src/bin/server/config.rs:29-38` + this build's
    added `sign_public_key`)."""

    address: str  # "host:port" of the peer's node plane
    exchange_public: bytes  # 32-byte X25519 key (channel identity)
    sign_public: bytes  # 32-byte ed25519 key (Echo/Ready signing identity)
    region: str = ""  # optional region hint ([wan] fanout ordering)

    def host_port(self) -> tuple:
        host, _, port = self.address.rpartition(":")
        return host, int(port)


class Mesh:
    """Maintains channels to all peers; calls back on every inbound frame."""

    def __init__(
        self,
        listen_addr: str,
        keypair: ExchangeKeyPair,
        peers: Iterable[Peer],
        on_frame: Callable[[Peer, bytes], Awaitable[None]],
        clock=None,
        region_fanout: bool = False,
        region: str = "",
        capture_cap: int = 0,
    ) -> None:
        from ..clock import SYSTEM_CLOCK

        self.listen_addr = listen_addr
        self.keypair = keypair
        self.clock = SYSTEM_CLOCK if clock is None else clock
        # [wan] region-aware fanout: when on, broadcast() walks peers
        # nearest-first — same-region (declared hints) before far, RTT
        # EWMA (fed from dial timing) as the fine order within each tier
        self.region_fanout = region_fanout
        self.region = region
        self._rtt_ewma: Dict[bytes, float] = {}
        self.peers = [p for p in peers if p.exchange_public != keypair.public]
        self.by_exchange: Dict[bytes, Peer] = {
            p.exchange_public: p for p in self.peers
        }
        self.by_sign: Dict[bytes, Peer] = {p.sign_public: p for p in self.peers}
        self.on_frame = on_frame
        self._server: Optional[asyncio.base_events.Server] = None
        self._send_queues: Dict[bytes, asyncio.Queue] = {}
        self._tasks: list = []
        # outbound loops keyed by exchange key so membership removal can
        # cancel exactly one peer's dialer (node/membership.py)
        self._outbound_tasks: Dict[bytes, asyncio.Task] = {}
        self._channels: set = set()  # live channels, closed on shutdown
        self._closed = False
        # native-reader inbound plane (net docstring in native/reader.py):
        # wake-pipe read fd -> [peer, reader, sock, wake_write_fd, drops]
        self._native_by_fd: Dict[int, list] = {}
        self._listen_sock: Optional[socket_mod.socket] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # observability counters (SURVEY.md §5): connection churn and
        # best-effort-plane drops are the operator's failure-detection
        # signals
        self.redials = 0  # established connections dropped + re-dialed
        self.dial_failures = 0  # connect/handshake attempts that failed
        self.peer_reconnects = 0  # successful re-dials AFTER a drop
        self.send_overflows = 0
        self._reader_drops_closed = 0  # drops of already-closed readers
        # Inbound wire-capture ring (obs/audit.py plane, served on
        # /capturez, replayed by tools/capture_replay.py): a bounded
        # deque of (mono_ns, peer sign hex, first kind byte, frame hex)
        # records taken at the delivery boundary on BOTH inbound planes.
        # Kill-switched like the flight recorder: capture_cap=0 keeps the
        # hot path at a single attribute check.
        self.capture_cap = capture_cap
        self._capture = deque(maxlen=capture_cap) if capture_cap > 0 else None
        self.captured = 0  # cumulative frames captured (past the ring)

    def stats(self) -> dict:
        return {
            "channels": len(self._channels) + len(self._native_by_fd),
            "send_queue_depth": sum(
                q.qsize() for q in self._send_queues.values()
            ),
            "redials": self.redials,
            "dial_failures": self.dial_failures,
            "peer_reconnects": self.peer_reconnects,
            "send_overflows": self.send_overflows,
            "native_readers": len(self._native_by_fd),
            # cumulative like send_overflows: closed channels' drops must
            # not vanish from the operator's failure-detection signal
            "reader_drops": self._reader_drops_closed
            + sum(e[4] for e in self._native_by_fd.values()),
            "captured": self.captured,
        }

    def _capture_frame(self, peer: Peer, frame: bytes) -> None:
        self.captured += 1
        self._capture.append(
            (
                int(self.clock.monotonic() * 1e9),
                peer.sign_public.hex(),
                frame[0] if frame else 0,
                frame.hex(),
            )
        )

    def capture_dump(self) -> dict:
        """Snapshot of the inbound wire-capture ring (served on
        /capturez; the input format of tools/capture_replay.py)."""
        return {
            "cap": self.capture_cap,
            "captured": self.captured,
            "records": [list(r) for r in (self._capture or ())],
        }

    async def start(self) -> None:
        from ..native.reader import reader_available

        self._loop = asyncio.get_running_loop()
        host, _, port = self.listen_addr.rpartition(":")
        # reader_available() may run the library's first g++ build
        # (seconds): off the loop, so the node's other actors keep running
        if await self._loop.run_in_executor(None, reader_available):
            # native inbound plane: the listen socket is accepted manually
            # so the connection's fd can be handed to a C++ reader thread
            # wholesale after the handshake (asyncio never owns its
            # stream buffers). An EXPLICIT host resolves via getaddrinfo
            # like asyncio.start_server would (hostname/IPv6 listen_addrs
            # behave the same on both planes; first result wins — the
            # single-socket bind vs start_server's multi-bind is the one
            # documented divergence). An empty host keeps the historical
            # IPv4-any wildcard: getaddrinfo's wildcard ordering is
            # platform-dependent and an AF_INET6-first result with
            # bindv6only set would silently stop accepting IPv4 peers.
            if host:
                infos = await self._loop.getaddrinfo(
                    host,
                    int(port),
                    type=socket_mod.SOCK_STREAM,
                    flags=socket_mod.AI_PASSIVE,
                )
                family, stype, proto, _, sockaddr = infos[0]
            else:
                family, stype, proto = (
                    socket_mod.AF_INET, socket_mod.SOCK_STREAM, 0
                )
                sockaddr = ("0.0.0.0", int(port))
            s = socket_mod.socket(family, stype, proto)
            s.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_REUSEADDR, 1)
            s.bind(sockaddr)
            s.listen(128)
            s.setblocking(False)
            self._listen_sock = s
            self._tasks.append(
                asyncio.create_task(self._native_accept_loop())
            )
        else:
            self._server = await asyncio.start_server(
                self._handle_inbound, host or "0.0.0.0", int(port)
            )
        for peer in self.peers:
            self._start_outbound(peer)

    def _start_outbound(self, peer: Peer) -> None:
        q: asyncio.Queue = asyncio.Queue(maxsize=SEND_QUEUE_CAP)
        self._send_queues[peer.exchange_public] = q
        self._outbound_tasks[peer.exchange_public] = asyncio.create_task(
            self._outbound_loop(peer, q)
        )

    async def close(self) -> None:
        self._closed = True
        tasks = self._tasks + list(self._outbound_tasks.values())
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._tasks.clear()
        self._outbound_tasks.clear()
        for channel in list(self._channels):
            channel.close()
        self._channels.clear()
        for rfd in list(self._native_by_fd):
            self._native_close(rfd)
        if self._listen_sock is not None:
            self._listen_sock.close()
            self._listen_sock = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- membership (node/membership.py epoch transitions) -----------------

    def add_peer(self, peer: Peer) -> bool:
        """Register a peer joining the mesh (epoch reconfiguration). If
        the mesh is already running, its outbound dialer starts
        immediately; inbound connections authenticate as soon as the key
        is registered. Returns False for self or an already-known key."""
        if (
            peer.exchange_public == self.keypair.public
            or peer.exchange_public in self.by_exchange
        ):
            return False
        self.peers.append(peer)
        self.by_exchange[peer.exchange_public] = peer
        self.by_sign[peer.sign_public] = peer
        if self._loop is not None and not self._closed:
            self._start_outbound(peer)
        return True

    def remove_peer(self, sign_public: bytes) -> bool:
        """Evict a peer (epoch reconfiguration): cancel its outbound
        dialer, drop its queue, and forget its keys — NEW inbound
        handshakes from it are rejected like any unknown key. Channels
        it already holds drain until they close (the epoch grace window;
        stack-level epoch checks reject its stale messages meanwhile)."""
        peer = self.by_sign.pop(sign_public, None)
        if peer is None:
            return False
        self.by_exchange.pop(peer.exchange_public, None)
        self.peers = [
            p for p in self.peers
            if p.exchange_public != peer.exchange_public
        ]
        self._send_queues.pop(peer.exchange_public, None)
        task = self._outbound_tasks.pop(peer.exchange_public, None)
        if task is not None:
            task.cancel()
        return True

    # -- sending ----------------------------------------------------------

    def send(self, peer: Peer, frame: bytes) -> None:
        """Queue a frame for one peer; never blocks (best-effort plane)."""
        q = self._send_queues.get(peer.exchange_public)
        if q is None:
            return
        while True:
            try:
                q.put_nowait(frame)
                return
            except asyncio.QueueFull:
                try:  # drop the oldest queued frame and retry
                    q.get_nowait()
                    self.send_overflows += 1
                    logger.warning("send queue overflow to %s", peer.address)
                except asyncio.QueueEmpty:
                    pass

    def broadcast(self, frame: bytes, exclude: Iterable[bytes] = ()) -> None:
        skip = set(exclude)
        peers = self._fanout_order() if self.region_fanout else self.peers
        for peer in peers:
            if peer.exchange_public not in skip:
                self.send(peer, frame)

    def _fanout_order(self) -> List[Peer]:
        """Peers nearest-first: same-region (when both hints are set)
        before cross-region, measured RTT EWMA within each tier, config
        order as the stable tiebreak (sort stability keeps unmeasured
        peers in declared order)."""
        def key(p: Peer):
            far = 0 if (
                self.region and p.region and p.region == self.region
            ) else 1
            return (far, self._rtt_ewma.get(p.exchange_public, float("inf")))

        return sorted(self.peers, key=key)

    # -- connection maintenance -------------------------------------------

    async def _outbound_loop(self, peer: Peer, q: asyncio.Queue) -> None:
        import random

        backoff = 0.1
        host, port = peer.host_port()
        pending: Optional[List[bytes]] = None  # batch to resend after redial
        held: Optional[bytes] = None  # message deferred to the next frame
        dropped = False  # an established channel was lost (for reconnects)
        while not self._closed:
            # full jitter on the backoff sleep: N peers dropping together
            # (a switch reboot) must not re-dial in lockstep
            def nap() -> float:
                return backoff * random.uniform(0.5, 1.0)

            dial_t0 = self.clock.monotonic()
            try:
                channel = await transport.connect(host, port, self.keypair)
            except (OSError, transport.HandshakeError, asyncio.TimeoutError):
                self.dial_failures += 1
                await self.clock.sleep(nap())
                backoff = min(backoff * 2, 5.0)
                continue
            if channel.peer_public != peer.exchange_public:
                logger.warning(
                    "peer %s presented unexpected key %s",
                    peer.address,
                    channel.peer_public.hex(),
                )
                self.dial_failures += 1
                channel.close()
                await self.clock.sleep(nap())
                backoff = min(backoff * 2, 5.0)
                continue
            # the dial (TCP connect + X25519 handshake) is a live RTT
            # sample; EWMA it for region-aware fanout ordering
            rtt = self.clock.monotonic() - dial_t0
            prev_rtt = self._rtt_ewma.get(peer.exchange_public)
            self._rtt_ewma[peer.exchange_public] = (
                rtt if prev_rtt is None else 0.8 * prev_rtt + 0.2 * rtt
            )
            if dropped:
                self.peer_reconnects += 1
                dropped = False
            backoff = 0.1
            self._channels.add(channel)
            try:
                while True:
                    if pending is None:
                        first = held if held is not None else await q.get()
                        held = None
                        batch = [first]
                        size = len(first)
                        # drain whatever accumulated while the last frame
                        # was in flight (bounded: the frame never exceeds
                        # MAX_BATCH_BYTES — an overflowing message is held
                        # for the next frame, not appended)
                        while len(batch) < MAX_BATCH_MSGS:
                            try:
                                m = q.get_nowait()
                            except asyncio.QueueEmpty:
                                break
                            if size + len(m) > MAX_BATCH_BYTES:
                                held = m
                                break
                            batch.append(m)
                            size += len(m)
                        pending = batch
                    await channel.send(b"".join(pending))
                    pending = None
            except (transport.ChannelClosed, ConnectionError):
                self.redials += 1
                dropped = True
                logger.warning("connection to %s dropped; redialing", peer.address)
            finally:
                channel.close()
                self._channels.discard(channel)

    # -- native inbound plane (C++ reader threads) ------------------------

    async def _native_accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _addr = await self._loop.sock_accept(self._listen_sock)
            except (OSError, asyncio.CancelledError):
                return
            task = asyncio.create_task(self._native_inbound(sock))
            self._tasks.append(task)
            # prune on completion: inbound churn (a flapping peer
            # redialing for days) must not grow _tasks without bound
            task.add_done_callback(
                lambda t: self._tasks.remove(t) if t in self._tasks else None
            )

    async def _native_handshake(self, sock) -> tuple:
        """Responder handshake over the raw socket — same hello exchange
        as transport.accept (key derivation shared via
        transport.responder_session_keys), but leaving the socket's
        kernel buffer untouched past the 64 hello bytes so the C++
        reader starts from frame 0."""
        own_nonce = os.urandom(32)
        await self._loop.sock_sendall(sock, self.keypair.public + own_nonce)
        hello = b""
        while len(hello) < 64:
            chunk = await self._loop.sock_recv(sock, 64 - len(hello))
            if not chunk:
                raise transport.HandshakeError("peer closed during handshake")
            hello += chunk
        peer_public, k_i2r, _ = transport.responder_session_keys(
            self.keypair, own_nonce, hello
        )
        return peer_public, k_i2r

    async def _native_inbound(self, sock) -> None:
        from ..native.reader import NativeChannelReader

        sock.setblocking(False)
        try:
            peer_public, recv_key = await asyncio.wait_for(
                self._native_handshake(sock), 5.0
            )
        except (
            transport.HandshakeError,
            asyncio.TimeoutError,
            OSError,
            ConnectionError,
        ):
            sock.close()
            return
        except BaseException:
            # cancellation from Mesh.close() mid-handshake: the accepted
            # socket must not leak to GC finalization
            sock.close()
            raise
        peer = self.by_exchange.get(peer_public)
        if peer is None:
            logger.warning(
                "rejecting connection from unknown key %s", peer_public.hex()
            )
            sock.close()
            return
        # the C++ thread does blocking reads; the handshake needed the
        # socket non-blocking for the asyncio sock_* calls
        sock.setblocking(True)
        rfd, wfd = os.pipe()
        os.set_blocking(rfd, False)
        os.set_blocking(wfd, False)
        rdr = NativeChannelReader(sock.fileno(), recv_key, wfd)
        # entry: [peer, reader, sock, wake_write_fd, drops, last_delivery]
        self._native_by_fd[rfd] = [peer, rdr, sock, wfd, 0, None]
        self._loop.add_reader(rfd, self._native_wake, rfd)

    def _native_wake(self, rfd: int) -> None:
        """One wakeup per frame BATCH: drain the pipe, take every queued
        frame, deliver them through the normal on_frame path. Each
        delivery task CHAINS on the connection's previous one, so
        per-connection frame ordering holds even if on_frame ever gains
        an internal await (it currently doesn't — but ordering must not
        depend on that non-local property)."""
        from ..native.reader import STATUS_OPEN

        entry = self._native_by_fd.get(rfd)
        if entry is None:
            return
        peer, rdr, _sock, _wfd, _, prev = entry
        try:
            os.read(rfd, 65536)
        except (BlockingIOError, OSError):
            pass
        frames: list = []
        while True:
            batch, status, drops = rdr.take()
            frames.extend(batch)
            if not batch:
                break
        entry[4] = drops
        if frames:
            task = asyncio.ensure_future(
                self._deliver_frames(peer, frames, prev)
            )
            task.add_done_callback(self._log_deliver_error)
            entry[5] = task
        if status != STATUS_OPEN:
            # eof or protocol/decrypt failure: channel-fatal, normal drop
            # (the initiating side redials; same semantics as
            # transport.ChannelClosed on the asyncio path)
            self._native_close(rfd)

    async def _deliver_frames(
        self, peer: Peer, frames: list, prev: Optional[asyncio.Future] = None
    ) -> None:
        if prev is not None and not prev.done():
            try:
                await prev  # serialize behind the connection's last batch
            except Exception:
                pass  # already logged by its own done-callback
        for frame in frames:
            if self._capture is not None:
                self._capture_frame(peer, frame)
            await self.on_frame(peer, frame)

    @staticmethod
    def _log_deliver_error(task) -> None:
        if not task.cancelled() and task.exception() is not None:
            logger.exception(
                "inbound frame delivery failed", exc_info=task.exception()
            )

    def _native_close(self, rfd: int) -> None:
        entry = self._native_by_fd.pop(rfd, None)
        if entry is None:
            return
        _peer, rdr, sock, wfd, drops, _prev = entry
        self._reader_drops_closed += drops
        self._loop.remove_reader(rfd)
        rdr.stop()
        os.close(rfd)
        os.close(wfd)
        sock.close()

    async def _handle_inbound(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            channel = await transport.accept(reader, writer, self.keypair)
        except (transport.HandshakeError, asyncio.TimeoutError, OSError):
            writer.close()
            return
        peer = self.by_exchange.get(channel.peer_public)
        if peer is None:
            logger.warning(
                "rejecting connection from unknown key %s",
                channel.peer_public.hex(),
            )
            channel.close()
            return
        self._channels.add(channel)
        try:
            while True:
                frame = await channel.recv()
                if self._capture is not None:
                    self._capture_frame(peer, frame)
                await self.on_frame(peer, frame)
        except (transport.ChannelClosed, ConnectionError):
            pass
        except Exception:
            logger.exception("inbound handler error from %s", peer.address)
        finally:
            channel.close()
            self._channels.discard(channel)
