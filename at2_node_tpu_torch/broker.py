"""Untrusted broker ingress tier (Chop Chop-style batch distillation).

Counterpart of ``at2_node_tpu/broker.py``.

The broker sits between clients and a node and converts many small
per-transfer submissions into few distilled `SendDistilledBatch` frames
(proto/distill.py): sorted delta-coded client-ids, deduped senders,
columnar signatures. It serves the same `at2.AT2` gRPC surface a node
does, so existing clients point at a broker unmodified — submissions are
collected, everything else proxies through to the node.

Trust argument (TECHNICAL.md "Directory & broker ingress"): the broker
is OUTSIDE the trust boundary. Every entry it forwards is signed by its
client over the v2 tagged transfer form (types.py
``transfer_signing_bytes``) which binds sender AND sequence — so a
captured signature is valid for exactly one ledger slot, and the broker
cannot re-encode it at another sequence to spend again (nor, of course,
alter recipient or amount). The node verifies per entry against the
gossiped directory; what remains to a byzantine broker is liveness-only:
withhold, reorder, or duplicate-within-one-slot (bounded by the node's
dedup memory and the ledger's per-account sequence gate). It also cannot
shift blame for bad signatures onto other clients: admission buckets at
the node are keyed by CLIENT id, not broker identity.

The broker auto-registers unknown sender keys via the node's `Register`
RPC and compresses recipient keys to directory ids when it knows them,
so a warmed-up broker emits near-minimal frames.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Dict, List, Optional

import grpc

from .client import _target
from .crypto.keys import SignKeyPair  # noqa: F401  (re-export for runners)
from .net.webmux import PortMux
from .node.config import OverloadConfig
from .node.overload import broker_retry_after_ms, format_shed_details
from .obs.recorder import FlightRecorder
from .obs.registry import Registry
from .obs.trace import TxTrace
from .proto import at2_pb2 as pb
from .proto import distill
from .proto.rpc import At2Servicer, At2Stub, add_to_server

logger = logging.getLogger(__name__)

# Entries buffered while the node is unreachable or frame building lags.
# Beyond the cap new submissions are refused (RESOURCE_EXHAUSTED) — an
# unbounded buffer would turn a dead node into broker OOM.
PENDING_CAP = 1 << 16

# /healthz flips to "degraded" when the pending buffer crosses this
# fraction of PENDING_CAP: overflow refusals are imminent, so fleet
# tooling (top.py --once) should gate BEFORE clients start seeing
# RESOURCE_EXHAUSTED, not after.
BACKPRESSURE_FRAC = 0.75

# [wan] eager flush never shrinks the deadline below this fraction of
# the configured window: a lone straggler still gets a quarter window
# of batching opportunity instead of flushing as a singleton frame.
EAGER_MIN_FRAC = 0.25


class Broker(At2Servicer):
    """One broker. `await Broker.start(...)`, then `serve_forever`."""

    def __init__(
        self,
        node_uri: str,
        *,
        max_entries: int = distill.DISTILL_MAX_ENTRIES,
        window: float = 0.005,
        eager: bool = False,
        clock=None,
        trace_sample: int = 1,
        recorder_cap: int = 2048,
        overload: Optional[OverloadConfig] = None,
    ) -> None:
        from .clock import SYSTEM_CLOCK

        if not (1 <= max_entries <= distill.DISTILL_MAX_ENTRIES):
            raise ValueError(
                f"max_entries must be in [1, {distill.DISTILL_MAX_ENTRIES}]"
            )
        self.node_uri = node_uri
        self.max_entries = max_entries
        self.window = window
        # graduated brownout ([overload], node/overload.py): above
        # brownout_frac of PENDING_CAP flush deadlines shrink (the eager
        # machinery below), above refuse_frac new submissions are
        # refused with a retry-after hint — the drop-at-cap cliff
        # becomes a ladder. None/disabled keeps the historical behavior
        # (hard cap only), though refusals are typed either way.
        self.overload = overload if overload is not None and overload.enabled \
            else None
        self._retry_cfg = overload if overload is not None else OverloadConfig()
        # [wan] eager flush: anchor the flush deadline to the FIRST entry
        # of the pending batch instead of restarting a full window on
        # every delayed-flush cycle, and shrink it as the buffer fills —
        # a near-full buffer has little batching left to gain from
        # waiting, so it ships early. Off (default) keeps the fixed
        # window verbatim.
        self.eager = eager
        self._first_at = 0.0
        self.clock = SYSTEM_CLOCK if clock is None else clock
        self._channel = grpc.aio.insecure_channel(_target(node_uri))
        self._stub = At2Stub(self._channel)
        self._ids: Dict[bytes, int] = {}  # pubkey -> directory client-id
        self._keys: Dict[int, bytes] = {}  # directory client-id -> pubkey
        self._buf: List[distill.DistilledEntry] = []
        self._flush_task: Optional[asyncio.Task] = None
        self._closing = False
        self._grpc_server: Optional[grpc.aio.Server] = None
        self._mux: Optional[PortMux] = None
        self._started_at = self.clock.monotonic()
        self._health_was_ok = True

        self.registry = Registry()
        self.stats = self.registry.counter_group(
            (
                "broker_entries_rx",  # transfers accepted into the buffer
                "broker_entries_tx",  # transfers forwarded inside frames
                "broker_batches_tx",  # distilled frames forwarded
                "broker_dedup_drops",  # (id, seq) dups dropped at build
                "broker_overflow_drops",  # hard-shed: buffer hit PENDING_CAP
                "broker_refusals",  # refused BEFORE buffering (retryable)
                "broker_forward_errors",  # SendDistilledBatch RPC failures
                "broker_registrations",  # Register round-trips to the node
                "broker_eager_flushes",  # flushes taken on the eager path
                "broker_brownout_flushes",  # deadline-shrunk brownout flushes
            )
        )
        # seconds from flush trigger to frame handed to the RPC stack:
        # the distillation cost a broker adds over direct submission
        self.h_build = self.registry.histogram(
            "broker_build_latency", "distilled frame build seconds"
        )
        self.registry.gauge(
            "broker_pending", "entries buffered awaiting a flush",
            fn=lambda: len(self._buf),
        )
        self.registry.gauge(
            "broker_directory_known", "client ids cached from Register",
            fn=lambda: len(self._ids),
        )
        self.registry.register_provider(
            "rpc_",
            lambda: self._mux.stats() if self._mux is not None else {},
        )
        # Relay-only lifecycle tracer: the broker never calls begin() —
        # broker_rx/broker_flush stamps open relay spans via the SAME
        # keyed lottery the nodes use, so trace_collect joins the
        # client→broker→node→commit timeline fleet-wide. Custody ends at
        # flush, so records retire there and populate GET /tracez.
        self.tx_trace = TxTrace(
            self.registry,
            sample_every=trace_sample,
            clock=self.clock,
            retire_at="broker_flush",
        )
        # Black box for the broker's only two interesting decisions:
        # when it flushed (and how big) and when it pushed back.
        self.recorder = FlightRecorder(cap=recorder_cap, clock=self.clock)
        self.registry.gauge(
            "recorder_events", "flight-recorder events currently in the ring",
            fn=lambda: self.recorder.recorded,
        )
        self.registry.gauge(
            "recorder_snapshots", "flight-recorder snapshots frozen",
            fn=lambda: self.recorder.snapshots_taken,
        )

    # -- lifecycle --------------------------------------------------------

    @staticmethod
    async def start(
        node_uri: str,
        listen: str,
        *,
        max_entries: int = distill.DISTILL_MAX_ENTRIES,
        window: float = 0.005,
        eager: bool = False,
        clock=None,
        overload: Optional[OverloadConfig] = None,
    ) -> "Broker":
        """Bring up a broker serving `at2.AT2` on ``listen`` (same
        PortMux surface as a node: native gRPC + grpc-web + GET
        /metrics), collecting for the node at ``node_uri``."""
        broker = Broker(
            node_uri, max_entries=max_entries, window=window, eager=eager,
            clock=clock, overload=overload,
        )
        try:
            server = grpc.aio.server()
            add_to_server(broker, server)
            broker._grpc_server = server
            internal_port = server.add_insecure_port("127.0.0.1:0")
            if internal_port == 0:
                raise OSError("cannot bind internal grpc port")
            await server.start()
            broker._mux = PortMux(listen, internal_port, broker)
            try:
                await broker._mux.start()
            except OSError as exc:
                raise OSError(f"cannot bind broker address {listen}") from exc
        except BaseException:
            await broker.close()
            raise
        logger.info("broker up: rpc on %s -> node %s", listen, node_uri)
        return broker

    async def serve_forever(self) -> None:
        await self._grpc_server.wait_for_termination()

    async def close(self) -> None:
        self._closing = True
        if self._mux is not None:
            await self._mux.close()
        if self._grpc_server is not None:
            try:
                await self._grpc_server.stop(grace=0.5)
            except Exception:
                logger.exception("broker grpc server stop failed")
        if self._flush_task is not None:
            self._flush_task.cancel()
            try:
                await self._flush_task
            except asyncio.CancelledError:
                pass
        # best-effort final flush: like a node's ingress buffer, ACKed
        # submissions are not commit receipts and may drop on shutdown,
        # but draining what we can costs one RPC
        if self._buf:
            try:
                await self._flush()
            except Exception:
                logger.exception("broker final flush failed")
        await self._channel.close()

    # -- observability (PortMux GET surface, duck-typed) ------------------

    _OBS_JSON = "application/json; charset=utf-8"
    _OBS_PROM = "text/plain; version=0.0.4; charset=utf-8"

    def health_verdict(self) -> dict:
        """Liveness + backpressure verdict. A broker has no quorum to
        watch; what can go wrong is exactly one thing — the pending
        buffer filling because the node is unreachable or lagging — so
        "degraded" means overflow refusals are imminent
        (pending >= BACKPRESSURE_FRAC * PENDING_CAP). Transitions out of
        "ok" freeze a flight-recorder snapshot, same edge-trigger
        contract as the node."""
        pending = len(self._buf)
        ratio = pending / PENDING_CAP
        backpressure = pending >= int(PENDING_CAP * BACKPRESSURE_FRAC)
        brownout = (
            self.overload is not None and ratio >= self.overload.brownout_frac
        )
        if self._closing:
            status = "closing"
        elif backpressure:
            status = "degraded"
        elif brownout:
            # deadline-shrinking/refusing but still serving: the
            # "overloaded" grade is NOT a 503 — pulling a browning-out
            # broker from rotation only concentrates the crowd
            status = "overloaded"
        else:
            status = "ok"
        ok = status in ("ok", "overloaded")
        if self._health_was_ok and not ok:
            self.recorder.snapshot(f"broker_degraded:{status}")
        self._health_was_ok = ok
        return {
            "status": status,
            "role": "broker",
            "node": self.node_uri,
            "pending": pending,
            "pending_cap": PENDING_CAP,
            "backpressure": backpressure,
            "pressure": round(ratio, 4),
            "brownout": brownout,
            "flush_p99_ms": self.h_build.snapshot()["p99_ms"],
            "uptime_s": round(self.clock.monotonic() - self._started_at, 3),
        }

    def pressure_block(self) -> dict:
        """The /statusz ``pressure`` block, broker flavor: the broker's
        only pressure signal is its buffer-fill ratio, so the block is
        the ladder position derived from it."""
        ratio = len(self._buf) / PENDING_CAP
        ov = self.overload
        if self._closing:
            level = "closing"
        elif ratio >= 1.0:
            level = "saturated"
        elif ov is not None and ratio >= ov.refuse_frac:
            level = "refusing"
        elif ov is not None and ratio >= ov.brownout_frac:
            level = "brownout"
        else:
            level = "normal"
        return {
            "enabled": ov is not None,
            "pressure": round(ratio, 4),
            "level": level,
            "retry_after_ms": broker_retry_after_ms(self._retry_cfg, ratio),
            "brownout_frac": self._retry_cfg.brownout_frac,
            "refuse_frac": self._retry_cfg.refuse_frac,
        }

    def tracez(self, limit: int | None = None) -> dict:
        """Broker-side trace dump in the shape trace_collect expects
        (one dump per party, keyed by a fleet-unique "node" label)."""
        out = self.tx_trace.tracez(limit)
        out["node"] = f"broker:{self.node_uri}"
        out["clock"] = {
            "monotonic": round(self.clock.monotonic(), 9),
            "wall": round(self.clock.wall(), 9),
        }
        return out

    def obs_http(self, path: str):
        route, _, query = path.partition("?")
        if route == "/metrics":
            return 200, self._OBS_PROM, self.registry.render_prometheus().encode()
        if route == "/healthz":
            verdict = self.health_verdict()
            status = 200 if verdict["status"] in ("ok", "overloaded") else 503
            return status, self._OBS_JSON, json.dumps(verdict, sort_keys=True).encode()
        if route == "/statusz":
            body = json.dumps(
                {
                    "role": "broker",
                    "health": self.health_verdict(),
                    "pressure": self.pressure_block(),
                    "flush": self.h_build.snapshot(),
                    "stats": self.registry.snapshot(),
                },
                sort_keys=True,
                default=float,
            ).encode()
            return 200, self._OBS_JSON, body
        if route == "/tracez":
            limit = None
            if query.startswith("limit="):
                try:
                    limit = int(query[6:])
                except ValueError:
                    limit = None
            body = json.dumps(
                self.tracez(limit), sort_keys=True, default=float
            ).encode()
            return 200, self._OBS_JSON, body
        if route == "/debugz":
            body = json.dumps(
                {
                    "node": f"broker:{self.node_uri}",
                    "recorder": self.recorder.dump(),
                },
                sort_keys=True,
                default=float,
            ).encode()
            return 200, self._OBS_JSON, body
        return None

    # -- collection -------------------------------------------------------

    async def _client_id(self, pubkey: bytes) -> int:
        """The directory id for ``pubkey``, registering it with the node
        on first sight. Concurrent first-sights race benignly: Register
        is idempotent on the node, last writer caches the same id."""
        cid = self._ids.get(pubkey)
        if cid is None:
            reply = await self._stub.Register(
                pb.RegisterRequest(public_key=pubkey)
            )
            cid = int(reply.client_id)
            self._ids[pubkey] = cid
            self._keys[cid] = pubkey
            self.stats["broker_registrations"] += 1
        return cid

    def _refuse_retry_ms(self) -> int:
        return broker_retry_after_ms(
            self._retry_cfg, len(self._buf) / PENDING_CAP
        )

    async def _collect(self, requests, context) -> None:
        if self._closing:
            await context.abort(
                grpc.StatusCode.UNAVAILABLE, "broker shutting down"
            )
        # graduated refusal ([overload]): above refuse_frac the broker
        # turns submissions away with a typed retry-after BEFORE riding
        # into the hard cap — refusals are retryable and cheap, cap hits
        # mean work already interleaved past the ladder
        if (
            self.overload is not None
            and len(self._buf) >= int(PENDING_CAP * self.overload.refuse_frac)
        ):
            self.stats["broker_refusals"] += len(requests)
            retry_ms = self._refuse_retry_ms()
            self.recorder.record(
                "brownout_refuse", (len(requests), len(self._buf), retry_ms)
            )
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                format_shed_details(
                    "broker refusing under brownout", retry_ms
                ),
            )
        if len(self._buf) + len(requests) > PENDING_CAP:
            # refused before any buffering or register round-trips:
            # retryable, counted apart from hard sheds
            self.stats["broker_refusals"] += len(requests)
            retry_ms = self._refuse_retry_ms()
            self.recorder.record(
                "backpressure", (len(requests), len(self._buf))
            )
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                format_shed_details(
                    "broker buffer full; node unreachable or lagging",
                    retry_ms,
                ),
            )
        entries = []
        for i, req in enumerate(requests):
            where = f" (entry {i})" if len(requests) > 1 else ""
            if len(req.sender) != 32 or len(req.recipient) != 32:
                await context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"keys must be 32 bytes{where}",
                )
            if len(req.signature) != 64:
                await context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"signature must be 64 bytes{where}",
                )
            cid = await self._client_id(bytes(req.sender))
            # recipient compression is opportunistic: ids we happen to
            # know shrink the frame; unknown recipients ride raw (the
            # node never needs the recipient in its directory)
            recipient = self._ids.get(bytes(req.recipient), bytes(req.recipient))
            entries.append(
                distill.DistilledEntry(
                    sender_id=cid,
                    sequence=req.sequence,
                    recipient=recipient,
                    amount=req.amount,
                    signature=bytes(req.signature),
                )
            )
        # re-check occupancy AFTER the awaits above: concurrent _collect
        # calls can each pass the entry check and then interleave at the
        # Register round-trips, so only a check with no await point
        # between it and the extend actually enforces PENDING_CAP. This
        # is the hard-shed path — work was already performed for these
        # entries — counted apart from the pre-buffer refusals above.
        if len(self._buf) + len(entries) > PENDING_CAP:
            self.stats["broker_overflow_drops"] += len(entries)
            retry_ms = self._refuse_retry_ms()
            self.recorder.record(
                "backpressure", (len(entries), len(self._buf))
            )
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                format_shed_details(
                    "broker buffer full; node unreachable or lagging",
                    retry_ms,
                ),
            )
        if not self._buf:
            # empty -> non-empty transition: this batch's age clock
            # starts now (the eager deadline is measured from here)
            self._first_at = self.clock.monotonic()
        self._buf.extend(entries)
        self.stats["broker_entries_rx"] += len(entries)
        # the raw request still has the sender pubkey in hand here, so
        # this is the cheapest place to open the broker-hop relay span
        for req in requests:
            self.tx_trace.stamp(
                (bytes(req.sender), int(req.sequence)), "broker_rx"
            )
        if len(self._buf) >= self.max_entries:
            await self._flush()
        elif self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.create_task(self._delayed_flush())

    async def _delayed_flush(self) -> None:
        while True:
            depth = len(self._buf)
            # brownout ([overload]): a buffer past brownout_frac of the
            # cap has nothing left to gain from batching patience —
            # shrink the effective window toward zero as fill deepens,
            # riding the same anchored-deadline machinery as eager
            brownout = (
                self.overload is not None
                and depth >= int(PENDING_CAP * self.overload.brownout_frac)
            )
            shrink = (
                max(0.05, 1.0 - depth / PENDING_CAP) if brownout else 1.0
            )
            if self.eager or brownout:
                # queue-depth-adaptive deadline anchored to the batch's
                # first entry: deep buffers flush sooner (less batching
                # upside left), and time already spent buffered counts
                # against the deadline instead of restarting it
                frac = max(
                    EAGER_MIN_FRAC, 1.0 - depth / self.max_entries
                )
                elapsed = self.clock.monotonic() - self._first_at
                delay = frac * self.window * shrink - elapsed
                if delay > 0.0:
                    await self.clock.sleep(delay)
                if self.eager:
                    self.stats["broker_eager_flushes"] += 1
                if brownout:
                    self.stats["broker_brownout_flushes"] += 1
            else:
                await self.clock.sleep(self.window)
            await self._flush()
            if not self._buf:
                return

    async def _flush(self) -> None:
        """Distill and forward the buffered entries, one frame per
        max_entries chunk. Snapshot-at-entry like the node's batcher:
        entries arriving while a forward is awaited wait for their own
        trigger instead of leaking into this flush."""
        buf, self._buf = self._buf, []
        if buf:
            self.recorder.record("flush", (len(buf),))
        for lo in range(0, len(buf), self.max_entries):
            chunk = buf[lo : lo + self.max_entries]
            t0 = self.clock.monotonic()
            frame, dropped = distill.distill(chunk)
            self.h_build.observe(self.clock.monotonic() - t0)
            # DistilledEntry only carries the directory id; the reverse
            # map recovers the (pubkey, seq) trace key so the flush
            # stamp joins the span opened at broker_rx
            for e in chunk:
                pub = self._keys.get(e.sender_id)
                if pub is not None:
                    self.tx_trace.stamp((pub, e.sequence), "broker_flush")
            if dropped:
                self.stats["broker_dedup_drops"] += dropped
                self.recorder.record("dedup_drop", (dropped,))
            try:
                await self._stub.SendDistilledBatch(
                    pb.SendDistilledBatchRequest(frame=frame)
                )
            except grpc.aio.AioRpcError as exc:
                # fire-and-forget past this point, like a node dropping
                # its ingress buffer on shutdown: ACK was never a commit
                # receipt. The counter (and /metrics) carries the loss.
                self.stats["broker_forward_errors"] += 1
                self.recorder.record(
                    "forward_error", (str(exc.code()), len(chunk))
                )
                logger.warning(
                    "distilled forward failed (%s): %s",
                    exc.code(),
                    exc.details(),
                )
                continue
            self.stats["broker_batches_tx"] += 1
            self.stats["broker_entries_tx"] += len(chunk) - dropped

    # -- gRPC surface -----------------------------------------------------

    async def SendAsset(self, request, context):
        await self._collect([request], context)
        return pb.SendAssetReply()

    async def SendAssetBatch(self, request, context):
        if not request.transactions:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "empty batch"
            )
        await self._collect(list(request.transactions), context)
        return pb.SendAssetReply()

    async def Register(self, request, context):
        """Proxy: clients may pre-register through the broker (warms the
        broker's id cache as a side effect)."""
        reply = await self._stub.Register(request)
        if len(request.public_key) == 32:
            self._ids[bytes(request.public_key)] = int(reply.client_id)
            self._keys[int(reply.client_id)] = bytes(request.public_key)
        return reply

    async def SendDistilledBatch(self, request, context):
        """Pass-through: a pre-distilled frame needs no collection. A
        node-side refusal (overload shed, RESOURCE_EXHAUSTED) re-aborts
        with the SAME code and detail string, so the typed
        ``retry_after_ms`` hint survives the hop instead of collapsing
        into a generic INTERNAL error."""
        try:
            return await self._stub.SendDistilledBatch(request)
        except grpc.aio.AioRpcError as exc:
            await context.abort(exc.code(), exc.details() or "")

    async def GetBalance(self, request, context):
        return await self._stub.GetBalance(request)

    async def GetLastSequence(self, request, context):
        return await self._stub.GetLastSequence(request)

    async def GetLatestTransactions(self, request, context):
        return await self._stub.GetLatestTransactions(request)
