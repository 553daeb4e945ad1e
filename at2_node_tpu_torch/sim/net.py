"""SimNet: an n-node f-tolerant network of REAL ``Service`` cores on a
virtual clock and simulated fabric, plus the AT2 invariant checker.

Counterpart of ``at2_node_tpu/sim/net.py``.

The services here are not mocks: the full bring-up path runs (broadcast
planes, delivery→commit loop, catchup runner, admission), with exactly
three substitutions via ``Service.start``'s simulator seams — the
virtual clock, a ``SimMesh`` in place of the socket mesh, and
``serve_rpc=False`` (client traffic enters through the real
``SendAsset`` handler called with a simulated gRPC context, so
validation and admission still run).

Keys, catchup nonces, and all fabric randomness derive from the net's
seed; under ``SimScheduler`` the entire run is a pure function of
``(seed, config, events)``.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import random
import shutil
import tempfile
from typing import Dict, List, Optional

from ..broadcast.messages import ConfigTx
from ..crypto.keys import ExchangeKeyPair, SignKeyPair
from ..crypto.verifier import CpuVerifier
from ..net.peers import Peer
from ..node.config import Config, MembershipConfig, StoreConfig, VerifierConfig
from ..node.service import Service
from ..proto import at2_pb2 as pb
from ..types import transfer_signing_bytes
from .fabric import LinkModel, SimFabric, SimMesh
from .scheduler import SimClock, SimScheduler


class InvariantViolation(AssertionError):
    """An AT2 safety property failed; carries all violation strings."""

    def __init__(self, violations: List[str]):
        super().__init__("; ".join(violations))
        self.violations = violations


class SimRpcError(Exception):
    """What ``context.abort`` raises in the sim (mirrors grpc's
    AbortError: the handler never resumes past an abort)."""

    def __init__(self, code, details: str = ""):
        super().__init__(f"{code}: {details}")
        self.code = code
        self.details = details


class _SimContext:
    """The slice of the grpc.aio servicer context the handlers use."""

    def __init__(self, source: str):
        self._source = source

    def peer(self) -> str:
        return self._source

    async def abort(self, code, details: str = "") -> None:
        raise SimRpcError(code, details)


def sim_keypairs(seed: int, i: int):
    """Deterministic node identity i for a given net seed."""
    import hashlib

    sk = hashlib.sha256(f"at2-sim-sign-{seed}-{i}".encode()).digest()
    xk = hashlib.sha256(f"at2-sim-xchg-{seed}-{i}".encode()).digest()
    return SignKeyPair(sk), ExchangeKeyPair(xk)


def sim_client(seed: int, i: int) -> SignKeyPair:
    """Deterministic client identity i (disjoint from node identities)."""
    import hashlib

    return SignKeyPair(
        hashlib.sha256(f"at2-sim-client-{seed}-{i}".encode()).digest()
    )


def sim_admin(seed: int) -> SignKeyPair:
    """Deterministic fleet-admin identity (signs ConfigTx transitions)."""
    return SignKeyPair(hashlib.sha256(f"at2-sim-admin-{seed}".encode()).digest())


class SimNet:
    """``n`` correct nodes (+ ``hostile`` configured-but-unstarted
    byzantine identities) on one fabric. Construct, ``start()``, drive
    with ``submit``/``run_for``/``settle``, then ``check_invariants``
    and ``close``."""

    def __init__(
        self,
        n: int = 4,
        f: int = 1,
        seed: int = 0,
        *,
        hostile: int = 0,
        link: Optional[LinkModel] = None,
        echo_threshold: Optional[int] = None,
        ready_threshold: Optional[int] = None,
        durable: bool = False,
        store_root: Optional[str] = None,
        membership_grace: Optional[float] = None,
        verifier_mode: str = "auto",
        rlc_min_batch: int = 128,
        plane_shards: int = 1,
        plane_executor: str = "inline",
        **config_overrides,
    ) -> None:
        # convenience for the shard-determinism campaigns: shards > 1
        # becomes a [plane] table on every node. ``plane_executor`` is
        # recorded as configured ("inline"/"thread"/"process") while
        # Service forces inline under the sim clock regardless — which
        # is precisely what the executor hash sweep pins: the wire
        # schedule must not depend on the configured executor.
        if plane_shards > 1 and "plane" not in config_overrides:
            from ..node.config import PlaneConfig

            config_overrides["plane"] = PlaneConfig(
                shards=plane_shards, executor=plane_executor
            )
        self.n = n
        self.f = f
        self.seed = seed
        self.loop = SimScheduler()
        asyncio.set_event_loop(self.loop)
        self.clock = SimClock(self.loop)
        self.fabric = SimFabric(self.loop, seed=seed, default_link=link)
        total = n + hostile
        n_peers = total - 1  # thresholds count peers, self excluded
        if echo_threshold is None:
            # With live byzantine identities the echo/ready quorum must
            # satisfy 2q - n_peers > h (two quorums intersect in a
            # correct node); with only crash/link faults, n_peers - f
            # keeps liveness through f unreachable peers while two
            # quorums still intersect in >= 1 (correct) node.
            if hostile:
                echo_threshold = (n_peers + hostile) // 2 + 1
            else:
                echo_threshold = max(1, n_peers - f)
        if ready_threshold is None:
            ready_threshold = echo_threshold
        self.echo_threshold = echo_threshold
        self.ready_threshold = ready_threshold

        # durability: per-node sharded store dirs under one root. The sim
        # always runs the store with sync="always" so an abrupt crash()
        # loses nothing the WAL claims durable — the torn-write cases are
        # exercised separately through the store's failpoint seam.
        self.durable = durable or store_root is not None
        self._own_store_root = False
        self.store_root = store_root
        if self.durable and self.store_root is None:
            self.store_root = tempfile.mkdtemp(prefix="at2-sim-store-")
            self._own_store_root = True

        # membership: a deterministic fleet admin; membership_grace not
        # None arms every node's MembershipManager with that grace window
        self.admin_key = sim_admin(seed)
        self.membership_grace = membership_grace

        keys = [sim_keypairs(seed, i) for i in range(total)]
        peers = [
            Peer(f"sim-{i}:0", keys[i][1].public, keys[i][0].public)
            for i in range(total)
        ]
        self.peers = peers
        self.configs: List[Config] = []
        for i in range(total):
            cfg = Config(
                node_address=f"sim-{i}:0",
                rpc_address=f"sim-rpc-{i}:0",
                sign_key=keys[i][0],
                network_key=keys[i][1],
                echo_threshold=echo_threshold,
                ready_threshold=ready_threshold,
                **config_overrides,
            )
            cfg.nodes = [p for j, p in enumerate(peers) if j != i]
            # the port's default verifier kind is "cuda"; every sim node
            # runs the shared host CpuVerifier, so its config names that
            if "verifier" not in config_overrides:
                cfg.verifier = VerifierConfig(kind="cpu")
            if self.durable and "store" not in config_overrides:
                cfg.store = StoreConfig(
                    dir=os.path.join(self.store_root, f"node-{i}"),
                    sync="always",
                    shards=8,
                )
            if membership_grace is not None and "membership" not in config_overrides:
                cfg.membership = MembershipConfig(
                    admin_public=self.admin_key.public.hex(),
                    grace=membership_grace,
                )
            self.configs.append(cfg)

        self.services: List[Service] = []
        self.hostile_configs = self.configs[n:]
        self.touched: set = set()  # account keys episodes interacted with
        self.down: set = set()  # node indexes crashed and not yet restarted
        self._incarnation: Dict[int, int] = {}
        # no-post-restart-equivocation invariant: every attestation a
        # node SIGNS (via Broadcast.on_attest), keyed by
        # (node, phase, origin, seq), across ALL incarnations. A second
        # signing of the same slot with a different content hash is a
        # broadcast-safety violation — exactly what the persisted
        # watermark floors exist to prevent.
        self._attest: Dict[tuple, bytes] = {}
        self.attest_violations: List[str] = []
        self._started = False
        # shared across nodes like production; verifier_mode/rlc_min_batch
        # select the amortized (RLC) path — the salting campaign drops
        # min_batch so sim-sized admission flushes actually route there
        self.verifier = CpuVerifier(
            mode=verifier_mode, rlc_min_batch=rlc_min_batch
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SimNet":
        # the net owns the shared verifier, so it warms it (Service.start
        # only warms verifiers it creates); under the sim scheduler the
        # executor runs inline, so this is synchronous and deterministic
        self.loop.run_until_complete(self.verifier.warmup())
        for i in range(self.n):
            self.services.append(self._start_node(i))
        self._started = True
        return self

    def _start_node(self, i: int) -> Service:
        return self.loop.run_until_complete(self._astart_node(i))

    async def _astart_node(self, i: int) -> Service:
        """Bring up node ``i`` from its config (first boot or restart):
        fresh SimMesh (``fabric.register`` overwrites, so a restarted
        node simply replaces its dead mesh), shared verifier, seeded
        catchup nonces salted with the node's incarnation count."""
        cfg = self.configs[i]
        mesh_factory = lambda c, on_frame: SimMesh(  # noqa: E731
            self.fabric, c.sign_key.public, c.nodes, on_frame,
            region_fanout=c.wan.region_fanout,
        )
        service = await Service.start(
            cfg,
            verifier=self.verifier,
            clock=self.clock,
            mesh_factory=mesh_factory,
            serve_rpc=False,
        )
        # catchup session nonces from the net seed, not secrets
        incarnation = self._incarnation.get(i, 0)
        service._nonce_bits = random.Random(
            ((self.seed << 8) | i) ^ (incarnation * 0x9E3779B9)
        ).getrandbits
        if service.broadcast is not None:
            service.broadcast.on_attest = self._attest_hook(i)
        return service

    def _attest_hook(self, i: int):
        def hook(phase, origin, sequence, chash) -> None:
            key = (i, phase, bytes(origin), int(sequence))
            prev = self._attest.get(key)
            if prev is None:
                self._attest[key] = bytes(chash)
            elif prev != bytes(chash):
                self.attest_violations.append(
                    f"equivocation: node {i} signed phase {phase} slot "
                    f"({bytes(origin).hex()[:16]}, {sequence}) with two contents"
                )

        return hook

    def close(self) -> None:
        for s in self.services:
            try:
                self.loop.run_until_complete(s.close())
            except Exception:
                pass
        self.services.clear()
        try:
            self.loop.run_until_complete(self.verifier.close())
        except Exception:
            pass
        self.loop.close()
        asyncio.set_event_loop(None)
        if self._own_store_root and self.store_root:
            shutil.rmtree(self.store_root, ignore_errors=True)

    # -- node lifecycle (crash / restart) ----------------------------------

    def crash(self, i: int) -> None:
        """Abrupt death of node ``i``: tasks cancelled, mesh closed, NO
        final store flush and no graceful shutdown drain — whatever the
        WAL holds is all a restart gets (sync="always" in the sim, so
        that is every committed slot)."""
        self.loop.run_until_complete(self._acrash(i))

    async def _acrash(self, i: int) -> None:
        if i in self.down:
            return
        s = self.services[i]
        self.down.add(i)
        s._closing = True
        for task in (
            getattr(s, "_catchup_task", None),
            getattr(s, "_stats_task", None),
            getattr(s, "_slo_task", None),
            getattr(s, "_checkpoint_task", None),
            getattr(s, "_store_task", None),
            getattr(s, "_membership_task", None),
            getattr(s, "_batch_flush_task", None),
            getattr(s, "_delivery_task", None),
        ):
            if task is not None:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
        if s.broadcast is not None:
            await s.broadcast.close()
        if s.mesh is not None:
            await s.mesh.close()
        if s.store is not None:
            # close the WAL fd only — deliberately no flush/set_meta: the
            # on-disk state is whatever the last flush + WAL tail say
            s.store.close()
        self.fabric._record("crash", s.config.sign_key.public, b"", b"")

    def restart(self, i: int) -> Service:
        return self.loop.run_until_complete(self.arestart(i))

    async def arestart(self, i: int) -> Service:
        """Restart a crashed node from its durable store: same identity
        and config, fresh mesh registered over the dead one, recovery
        path (segments -> WAL replay -> catchup) runs inside
        ``Service.start``."""
        if i not in self.down:
            raise RuntimeError(f"node {i} is not down")
        self._incarnation[i] = self._incarnation.get(i, 0) + 1
        service = await self._astart_node(i)
        self.services[i] = service
        self.down.discard(i)
        self.fabric._record("boot", service.config.sign_key.public, b"", b"")
        return service

    def flush_store(self, i: int) -> None:
        """Force node ``i``'s store flush (segment fold + manifest
        commit). The sim drives flushes explicitly — no periodic tasks —
        so episodes control exactly which state a crash preserves."""
        svc = self.services[i]
        if svc.store is not None:
            self.loop.run_until_complete(svc._store_flush())

    # -- membership driving ------------------------------------------------

    async def areconfig(
        self, node: int, change: dict, *, epoch: Optional[int] = None
    ) -> ConfigTx:
        """Build an admin-signed ConfigTx for the NEXT epoch and inject
        it at ``node`` through the service's config handler — the node
        applies it locally and re-gossips it to the fleet, exactly the
        production admin path."""
        svc = self.services[node]
        if epoch is None:
            epoch = (svc.membership.epoch if svc.membership else 0) + 1
        tx = ConfigTx.create(self.admin_key, epoch, change)
        svc._on_config_tx(None, tx)
        return tx

    def reconfig(self, node: int, change: dict, **kw) -> ConfigTx:
        return self.loop.run_until_complete(self.areconfig(node, change, **kw))

    def sweep_membership(self) -> None:
        """Finalize expired evictions on every live node (the sim has no
        periodic membership loop; settle() calls this each window)."""
        for i, s in enumerate(self.services):
            if i not in self.down and s.membership is not None:
                s.membership.sweep()

    def __enter__(self) -> "SimNet":
        return self.start() if not self._started else self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- driving -----------------------------------------------------------

    def run_for(self, duration: float) -> None:
        self.loop.run_for(duration)

    async def asubmit(
        self,
        node: int,
        client: SignKeyPair,
        sequence: int,
        recipient: bytes,
        amount: int,
        *,
        good_sig: bool = True,
        source: Optional[str] = None,
    ) -> Optional[SimRpcError]:
        """One client transaction through the real SendAsset handler
        (validation + admission + ingress batcher). Returns the
        handler's outcome: ``None`` on accept, the ``SimRpcError`` on
        rejection (rejections are normal traffic in hostile episodes)."""
        sig = (
            client.sign(
                transfer_signing_bytes(
                    client.public, sequence, recipient, amount
                )
            )
            if good_sig
            else b"\x5a" * 64
        )
        request = pb.SendAssetRequest(
            sender=client.public,
            sequence=sequence,
            recipient=recipient,
            amount=amount,
            signature=sig,
        )
        ctx = _SimContext(source or f"sim-client-{client.public[:4].hex()}")
        self.touched.add(client.public)
        self.touched.add(recipient)
        try:
            await self.services[node].SendAsset(request, ctx)
            return None
        except SimRpcError as exc:
            return exc

    def submit(self, node: int, client: SignKeyPair, sequence: int,
               recipient: bytes, amount: int, **kw):
        """Synchronous wrapper over :meth:`asubmit` for direct driving."""
        return self.loop.run_until_complete(
            self.asubmit(node, client, sequence, recipient, amount, **kw)
        )

    async def asubmit_batch(
        self,
        node: int,
        client: SignKeyPair,
        rows,
        *,
        source: Optional[str] = None,
    ) -> Optional[SimRpcError]:
        """One bulk flush through the real ``SendAssetBatch`` handler —
        the batch-poisoning campaign's ingress. ``rows`` is a list of
        ``(sequence, recipient, amount, good_sig)``; a bad row carries a
        REAL signature with one bit of ``s`` flipped (still decodable
        and torsion-free, so only the verification equation catches it).
        Returns None on accept or the ``SimRpcError`` (a salted flush
        rejecting wholesale is the expected outcome)."""
        txs = []
        for sequence, recipient, amount, good_sig in rows:
            sig = client.sign(
                transfer_signing_bytes(
                    client.public, sequence, recipient, amount
                )
            )
            if not good_sig:
                sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
            txs.append(
                pb.SendAssetRequest(
                    sender=client.public,
                    sequence=sequence,
                    recipient=recipient,
                    amount=amount,
                    signature=sig,
                )
            )
            self.touched.add(recipient)
        self.touched.add(client.public)
        ctx = _SimContext(source or f"sim-client-{client.public[:4].hex()}")
        try:
            await self.services[node].SendAssetBatch(
                pb.SendAssetBatchRequest(transactions=txs), ctx
            )
            return None
        except SimRpcError as exc:
            return exc

    async def aregister(self, node: int, pubkey: bytes) -> Optional[int]:
        """Register a client pubkey through the real ``Register`` handler
        (directory assign + DirectoryAnnounce gossip over the fabric).
        Returns the assigned client-id, or None on rejection."""
        ctx = _SimContext("sim-register")
        try:
            reply = await self.services[node].Register(
                pb.RegisterRequest(public_key=pubkey), ctx
            )
            return int(reply.client_id)
        except SimRpcError:
            return None

    async def asubmit_distilled(
        self, node: int, frame: bytes, *, source: str = "sim-broker"
    ):
        """One distilled-batch frame through the real
        ``SendDistilledBatch`` handler — the byzantine-broker campaign's
        ingress (a simulated broker is just whoever built ``frame``).
        Returns None on accept or the ``SimRpcError`` (malformed frames
        are normal traffic in hostile episodes)."""
        ctx = _SimContext(source)
        try:
            await self.services[node].SendDistilledBatch(
                pb.SendDistilledBatchRequest(frame=frame), ctx
            )
            return None
        except SimRpcError as exc:
            return exc

    def settle(
        self, horizon: float = 120.0, window: float = 5.0, stable: int = 4
    ) -> float:
        """Advance virtual time until the net is quiescent — ledger
        progress (commits, retained history) stable for ``stable``
        consecutive windows — or the horizon is reached. Wire chatter is
        deliberately NOT part of the signal: catchup polling and
        retransmission of permanently-poisoned slots keep the fabric
        busy forever; what matters is that they stopped changing
        committed state. The default window (stable * window = 20s
        virtual) exceeds the retransmission and catchup periods, so a
        heal in flight always gets a chance to land before we stop.
        Returns virtual seconds consumed."""
        last = None
        streak = 0
        t = 0.0
        while t < horizon:
            self.loop.run_for(window)
            t += window
            self.sweep_membership()
            snap = (
                tuple(s.committed for s in self.services),
                tuple(len(s.history) for s in self.services),
            )
            if snap == last:
                streak += 1
                if streak >= stable:
                    return t
            else:
                streak = 0
            last = snap
        return t

    # -- invariants --------------------------------------------------------

    def check_invariants(self) -> List[str]:
        """The AT2 safety properties, checked across all correct nodes.
        Returns violation strings (empty = all green)."""
        return self.loop.run_until_complete(self._check())

    def assert_invariants(self) -> None:
        violations = self.check_invariants()
        if violations:
            raise InvariantViolation(violations)

    async def _check(self) -> List[str]:
        violations: List[str] = []
        # crashed-and-not-restarted nodes are excluded: they are allowed
        # to be behind (that is what restart + catchup repairs)
        services = [
            s for i, s in enumerate(self.services) if i not in self.down
        ]

        # 0. no-post-restart-equivocation: recorded live by the
        # Broadcast.on_attest hook across every incarnation of each node
        violations.extend(self.attest_violations)

        # every account any node knows about, plus everything submitted
        keys: set = set(self.touched)
        for s in services:
            keys.update(s.accounts.frontier_nowait().keys())

        # 1. agreement: identical balance and frontier everywhere
        for key in sorted(keys):
            seqs = {await s.accounts.get_last_sequence(key) for s in services}
            if len(seqs) != 1:
                violations.append(
                    f"frontier divergence for {key.hex()[:16]}: {sorted(seqs)}"
                )
            bals = {await s.accounts.get_balance(key) for s in services}
            if len(bals) != 1:
                violations.append(
                    f"balance divergence for {key.hex()[:16]}: {sorted(bals)}"
                )

        # 2. sieve consistency + no double-spend past the sequence gate:
        # a (sender, seq) slot commits at most ONE content network-wide,
        # and each node's history for a sender is gap-free up to its
        # frontier (the gate admits seq k only after k-1).
        slot_content: Dict[tuple, bytes] = {}
        for si, s in enumerate(services):
            frontier = s.accounts.frontier_nowait()
            for sender, last_seq in frontier.items():
                payloads = s.history.get_range(sender, 1, last_seq + 1)
                got = {p.sequence for p in payloads}
                # history is capacity-bounded; only flag gaps the ring
                # still covers
                expected = set(range(1, last_seq + 1))
                missing = expected - got
                if missing and len(s.history) < s.config.catchup.history_cap:
                    violations.append(
                        f"node {si}: history gap for {sender.hex()[:16]}: "
                        f"missing seqs {sorted(missing)[:8]}"
                    )
                for p in payloads:
                    slot = (sender, p.sequence)
                    chash = p.content_hash()
                    seen = slot_content.get(slot)
                    if seen is None:
                        slot_content[slot] = chash
                    elif seen != chash:
                        violations.append(
                            "sieve violation: slot "
                            f"({sender.hex()[:16]}, {p.sequence}) committed "
                            "two contents"
                        )

        # 3. totality: a slot committed anywhere is committed everywhere
        # (after quiescence + catchup, all correct nodes hold the union)
        for sender, seq in sorted(slot_content):
            for si, s in enumerate(services):
                if s.accounts.frontier_nowait().get(sender, 0) < seq:
                    violations.append(
                        f"totality violation: node {si} missing slot "
                        f"({sender.hex()[:16]}, {seq})"
                    )

        # 4. conservation: replaying each node's committed history from
        # fresh-account state reproduces its reported balances exactly
        for si, s in enumerate(services):
            expect: Dict[bytes, int] = {}
            frontier = s.accounts.frontier_nowait()
            ok_replay = True
            for sender, last_seq in sorted(frontier.items()):
                payloads = s.history.get_range(sender, 1, last_seq + 1)
                if len(payloads) < last_seq:
                    ok_replay = False  # ring evicted history: cannot replay
                    continue
                for p in payloads:
                    expect[p.sender] = (
                        expect.get(p.sender, 100_000) - p.transaction.amount
                    )
                    expect[p.transaction.recipient] = (
                        expect.get(p.transaction.recipient, 100_000)
                        + p.transaction.amount
                    )
            if ok_replay:
                for key, want in sorted(expect.items()):
                    got = await s.accounts.get_balance(key)
                    if got != want:
                        violations.append(
                            f"conservation violation on node {si}: "
                            f"{key.hex()[:16]} balance {got} != replayed {want}"
                        )
        return violations


__all__ = [
    "InvariantViolation",
    "SimNet",
    "SimRpcError",
    "sim_admin",
    "sim_client",
    "sim_keypairs",
]
