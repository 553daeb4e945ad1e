"""Unit tests for the catchup plane's defensive machinery and the inbox
byte budget — the bounds that keep an authenticated-but-byzantine peer
from using the new protocol surfaces as amplification levers. The happy
path (full rejoin re-convergence) lives in tests/test_faults.py and the
CLI drive; these pin the caps directly.
"""

import asyncio
import itertools

import pytest

from at2_node_tpu_torch.broadcast import stack as stack_mod
from at2_node_tpu_torch.broadcast.messages import (
    HistoryBatch,
    HistoryIndexRequest,
    HistoryRequest,
    Payload,
)
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.ledger import history as hist
from at2_node_tpu_torch.node import service as service_mod
from at2_node_tpu_torch.node.config import VerifierConfig
from at2_node_tpu_torch.node.service import Service, _CatchupSession
from at2_node_tpu_torch.types import ThinTransaction
from at2_node_tpu_torch.tools._common import make_net_configs as _make_net_configs

_ports = itertools.count(30600)


def make_net_configs(n, ports, **overrides):
    """The reference conftest's ``make_net_configs`` on the port's tools,
    every node on the host verifier (the port's default kind is "cuda")."""
    return _make_net_configs(n, ports, verifier=VerifierConfig(kind="cpu"), **overrides)


def _payload(seed: int, seq: int = 1) -> Payload:
    kp = SignKeyPair.from_hex(f"{seed % 255 + 1:02x}" * 32)
    tx = ThinTransaction(bytes([seed % 256]) * 32, seed + 1)
    return Payload.create(kp, seq, tx)


class _FakeMesh:
    """Captures catchup-plane sends without a network."""

    def __init__(self, peers):
        self.peers = peers
        self.sent = []  # (peer, frame)

    def send(self, peer, frame):
        self.sent.append((peer, frame))

    def broadcast(self, frame, exclude=()):
        for p in self.peers:
            self.sent.append((p, frame))


def _service_with_fake_mesh(n_peers=2):
    cfgs = make_net_configs(n_peers + 1, _ports)
    svc = Service(cfgs[0])
    svc.mesh = _FakeMesh(cfgs[0].nodes)
    return svc, cfgs[0].nodes


@pytest.mark.asyncio
async def test_index_request_budget_throttles():
    svc, peers = _service_with_fake_mesh()
    for _ in range(service_mod.SERVE_IDX_PER_SEC + 3):
        svc._on_catchup(peers[0], HistoryIndexRequest(1))
    assert len(svc.mesh.sent) == service_mod.SERVE_IDX_PER_SEC
    assert svc.catchup_stats["catchup_throttled"] == 3
    # a different peer has its own budget
    svc._on_catchup(peers[1], HistoryIndexRequest(2))
    assert len(svc.mesh.sent) == service_mod.SERVE_IDX_PER_SEC + 1


@pytest.mark.asyncio
async def test_history_request_budget_charged_before_lookup():
    svc, peers = _service_with_fake_mesh()
    # fill some history so a lookup WOULD serve
    for i in range(10):
        svc.history.record(_payload(3, seq=i + 1))
    sender = _payload(3).sender
    # a huge claimed range charges its CLAMPED cost (MAX_RANGE) even
    # though only 10 payloads exist — the budget bounds the WORK, not
    # the result; 4 such requests exhaust SERVE_ROWS_PER_SEC exactly
    assert service_mod.SERVE_ROWS_PER_SEC == 4 * hist.MAX_RANGE
    for _ in range(4):
        svc._on_catchup(peers[0], HistoryRequest(1, sender, 1, 1 << 31))
    assert svc.catchup_stats["catchup_served"] == 40
    # budget now exhausted for this peer+window: next request does no work
    svc._on_catchup(peers[0], HistoryRequest(1, sender, 1, 10))
    assert svc.catchup_stats["catchup_throttled"] >= 1
    assert svc.catchup_stats["catchup_served"] == 40
    # inverted range costs nothing and serves nothing
    before = len(svc.mesh.sent)
    svc._on_catchup(peers[1], HistoryRequest(1, sender, 9, 3))
    assert len(svc.mesh.sent) == before


@pytest.mark.asyncio
async def test_session_per_peer_cap_never_blocks_vote_accrual(monkeypatch):
    monkeypatch.setattr(service_mod, "MAX_SESSION_PAYLOADS", 8)
    svc, peers = _service_with_fake_mesh(n_peers=2)
    session = _CatchupSession(nonce=7, n_peers=2)
    assert session.per_peer_cap == 4
    svc._catchup_session = session

    flood = tuple(_payload(i, seq=1) for i in range(10, 20))
    svc._on_catchup(peers[0], HistoryBatch(7, flood))
    # the flooding peer stored only its own share
    assert len(session.payloads) == 4
    assert session.stored_by_peer[peers[0].sign_public] == 4

    # the honest peer's copies of ALREADY-STORED slots accrue votes
    # despite the flood — quorum can still form
    stored_payloads = tuple(session.payloads.values())
    svc._on_catchup(peers[1], HistoryBatch(7, stored_payloads))
    for vote_key in session.payloads:
        assert len(session.votes[vote_key]) == 2
    # and the honest peer still has its own storage share
    fresh = tuple(_payload(i, seq=1) for i in range(30, 33))
    svc._on_catchup(peers[1], HistoryBatch(7, fresh))
    assert len(session.payloads) == 7


@pytest.mark.asyncio
async def test_index_rotation_covers_all_senders(monkeypatch):
    monkeypatch.setattr(hist, "MAX_IDX_ENTRIES", 3)
    svc, peers = _service_with_fake_mesh()
    for i in range(40, 47):  # 7 senders committed
        await svc.accounts.transfer(
            _payload(i).sender, 1, _payload(i + 100).sender, 1
        )
    seen = set()
    for nonce in range(4):
        svc._on_catchup(peers[0], HistoryIndexRequest(nonce))
        from at2_node_tpu_torch.broadcast.messages import parse_frame

        _, frame = svc.mesh.sent[-1]
        (idx,) = parse_frame(frame)
        assert len(idx.entries) == 3
        seen.update(sender for sender, _ in idx.entries)
    # rotating windows cover every sender within ceil(7/3)+1 requests
    assert len(seen) == 7


@pytest.mark.asyncio
async def test_inbox_byte_budget(monkeypatch):
    monkeypatch.setattr(stack_mod, "INBOX_MAX_BYTES", 1000)
    bcast = stack_mod.Broadcast.__new__(stack_mod.Broadcast)
    bcast._inbox = asyncio.Queue(maxsize=65536)
    bcast._inbox_bytes = 0

    big = b"\x01" * 600
    await bcast.on_frame(None, big)
    assert bcast._inbox_bytes == 600
    await bcast.on_frame(None, big)  # would exceed the 1000-byte budget
    assert bcast._inbox_bytes == 600
    assert bcast._inbox.qsize() == 1

    # draining (what a worker does) frees the budget
    _, frame = bcast._inbox.get_nowait()
    bcast._inbox_bytes -= len(frame)
    await bcast.on_frame(None, big)
    assert bcast._inbox.qsize() == 1


@pytest.mark.parametrize("seed", [4, 40])
async def test_served_history_frames_equal_the_reference(seed, monkeypatch):
    """Differential: the same seeded committed history (several senders,
    gaps, more than one HistoryBatch chunk) served by the reference's
    Service and the port's: the HistoryIndex and HistoryBatch frames each
    sends for the same requests are byte-identical."""
    import importlib

    import numpy as np

    sent = []
    for pkg in ("at2_node_tpu", "at2_node_tpu_torch"):
        common = importlib.import_module(f"{pkg}.tools._common")
        service = importlib.import_module(f"{pkg}.node.service")
        m = importlib.import_module(f"{pkg}.broadcast.messages")
        keys = importlib.import_module(f"{pkg}.crypto.keys")
        types = importlib.import_module(f"{pkg}.types")
        history = importlib.import_module(f"{pkg}.ledger.history")
        monkeypatch.setattr(history, "MAX_BATCH", 8)  # several chunks from a short range
        overrides = {}
        if pkg == "at2_node_tpu_torch":
            overrides["verifier"] = VerifierConfig(kind="cpu")
        cfgs = common.make_net_configs(3, _ports, **overrides)
        svc = service.Service(cfgs[0])
        svc.mesh = _FakeMesh(cfgs[0].nodes)
        rng = np.random.default_rng(seed)
        senders = [keys.SignKeyPair(rng.bytes(32)) for _ in range(4)]
        for kp in senders:
            n = int(rng.integers(1, 40))
            for seq in range(1, n + 1):
                if rng.random() < 0.9:  # a few gaps in what this node retains
                    svc.history.record(m.Payload.create(
                        kp, seq, types.ThinTransaction(rng.bytes(32), int(rng.integers(1, 1000)))))
            await svc.accounts.transfer(kp.public, 1, senders[0].public, 1)
        peer = cfgs[0].nodes[0]
        svc._on_catchup(peer, m.HistoryIndexRequest(11))
        for i, kp in enumerate(senders):
            lo = int(rng.integers(1, 5))
            svc._on_catchup(peer, m.HistoryRequest(20 + i, kp.public, lo, lo + int(rng.integers(0, 90))))
        sent.append([frame for _, frame in svc.mesh.sent])
    ref, port = sent
    assert len(port) > len(senders) + 1  # the index, and more than one chunk for some range
    assert port == ref
