"""The port's delivery drain against the reference's, pass for pass.

The port keeps the payloads its sequence gate refused parked by sender and
takes up on a pass only the groups that pass can act on
(``Service._park`` / ``_unpark``); the reference visits every pending
payload on every pass. Both are driven here with the same arrivals, clock,
catch-up keys and mid-pass arrivals, made from a seed with numpy, and must
leave the same ledger, commits, ring operations, store notes, pending set
and readings after every drain.
"""

import asyncio
import types

import numpy as np
import pytest

from at2_node_tpu.broadcast.messages import Payload as RefPayload
from at2_node_tpu.ledger.accounts import Accounts as RefAccounts
from at2_node_tpu.node import service as ref_service
from at2_node_tpu.types import ThinTransaction as RefThin
from at2_node_tpu_torch.broadcast.messages import Payload
from at2_node_tpu_torch.ledger.accounts import Accounts
from at2_node_tpu_torch.node import service
from at2_node_tpu_torch.types import ThinTransaction

TTL = service.TRANSACTION_TTL


class _Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


class _Store:
    def __init__(self) -> None:
        self.notes: list = []

    def note_parked(self, p) -> None:
        self.notes.append(("parked", p.sender, p.sequence))

    def note_unparked(self, p) -> None:
        self.notes.append(("unparked", p.sender, p.sequence))


def _bare(mod, accounts_cls, mid_pass: dict):
    """A Service of ``mod`` with only what the drain reads; its commit
    tail records each pass's effects and pushes ``mid_pass[k]`` while the
    k-th tail awaits (an arrival during a pass)."""
    svc = mod.Service.__new__(mod.Service)
    svc.accounts = accounts_cls()
    svc.clock = _Clock()
    svc.store = _Store()
    svc.ledger_failpoint = None
    svc.config = types.SimpleNamespace(catchup=types.SimpleNamespace(enabled=False))
    svc._closing = False
    svc.mesh = None
    svc._heap, svc._heap_keys, svc._push_count = [], set(), 0
    svc._parked, svc._parked_n = {}, 0
    svc._catchup_keys = set()
    svc._drain_lock = asyncio.Lock()
    svc.tails = []

    async def commit_tail(commits, ring_ops):
        # a ring operation's state is each package's own enum: compare names
        ops = [tuple(getattr(x, "name", x) for x in op) for op in ring_ops]
        svc.tails.append(([(k, s, r) for k, _, s, r in commits], ops))
        await asyncio.sleep(0)
        for p, from_catchup in mid_pass.get(len(svc.tails), ()):
            svc._push_pending(p, svc.clock.monotonic(), from_catchup)

    svc._commit_tail = commit_tail
    return svc


def _pending(svc, port: bool) -> list:
    entries = list(svc._heap)
    if port:
        entries += [e for group in svc._parked.values() for e in group[2]]
    return sorted((e[0], e[1]) for e in entries)


def _scenario(seed: int, n_senders: int, rounds: int):
    """Transfers of a few senders (gaps, re-deliveries, equivocations,
    self-transfers, overdrafts), some never delivered, split into rounds
    with clock steps that cross the TTL, and mid-pass arrivals."""
    rng = np.random.default_rng(seed)
    keys = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n_senders)]
    txs = []
    for s, key in enumerate(keys):
        for seq in range(1, int(rng.integers(3, 14)) + 1):
            to = keys[int(rng.integers(n_senders))] if rng.random() > 0.1 else key
            amount = int(rng.choice([1, 50, 20_000, 60_000]))
            txs.append((key, seq, to, amount))
            if rng.random() < 0.08:  # an equivocating twin of the slot
                txs.append((key, seq, keys[int(rng.integers(n_senders))], amount + 1))
    order = [txs[i] for i in rng.permutation(len(txs))]
    lost = set(int(i) for i in rng.choice(len(order), size=max(1, len(order) // 12), replace=False))
    sent = [t for i, t in enumerate(order) if i not in lost]
    sent += [sent[int(i)] for i in rng.integers(0, len(sent), 4)]  # re-deliveries
    cuts = sorted(int(c) for c in rng.choice(np.arange(1, len(sent)), size=rounds - 1, replace=False))
    chunks = [sent[a:b] for a, b in zip([0] + cuts, cuts + [len(sent)])]
    steps = [float(rng.choice([0.0, 0.5, 7.0, 25.0, TTL + 1.0])) for _ in chunks]
    catchup = [[bool(rng.random() < 0.1) for _ in c] for c in chunks]
    mid = {}
    for k in range(1, 4 * rounds):
        if rng.random() < 0.3:
            mid[k] = [(order[int(i)], bool(rng.random() < 0.2)) for i in rng.integers(0, len(order), 2)]
    return chunks, steps, catchup, mid


def _payload(cls, thin, tx):
    key, seq, to, amount = tx
    return cls(key, seq, thin(to, amount), b"\x07" * 64)


async def _drive(seed: int, n_senders: int, rounds: int) -> int:
    chunks, steps, catchup, mid = _scenario(seed, n_senders, rounds)
    sides = []
    for mod, acc, cls, thin, port in ((ref_service, RefAccounts, RefPayload, RefThin, False),
                                      (service, Accounts, Payload, ThinTransaction, True)):
        m = {k: [(_payload(cls, thin, tx), c) for tx, c in v] for k, v in mid.items()}
        sides.append((_bare(mod, acc, m), cls, thin, port))
    for chunk, step, flags in zip(chunks, steps, catchup):
        seen = []
        for svc, cls, thin, port in sides:
            svc.clock.t += step
            for tx, c in zip(chunk, flags):
                svc._push_pending(_payload(cls, thin, tx), svc.clock.monotonic(), c)
            await svc._drain_to_fixpoint()
            oldest = min((e[1] for e in svc._heap), default=None) if not port else svc._oldest_pending()
            count = len(svc._heap) if not port else svc._pending_count()
            seen.append((await svc.accounts.export_state(), svc.tails, svc.store.notes, _pending(svc, port),
                         set(svc._heap_keys), set(svc._catchup_keys), oldest, count))
        assert seen[0] == seen[1]
    return len(sides[0][0].tails)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_the_drain_commits_as_the_reference_does(seed):
    """Same ledger, commits, ring operations, drops, pending set, keys and
    readings as the reference's drain after every one of 12 drains."""
    passes = asyncio.run(_drive(seed, n_senders=7, rounds=12))
    assert passes > 0


def test_a_pass_leaves_payloads_parked_behind_a_lost_sequence_alone(monkeypatch):
    """1,000 payloads of one sender wait behind its lost first sequence
    while 40 other senders commit one transfer each, a drain apiece: the
    port's passes look at the parked group once, where the reference's
    look at it on every pass, and both end with the same ledger and the
    same thousand payloads pending."""
    rng = np.random.default_rng(7)
    blocked = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    others = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(40)]
    visits = {"n": 0}
    real = Accounts._transfer

    def counted(self, *args):
        visits["n"] += 1
        return real(self, *args)

    monkeypatch.setattr(Accounts, "_transfer", counted)

    async def run(mod, acc, cls, thin):
        svc = _bare(mod, acc, {})
        for seq in range(2, 1002):
            svc._push_pending(cls(blocked, seq, thin(others[0], 1), b"\x07" * 64), svc.clock.monotonic())
        await svc._drain_to_fixpoint()
        for key in others:
            svc.clock.t += 0.01
            svc._push_pending(cls(key, 1, thin(blocked, 5), b"\x07" * 64), svc.clock.monotonic())
            await svc._drain_to_fixpoint()
        return svc, await svc.accounts.export_state()

    ref, ref_state = asyncio.run(run(ref_service, RefAccounts, RefPayload, RefThin))
    port, port_state = asyncio.run(run(service, Accounts, Payload, ThinTransaction))
    assert port_state == ref_state and port.tails == ref.tails
    assert _pending(port, True) == _pending(ref, False) and port._pending_count() == 1000
    # the first drain's one visit a payload of the parked group, then one
    # for each arriving transfer and none for the group
    assert visits["n"] == 1000 + len(others)
    assert port._parked_n == 1000 and list(port._parked) == [blocked]


def test_a_parked_group_is_taken_up_when_its_sender_moves_outside_a_pass():
    """A restored ledger moves a parked sender's last sequence past its
    gap: the next drain commits the group, as the reference's does."""
    rng = np.random.default_rng(3)
    blocked, to = (bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(2))

    async def run(mod, acc, cls, thin):
        svc = _bare(mod, acc, {})
        for seq in range(2, 21):
            svc._push_pending(cls(blocked, seq, thin(to, 3), b"\x07" * 64), svc.clock.monotonic())
        await svc._drain_to_fixpoint()
        assert not svc.tails
        await svc.accounts.import_state({blocked.hex(): [1, 500]})
        await svc._drain_to_fixpoint()
        return svc, await svc.accounts.export_state()

    ref, ref_state = asyncio.run(run(ref_service, RefAccounts, RefPayload, RefThin))
    port, port_state = asyncio.run(run(service, Accounts, Payload, ThinTransaction))
    assert port_state == ref_state == {blocked.hex(): [20, 500 - 3 * 19], to.hex(): [0, 100_000 + 3 * 19]}
    assert port.tails == ref.tails and port._pending_count() == 0 and not port._parked
