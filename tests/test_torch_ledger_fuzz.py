"""Ledger differential fuzz: random op sequences against an independent
model of the reference's account rules.

The targeted tests (test_ledger.py) pin the reference's documented
quirks; this tier replays seeded random transfer streams — gap/replayed
sequences, overdrafts, self-transfers, u64-edge amounts, overflow-bound
credits — through `Accounts` and an independently written model, and
checks after every op that balances, sequences, and error outcomes agree
exactly, plus the global conservation invariant. A checkpoint round-trip
mid-stream must be state-identical too.

Model rules (re-derived from the reference, account.rs:12-54 +
accounts/mod.rs:155-201, NOT from the implementation under test):
fresh accounts hold 100,000; debit requires sequence == last+1 and
consumes the sequence even when the balance check then fails;
self-transfer is debit(seq, 0); receiver credit checks u64 overflow and
the sender's debit persists even if the credit fails.
"""

import random

import numpy as np
import pytest

from at2_node_tpu_torch.ledger import checkpoint
from at2_node_tpu_torch.ledger.account import INITIAL_BALANCE, _U64_MAX
from at2_node_tpu_torch.ledger.accounts import AccountModificationError, Accounts
from at2_node_tpu_torch.ledger.recent import RecentTransactions


class Model:
    """Independent reimplementation of the reference's observable rules."""

    def __init__(self):
        self.bal = {}
        self.seq = {}

    def _get(self, user):
        return self.bal.get(user, INITIAL_BALANCE), self.seq.get(user, 0)

    def transfer(self, sender, sequence, receiver, amount) -> bool:
        """True = commits, False = rejected (AccountModification)."""
        s_bal, s_seq = self._get(sender)
        if sequence != s_seq + 1:
            return False
        if sender == receiver:
            # self-transfer = debit(seq, 0): consumes sequence, keeps funds
            self.seq[sender] = sequence
            self.bal[sender] = s_bal
            return True
        # sequence consumed BEFORE the balance check (reference quirk)
        self.seq[sender] = sequence
        self.bal[sender] = s_bal
        if amount > s_bal:
            return False
        r_bal, _ = self._get(receiver)
        if r_bal + amount > _U64_MAX:
            # receiver overflow: sender's debit has already persisted
            self.bal[sender] = s_bal - amount
            return False
        self.bal[sender] = s_bal - amount
        self.bal[receiver] = r_bal + amount
        return True


async def _assert_agree(accounts: Accounts, model: Model, users) -> None:
    for u in users:
        want_bal, want_seq = model._get(u)
        assert await accounts.get_balance(u) == want_bal
        assert await accounts.get_last_sequence(u) == want_seq


@pytest.mark.parametrize("seed", [2, 11, 29, 73, 97])
async def test_random_streams_match_model(seed):
        rng = random.Random(seed)
        users = [bytes([i]) * 32 for i in range(1, 6)]
        accounts = Accounts()
        model = Model()
        next_seq = {u: 1 for u in users}

        for step in range(300):
            sender = rng.choice(users)
            receiver = rng.choice(users)  # may equal sender
            roll = rng.random()
            if roll < 0.60:
                seq = next_seq[sender]  # the valid next sequence
            elif roll < 0.80:
                seq = max(1, next_seq[sender] - rng.randrange(1, 3))  # replay
            else:
                seq = next_seq[sender] + rng.randrange(1, 4)  # gap
            amount_roll = rng.random()
            if amount_roll < 0.5:
                amount = rng.randrange(0, 2000)
            elif amount_roll < 0.8:
                amount = rng.randrange(90_000, 250_000)  # overdraft range
            else:
                amount = rng.choice((0, 1, INITIAL_BALANCE, 10**15))

            want = model.transfer(sender, seq, receiver, amount)
            try:
                await accounts.transfer(sender, seq, receiver, amount)
                got = True
            except AccountModificationError:
                got = False
            assert got is want, (
                f"step {step}: divergence on "
                f"({sender[:1].hex()},{seq},{receiver[:1].hex()},{amount}): "
                f"impl={got} model={want}"
            )
            if seq == next_seq[sender]:
                # a correctly-sequenced debit consumes the sequence even
                # when it fails (the reference quirk) — success and
                # failure advance identically
                next_seq[sender] = seq + 1

            if step % 97 == 0:
                await _assert_agree(accounts, model, users)

        await _assert_agree(accounts, model, users)
        # conservation: only transfers happened, so total = faucet * users
        total = 0
        for u in users:
            total += await accounts.get_balance(u)
        assert total == INITIAL_BALANCE * len(users)


@pytest.mark.parametrize("seed", [5, 41])
async def test_checkpoint_roundtrip_mid_stream_is_state_identical(seed, tmp_path):
        rng = random.Random(seed)
        users = [bytes([i]) * 32 for i in range(1, 5)]
        accounts = Accounts()
        recent = RecentTransactions()
        model = Model()
        next_seq = {u: 1 for u in users}

        async def one_op():
            sender, receiver = rng.choice(users), rng.choice(users)
            seq = next_seq[sender]
            amount = rng.randrange(0, 120_000)
            want = model.transfer(sender, seq, receiver, amount)
            try:
                await accounts.transfer(sender, seq, receiver, amount)
                assert want
            except AccountModificationError:
                assert not want
            next_seq[sender] = seq + 1

        for _ in range(60):
            await one_op()
        path = str(tmp_path / "ledger.ckpt")
        await checkpoint.save(path, accounts, recent)
        restored_a, restored_r = Accounts(), RecentTransactions()
        assert await checkpoint.load(path, restored_a, restored_r)
        await _assert_agree(restored_a, model, users)
        # the restored ledger continues the stream identically
        accounts2 = restored_a
        for _ in range(60):
            sender, receiver = rng.choice(users), rng.choice(users)
            seq = next_seq[sender]
            amount = rng.randrange(0, 120_000)
            want = model.transfer(sender, seq, receiver, amount)
            try:
                await accounts2.transfer(sender, seq, receiver, amount)
                got = True
            except AccountModificationError:
                got = False
            assert got is want
            next_seq[sender] = seq + 1
        await _assert_agree(accounts2, model, users)


@pytest.mark.parametrize("seed", [17, 59])
async def test_overflow_rich_accounts_match_model(seed):
    """Receiver-overflow coverage needs balances transfers alone cannot
    reach (the faucet total is ~500k): seed near-u64 accounts through the
    checkpoint import path, then fuzz transfers INTO them so the credit
    overflow — and the sender's-debit-persists-anyway quirk — actually
    fire."""
    rng = random.Random(seed)
    users = [bytes([i]) * 32 for i in range(1, 4)]
    whale = b"\xee" * 32
    accounts = Accounts()
    model = Model()
    whale_balance = _U64_MAX - 5_000
    await accounts.import_state({whale.hex(): (0, whale_balance)})
    model.bal[whale] = whale_balance
    next_seq = {u: 1 for u in users + [whale]}

    overflowed = 0
    for _ in range(200):
        sender = rng.choice(users)
        receiver = whale if rng.random() < 0.7 else rng.choice(users)
        seq = next_seq[sender]
        amount = rng.randrange(0, 20_000)
        want = model.transfer(sender, seq, receiver, amount)
        try:
            await accounts.transfer(sender, seq, receiver, amount)
            got = True
        except AccountModificationError:
            got = False
        assert got is want, (sender[:1].hex(), seq, amount, got, want)
        if not want and receiver is whale and amount > 0:
            overflowed += 1
        if seq == next_seq[sender]:
            next_seq[sender] = seq + 1
    await _assert_agree(accounts, model, users + [whale])
    assert overflowed > 0, "the overflow path never fired; weaken the seed"


class RingModel:
    """Independent model of the recent-transactions ring (reference
    recent_transactions.rs:7,149-200): capacity 10 FIFO, put dedups by
    (sender, sequence), update rewrites the LATEST matching entry's
    state and is a NOP when absent."""

    CAP = 10

    def __init__(self):
        self.entries = []  # (sender, seq, state)

    def put(self, sender, seq):
        if any(e[0] == sender and e[1] == seq for e in self.entries):
            return
        self.entries.append((sender, seq, "PENDING"))
        if len(self.entries) > self.CAP:
            self.entries.pop(0)

    def update(self, sender, seq, state):
        for i in range(len(self.entries) - 1, -1, -1):
            if self.entries[i][0] == sender and self.entries[i][1] == seq:
                self.entries[i] = (sender, seq, state)
                return


@pytest.mark.parametrize("seed", [6, 47, 88])
async def test_recent_ring_matches_model(seed):
    from at2_node_tpu_torch.types import ThinTransaction, TransactionState

    rng = random.Random(seed)
    recent = RecentTransactions()
    model = RingModel()
    users = [bytes([i]) * 32 for i in range(1, 4)]
    for _ in range(250):
        sender = rng.choice(users)
        seq = rng.randrange(1, 15)
        roll = rng.random()
        if roll < 0.55:
            await recent.put(sender, seq, ThinTransaction(b"r" * 32, 1))
            model.put(sender, seq)
        else:
            state = rng.choice(
                (TransactionState.SUCCESS, TransactionState.FAILURE)
            )
            await recent.update(sender, seq, state)
            model.update(sender, seq, state.name)
        got = [
            (t.sender, t.sender_sequence, t.state.name)
            for t in await recent.get_all()
        ]
        # get_all's order is part of the contract: oldest first
        # (recent.py export docstring; GetLatestTransactions relies on it)
        assert got == model.entries, (got, model.entries)


@pytest.mark.parametrize("seed", [8, 67])
async def test_streams_and_checkpoints_equal_the_reference(seed, tmp_path):
    """Differential: one seeded stream through the reference's and the
    port's Accounts side by side, every outcome and account equal; then
    each package's checkpoint loads into the other and the streams go on
    identical (the two checkpoint formats are one)."""
    from at2_node_tpu.ledger import checkpoint as ref_checkpoint
    from at2_node_tpu.ledger.accounts import AccountModificationError as RefError
    from at2_node_tpu.ledger.accounts import Accounts as RefAccounts
    from at2_node_tpu.ledger.recent import RecentTransactions as RefRecent

    rng = np.random.default_rng(seed)
    users = [rng.bytes(32) for _ in range(5)]
    next_seq = {u: 1 for u in users}

    async def step(pairs):
        sender, receiver = users[int(rng.integers(5))], users[int(rng.integers(5))]
        seq = next_seq[sender] + int(rng.choice([0, 0, 0, -1, 2]))
        amount = int(rng.integers(0, 150_000))
        outcomes = []
        for accounts, error in pairs:
            try:
                await accounts.transfer(sender, seq, receiver, amount)
                outcomes.append("ok")
            except error as exc:
                outcomes.append(exc.source.kind.value)
        assert outcomes[0] == outcomes[1], (sender.hex()[:8], seq, amount, outcomes)
        if seq == next_seq[sender]:
            next_seq[sender] = seq + 1

    async def states(*ledgers):
        return [[(await a.get_balance(u), await a.get_last_sequence(u)) for u in users] for a in ledgers]

    ref, port = RefAccounts(), Accounts()
    for _ in range(150):
        await step([(ref, RefError), (port, AccountModificationError)])
    a, b = await states(ref, port)
    assert a == b
    # cross-load: the reference's checkpoint into the port, the port's into
    # the reference
    await ref_checkpoint.save(str(tmp_path / "ref.ckpt"), ref, RefRecent())
    await checkpoint.save(str(tmp_path / "port.ckpt"), port, RecentTransactions())
    port2, ref2 = Accounts(), RefAccounts()
    assert await checkpoint.load(str(tmp_path / "ref.ckpt"), port2, RecentTransactions())
    assert await ref_checkpoint.load(str(tmp_path / "port.ckpt"), ref2, RefRecent())
    assert await port.export_state() == await ref.export_state()
    for _ in range(150):
        await step([(ref2, RefError), (port2, AccountModificationError)])
    a, b = await states(ref2, port2)
    assert a == b
    assert (list(port2.digest.ranges), port2.digest.wm) == (list(ref2.digest.ranges), ref2.digest.wm)
