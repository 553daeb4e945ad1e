"""Ledger semantics tests.

Ports of the reference's own unit tests, which pin the observable ledger
quirks (`at2-node/src/bin/server/accounts/account.rs:56-91`,
`accounts/mod.rs:216-301`, `recent_transactions.rs:203-249`).
"""

import asyncio
import importlib
import json

import numpy as np
import pytest

from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.ledger import (
    Account,
    AccountModificationError,
    Accounts,
    INITIAL_BALANCE,
    RecentTransactions,
)
from at2_node_tpu_torch.ledger.account import AccountError, AccountException
from at2_node_tpu_torch.types import ThinTransaction, TransactionState


# -- Account state machine (account.rs:56-91) --


def test_debit_too_much_fails_but_bumps_sequence():
    account = Account()
    old_seq = account.last_sequence
    with pytest.raises(AccountException) as exc:
        account.debit(1, INITIAL_BALANCE + 1)
    assert exc.value.kind == AccountError.UNDERFLOW
    assert account.last_sequence > old_seq
    assert account.balance == INITIAL_BALANCE


def test_debit_increases_sequence():
    account = Account()
    old_seq = account.last_sequence
    account.debit(1, 1)
    assert account.last_sequence > old_seq


def test_credit_doesnt_change_sequence():
    account = Account()
    old_seq = account.last_sequence
    account.credit(1)
    assert account.last_sequence == old_seq


def test_debit_requires_consecutive_sequence():
    account = Account()
    with pytest.raises(AccountException) as exc:
        account.debit(2, 1)
    assert exc.value.kind == AccountError.INCONSECUTIVE_SEQUENCE
    assert account.last_sequence == 0


def test_credit_overflow():
    account = Account()
    with pytest.raises(AccountException) as exc:
        account.credit((1 << 64) - 1)
    assert exc.value.kind == AccountError.OVERFLOW


# -- Accounts actor (accounts/mod.rs:216-301) --


async def _balance_and_sequence(accounts, user):
    return await accounts.get_balance(user), await accounts.get_last_sequence(user)


def test_new_account_is_the_same_as_unknown_account():
    async def run():
        accounts = Accounts()
        user = SignKeyPair.random().public
        balance, sequence = await _balance_and_sequence(accounts, user)
        fresh = Account()
        assert balance == fresh.balance
        assert sequence == fresh.last_sequence
        accounts.close()

    asyncio.run(run())


def test_transfer_to_themselves_increments_sequence_and_keeps_balance():
    async def run():
        accounts = Accounts()
        user = SignKeyPair.random().public
        balance0, seq0 = await _balance_and_sequence(accounts, user)
        await accounts.transfer(user, 1, user, 10)
        balance1, seq1 = await _balance_and_sequence(accounts, user)
        assert balance0 == balance1
        assert seq0 < seq1
        accounts.close()

    asyncio.run(run())


def test_transfer_too_much_fails_and_increases_sequence():
    async def run():
        accounts = Accounts()
        first = SignKeyPair.random().public
        second = SignKeyPair.random().public
        fb0, fs0 = await _balance_and_sequence(accounts, first)
        sb0, ss0 = await _balance_and_sequence(accounts, second)
        with pytest.raises(AccountModificationError):
            await accounts.transfer(first, 1, second, fb0 + 1)
        fb1, fs1 = await _balance_and_sequence(accounts, first)
        sb1, ss1 = await _balance_and_sequence(accounts, second)
        assert fb0 == fb1
        assert fs0 < fs1
        assert sb0 == sb1
        assert ss0 == ss1
        accounts.close()

    asyncio.run(run())


def test_transfer_conserves_total_balance():
    async def run():
        accounts = Accounts()
        alice = SignKeyPair.random().public
        bob = SignKeyPair.random().public
        await accounts.transfer(alice, 1, bob, 1000)
        assert await accounts.get_balance(alice) == INITIAL_BALANCE - 1000
        assert await accounts.get_balance(bob) == INITIAL_BALANCE + 1000
        accounts.close()

    asyncio.run(run())


def test_transfer_sequence_gap_is_retryable_error():
    async def run():
        accounts = Accounts()
        alice = SignKeyPair.random().public
        bob = SignKeyPair.random().public
        with pytest.raises(AccountModificationError) as exc:
            await accounts.transfer(alice, 2, bob, 1)
        assert exc.value.source.kind == AccountError.INCONSECUTIVE_SEQUENCE
        # gap filled: now 1 then 2 work
        await accounts.transfer(alice, 1, bob, 1)
        await accounts.transfer(alice, 2, bob, 1)
        assert await accounts.get_last_sequence(alice) == 2
        accounts.close()

    asyncio.run(run())


# -- RecentTransactions ring (recent_transactions.rs:203-249) --


def test_put_transactions_show_in_get_all():
    async def run():
        recent = RecentTransactions()
        sender = SignKeyPair.random().public
        recipient = SignKeyPair.random().public
        txs = [
            ThinTransaction(recipient=recipient, amount=10),
            ThinTransaction(recipient=sender, amount=3),
        ]
        for seq, thin in enumerate(txs, start=1):
            await recent.put(sender, seq, thin)

        got = await recent.get_all()
        assert len(got) == len(txs)
        for seq, (thin, full) in enumerate(zip(txs, got), start=1):
            assert full.sender == sender
            assert full.sender_sequence == seq
            assert full.amount == thin.amount
            assert full.recipient == thin.recipient
            assert full.state == TransactionState.PENDING

    asyncio.run(run())


def test_put_dedups_by_sender_and_sequence():
    async def run():
        recent = RecentTransactions()
        sender = SignKeyPair.random().public
        thin = ThinTransaction(recipient=sender, amount=1)
        await recent.put(sender, 1, thin)
        await recent.put(sender, 1, thin)
        assert len(await recent.get_all()) == 1

    asyncio.run(run())


def test_ring_caps_at_ten_and_update_missing_is_nop():
    async def run():
        recent = RecentTransactions()
        sender = SignKeyPair.random().public
        thin = ThinTransaction(recipient=sender, amount=1)
        for seq in range(1, 13):
            await recent.put(sender, seq, thin)
        got = await recent.get_all()
        assert len(got) == 10
        assert got[0].sender_sequence == 3  # oldest two evicted

        # updating an evicted (or never-seen) tx is a NOP
        await recent.update(sender, 1, TransactionState.SUCCESS)
        await recent.update(sender, 5, TransactionState.SUCCESS)
        got = await recent.get_all()
        states = {tx.sender_sequence: tx.state for tx in got}
        assert states[5] == TransactionState.SUCCESS
        assert states[4] == TransactionState.PENDING

    asyncio.run(run())


# -- shared types --


def test_signing_bytes_layout():
    from at2_node_tpu_torch.types import TRANSFER_SIG_TAG, transfer_signing_bytes

    sender = bytes(range(32, 64))
    recipient = bytes(range(32))
    assert transfer_signing_bytes(sender, 3, recipient, 5) == (
        TRANSFER_SIG_TAG
        + sender
        + (3).to_bytes(4, "little")
        + recipient
        + (5).to_bytes(8, "little")
    )


def test_sign_verify_roundtrip():
    from at2_node_tpu_torch.crypto.keys import verify_one
    from at2_node_tpu_torch.types import transfer_signing_bytes

    keypair = SignKeyPair.random()
    recipient = SignKeyPair.random().public
    msg = transfer_signing_bytes(keypair.public, 1, recipient, 42)
    sig = keypair.sign(msg)
    assert verify_one(keypair.public, msg, sig)
    assert not verify_one(keypair.public, b"other message", sig)
    # sequence is bound: the same signature fails at a shifted slot
    shifted = transfer_signing_bytes(keypair.public, 2, recipient, 42)
    assert not verify_one(keypair.public, shifted, sig)


# -- bulk ring/ledger operations (one lock round-trip per batch) --


@pytest.mark.asyncio
async def test_put_many_matches_per_item_put_semantics():
    ring = RecentTransactions()
    s1, s2 = b"\x01" * 32, b"\x02" * 32
    thin = ThinTransaction(b"\x03" * 32, 5)
    # dedup inside one bulk call AND against prior entries
    await ring.put(s1, 1, thin)
    await ring.put_many([(s1, 1, thin), (s1, 2, thin), (s2, 1, thin), (s1, 2, thin)])
    txs = await ring.get_all()
    assert [(t.sender, t.sender_sequence) for t in txs] == [
        (s1, 1), (s1, 2), (s2, 1)
    ]
    assert all(t.state is TransactionState.PENDING for t in txs)


@pytest.mark.asyncio
async def test_apply_many_order_and_unless_success():
    ring = RecentTransactions()
    s = b"\x04" * 32
    thin = ThinTransaction(b"\x05" * 32, 5)
    await ring.put_many([(s, 1, thin), (s, 2, thin)])
    # ordered application: FAILURE then SUCCESS for seq 1 -> final SUCCESS;
    # unless_success on seq 1 afterwards must NOT flip it back; seq 2's
    # unless_success (still PENDING) must mark FAILURE
    await ring.apply_many(
        [
            ("update", s, 1, TransactionState.FAILURE),
            ("update", s, 1, TransactionState.SUCCESS),
            ("unless_success", s, 1),
            ("unless_success", s, 2),
        ]
    )
    states = {t.sender_sequence: t.state for t in await ring.get_all()}
    assert states == {
        1: TransactionState.SUCCESS,
        2: TransactionState.FAILURE,
    }


@pytest.mark.asyncio
async def test_run_exclusive_applies_and_returns():
    accounts = Accounts()
    a, b = b"\x06" * 32, b"\x07" * 32

    def txn(acc):
        acc._transfer(a, 1, b, 100)
        try:
            acc._transfer(a, 1, b, 100)  # duplicate sequence
        except AccountModificationError as exc:
            return exc
        return None

    err = await accounts.run_exclusive(txn)
    assert isinstance(err, AccountModificationError)
    assert await accounts.get_balance(b) == INITIAL_BALANCE + 100
    assert await accounts.get_last_sequence(a) == 1


# -- differential against the reference ledger --


def _ledger_ops(seed: int, n_users: int = 6, n_ops: int = 300):
    """A seeded transfer stream: mostly next-in-line sequences, with gaps,
    replays, self-transfers, overdrafts and u64-edge amounts."""
    rng = np.random.default_rng(seed)
    users = [rng.bytes(32) for _ in range(n_users)]
    last = {u: 0 for u in users}
    ops = []
    for _ in range(n_ops):
        sender = users[int(rng.integers(n_users))]
        recipient = users[int(rng.integers(n_users))]
        seq = last[sender] + int(rng.choice([1, 1, 1, 1, 2, 0]))
        amount = [int(rng.integers(0, 5000)), 0, INITIAL_BALANCE + 1, 2**64 - 1][int(rng.integers(4))]
        ops.append((sender, seq, recipient, amount))
        last[sender] = max(last[sender], seq)
    return users, ops


async def _replay(pkg: str, users, ops, path) -> dict:
    """The stream through one package's Accounts and RecentTransactions;
    the outcome of every transfer, every account, and the checkpoint."""
    accounts_mod = importlib.import_module(f"{pkg}.ledger.accounts")
    recent_mod = importlib.import_module(f"{pkg}.ledger.recent")
    ckpt = importlib.import_module(f"{pkg}.ledger.checkpoint")
    types = importlib.import_module(f"{pkg}.types")
    accounts, recent = accounts_mod.Accounts(), recent_mod.RecentTransactions()
    outcomes = []
    for sender, seq, recipient, amount in ops:
        try:
            await accounts.transfer(sender, seq, recipient, amount)
            outcomes.append("ok")
        except accounts_mod.AccountModificationError as exc:
            outcomes.append(exc.source.kind.value)
        await recent.put(sender, seq, types.ThinTransaction(recipient, amount))
        if outcomes[-1] == "ok":
            await recent.update(sender, seq, types.TransactionState.SUCCESS)
    await ckpt.save(str(path), accounts, recent)
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    for row in doc["recent"]:
        row[0] = "<timestamp>"  # wall-clock stamps differ between the runs
    return {
        "outcomes": outcomes,
        "accounts": [(await accounts.get_balance(u), await accounts.get_last_sequence(u)) for u in users],
        "checkpoint": json.dumps(doc, sort_keys=True),
        "digest": (list(accounts.digest.ranges), accounts.digest.wm),
    }


@pytest.mark.parametrize("seed", [3, 31])
async def test_ledger_equals_the_reference_on_a_seeded_stream(seed, tmp_path):
    users, ops = _ledger_ops(seed)
    ref = await _replay("at2_node_tpu", users, ops, tmp_path / "ref.json")
    port = await _replay("at2_node_tpu_torch", users, ops, tmp_path / "port.json")
    assert port == ref
    assert {"ok", "inconsecutive sequence", "underflow"} <= set(port["outcomes"])
