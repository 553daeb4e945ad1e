"""The port's slice end to end on the CPU, against the JAX package: 200
client-signed transfers, some tampered, go through each package's batch
verifier and ledger. Verdicts, committed ledger state and the ledger's
audit digests must be identical."""

import numpy as np
import pytest
import torch

from at2_node_tpu.crypto.verifier import TpuBatchVerifier
from at2_node_tpu.ledger.accounts import AccountModificationError as RefModError
from at2_node_tpu.ledger.accounts import Accounts as RefAccounts
from at2_node_tpu.types import transfer_signing_bytes as ref_signing_bytes
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.crypto.verifier import make_verifier
from at2_node_tpu_torch.ledger.accounts import AccountModificationError, Accounts
from at2_node_tpu_torch.types import TRANSFER_SIG_TAG, ThinTransaction, transfer_signing_bytes

# These tensors are small: more intra-op threads only spin, and take
# cores from the tests that run beside these in other processes.
torch.set_num_threads(1)

N_KEYS, N_SEQ = 20, 10


def _traffic(seed=0x5_11CE):
    """(items, transfers, tampered): 200 signed transfers in sequence
    order; about one in ten is tampered on the wire."""
    rng = np.random.default_rng(seed)
    keys = [SignKeyPair(rng.bytes(32)) for _ in range(N_KEYS)]
    items, transfers, tampered = [], [], []
    for seq in range(1, N_SEQ + 1):
        for k, kp in enumerate(keys):
            tx = ThinTransaction(keys[(k + 3 * seq) % N_KEYS].public, int(rng.integers(1, 30_000)))
            msg = transfer_signing_bytes(kp.public, seq, tx.recipient, tx.amount)
            assert msg == ref_signing_bytes(kp.public, seq, tx.recipient, tx.amount)
            sig = kp.sign(msg)
            bad = rng.random() < 0.1
            if bad:
                if rng.random() < 0.5:
                    sig = bytes([sig[0] ^ 0x10]) + sig[1:]
                else:  # the amount on the wire differs from the signed one
                    msg = transfer_signing_bytes(kp.public, seq, tx.recipient, tx.amount + 1)
            items.append((kp.public, msg, sig))
            transfers.append((kp.public, seq, tx.recipient, tx.amount))
            tampered.append(bad)
    return items, transfers, tampered


ITEMS, TRANSFERS, TAMPERED = _traffic()


async def _commit(accounts, error, verdicts):
    for ok, transfer in zip(verdicts, TRANSFERS):
        if ok:
            try:
                await accounts.transfer(*transfer)
            except error:
                pass  # a sequence gap left by a rejected transfer
    return await accounts.export_state()


async def test_slice_matches_reference():
    port_ver = make_verifier("cuda", device="cpu", batch_size=64, max_delay=0.002)
    port_verdicts = await port_ver.verify_many(ITEMS)
    await port_ver.close()

    ref_ver = TpuBatchVerifier(batch_size=64, max_delay=0.002)
    ref_verdicts = await ref_ver.verify_many(ITEMS)
    await ref_ver.close()

    assert port_verdicts == ref_verdicts == [not t for t in TAMPERED]
    assert 5 < sum(TAMPERED) < 40

    port_accounts, ref_accounts = Accounts(), RefAccounts()
    port_state = await _commit(port_accounts, AccountModificationError, port_verdicts)
    ref_state = await _commit(ref_accounts, RefModError, ref_verdicts)
    assert port_state == ref_state
    assert len(port_state) == N_KEYS
    assert port_accounts.digest.ranges == ref_accounts.digest.ranges
    assert port_accounts.digest.wm == ref_accounts.digest.wm

    # the port's ledger resumes from the reference's checkpoint as it is
    resumed = Accounts()
    await resumed.import_state(ref_state)
    assert await resumed.export_state() == ref_state
    assert resumed.digest.ranges_bytes() == ref_accounts.digest.ranges_bytes()
    assert resumed.digest.wm_bytes() == ref_accounts.digest.wm_bytes()
    sender = ITEMS[0][0]
    assert await resumed.get_balance(sender) == await ref_accounts.get_balance(sender)


async def test_ledger_rules_match_reference():
    """Overdraft, sequence gap, self-transfer and replay on both ledgers."""
    a, b = b"\x01" * 32, b"\x02" * 32
    ops = [
        (a, 1, b, 60_000), (a, 2, b, 60_000),  # second overdraws: sequence consumed
        (a, 2, b, 1), (a, 4, b, 1), (a, 3, a, 0),  # replay, gap, self-transfer
        (b, 1, a, 10), (b, 1, a, 10),
    ]
    states = []
    for accounts, error in ((Accounts(), AccountModificationError), (RefAccounts(), RefModError)):
        outcomes = []
        for op in ops:
            try:
                await accounts.transfer(*op)
                outcomes.append(True)
            except error as exc:
                outcomes.append(exc.source.kind.value)
        states.append((outcomes, await accounts.export_state(), await accounts.get_last_sequence(a)))
    assert states[0] == states[1]
    assert states[0][0] == [True, "underflow", "inconsecutive sequence",
                            "inconsecutive sequence", True, True, "inconsecutive sequence"]


def test_transfer_types_match_reference():
    from at2_node_tpu import types as ref_types

    assert TRANSFER_SIG_TAG == ref_types.TRANSFER_SIG_TAG
    with pytest.raises(ValueError):
        ThinTransaction(b"x" * 31, 1)
    with pytest.raises(ValueError):
        ThinTransaction(b"x" * 32, 1 << 64)
    with pytest.raises(ValueError):
        transfer_signing_bytes(b"x" * 32, 1, b"y" * 31, 5)
