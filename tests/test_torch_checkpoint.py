"""Checkpoint/resume: the port's twin of ``tests/test_checkpoint.py``.

The reference's four cases on the port's modules, each held against the
reference: a snapshot round trip (each package loads the other's file,
and both write the same document), a missing checkpoint as a fresh
start, a corrupt checkpoint raising as the reference raises, and a
single served node that resumes its ledger after a restart.
"""

import asyncio
import importlib
import json

import numpy as np
import pytest

import chip_smoke
from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
from at2_node_tpu_torch.node.config import CheckpointConfig, Config, VerifierConfig
from at2_node_tpu_torch.node.service import Service

PACKAGES = ("at2_node_tpu_torch", "at2_node_tpu")


def _ledger(pkg: str):
    """(checkpoint module, Accounts, RecentTransactions, ThinTransaction,
    TransactionState) of one package."""
    ckpt = importlib.import_module(f"{pkg}.ledger.checkpoint")
    accounts = importlib.import_module(f"{pkg}.ledger.accounts").Accounts
    recent = importlib.import_module(f"{pkg}.ledger.recent").RecentTransactions
    types = importlib.import_module(f"{pkg}.types")
    return ckpt, accounts, recent, types.ThinTransaction, types.TransactionState


async def _write(pkg: str, path: str) -> None:
    """The reference test's ledger (alice pays bob 500, the ring holds it
    as SUCCESS), saved by ``pkg``."""
    ckpt, Accounts, Recent, Thin, State = _ledger(pkg)
    accounts, recent = Accounts(), Recent()
    alice, bob = b"\x01" * 32, b"\x02" * 32
    await accounts.transfer(alice, 1, bob, 500)
    await recent.put(alice, 1, Thin(bob, 500))
    await recent.update(alice, 1, State.SUCCESS)
    await ckpt.save(path, accounts, recent)


async def _read(pkg: str, path: str) -> tuple:
    """``path`` loaded by ``pkg``: (load's answer, alice's and bob's
    balances, alice's sequence, the ring as plain values)."""
    ckpt, Accounts, Recent, _, _ = _ledger(pkg)
    accounts, recent = Accounts(), Recent()
    ok = await ckpt.load(path, accounts, recent)
    alice, bob = b"\x01" * 32, b"\x02" * 32
    txs = await recent.get_all()
    return (ok, await accounts.get_balance(alice), await accounts.get_balance(bob),
            await accounts.get_last_sequence(alice),
            [(t.sender, t.amount, t.state.name) for t in txs])


class TestSnapshotRoundtrip:
    @pytest.mark.parametrize("writer", PACKAGES)
    async def test_accounts_and_ring_roundtrip(self, tmp_path, writer):
        path = str(tmp_path / "ledger.json")
        await _write(writer, path)
        read = {pkg: await _read(pkg, path) for pkg in PACKAGES}
        assert read["at2_node_tpu_torch"] == read["at2_node_tpu"]
        ok, alice, bob, seq, txs = read["at2_node_tpu_torch"]
        assert ok is True
        assert (alice, bob, seq) == (99_500, 100_500, 1)
        assert txs == [(b"\x01" * 32, 500, "SUCCESS")]

    async def test_both_packages_write_the_same_document(self, tmp_path):
        docs = {}
        for pkg in PACKAGES:
            await _write(pkg, str(tmp_path / f"{pkg}.json"))
            docs[pkg] = json.loads((tmp_path / f"{pkg}.json").read_text())
            # a ring entry's first field is its wall-clock timestamp
            docs[pkg]["recent"] = [row[1:] for row in docs[pkg]["recent"]]
        assert docs["at2_node_tpu_torch"] == docs["at2_node_tpu"]

    async def test_load_missing_is_fresh_start(self, tmp_path):
        for pkg in PACKAGES:
            ckpt, Accounts, Recent, _, _ = _ledger(pkg)
            assert await ckpt.load(str(tmp_path / "absent.json"), Accounts(), Recent()) is False

    @pytest.mark.parametrize("body", [json.dumps({"version": 99}), '{"version": 1, "acc'],
                             ids=["unknown_version", "truncated"])
    async def test_corrupt_checkpoint_raises(self, tmp_path, body):
        path = tmp_path / "bad.json"
        path.write_text(body)
        raised = {}
        for pkg in PACKAGES:
            ckpt, Accounts, Recent, _, _ = _ledger(pkg)
            with pytest.raises(ValueError) as exc:
                await ckpt.load(str(path), Accounts(), Recent())
            raised[pkg] = (type(exc.value).__name__, str(exc.value))
        assert raised["at2_node_tpu_torch"] == raised["at2_node_tpu"]


class TestNodeRestart:
    async def test_single_node_resumes_ledger_after_restart(self, tmp_path):
        ckpt_path = str(tmp_path / "node.ckpt")
        rng = np.random.default_rng(13)
        node_key, network_key = SignKeyPair(rng.bytes(32)), ExchangeKeyPair(rng.bytes(32))

        def make_config():
            node, rpc = chip_smoke.free_ports(2)
            return Config(
                node_address=f"127.0.0.1:{node}",
                rpc_address=f"127.0.0.1:{rpc}",
                sign_key=node_key,
                network_key=network_key,
                verifier=VerifierConfig(kind="cpu"),  # the port's default is the card's
                checkpoint=CheckpointConfig(path=ckpt_path, interval=60.0),
            )

        async def wait_sequence(client, key, want):
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline:
                if await client.get_last_sequence(key) == want:
                    return
                await asyncio.sleep(0.1)

        sender, recipient = SignKeyPair(rng.bytes(32)), SignKeyPair(rng.bytes(32))

        service = await Service.start(make_config())
        try:
            async with Client(f"http://{service.config.rpc_address}") as client:
                await client.send_asset(sender, 1, recipient.public, 777)
                await wait_sequence(client, sender.public, 1)
                assert await client.get_balance(sender.public) == 99_223
        finally:
            await service.close()  # writes the final snapshot

        # the reference reads what the port's node wrote on its way down
        assert await _read_balances("at2_node_tpu", ckpt_path, sender, recipient) == (99_223, 100_777, 1)

        # a NEW process-equivalent: fresh Service, same checkpoint path
        service2 = await Service.start(make_config())
        try:
            async with Client(f"http://{service2.config.rpc_address}") as client:
                assert await client.get_balance(sender.public) == 99_223
                assert await client.get_balance(recipient.public) == 100_777
                assert await client.get_last_sequence(sender.public) == 1
                # the sequence gate carries over: replaying seq 1 must not
                # double-apply, and seq 2 continues normally
                await client.send_asset(sender, 2, recipient.public, 1)
                await wait_sequence(client, sender.public, 2)
                assert await client.get_balance(sender.public) == 99_222
        finally:
            await service2.close()


async def _read_balances(pkg: str, path: str, sender, recipient) -> tuple:
    ckpt, Accounts, Recent, _, _ = _ledger(pkg)
    accounts = Accounts()
    assert await ckpt.load(path, accounts, Recent()) is True
    return (await accounts.get_balance(sender.public), await accounts.get_balance(recipient.public),
            await accounts.get_last_sequence(sender.public))
