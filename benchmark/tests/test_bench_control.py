"""The comparison that decides `correct`, shown to fail.

On the CPU, at a size a test run holds, with the harness's look for a
card skipped and the port's host verifier (OpenSSL, ``kind = "cpu"``) in
the kernel's place, so every cell's path runs here:

* the sound runs come out correct, on the tamper classes OpenSSL refuses
  as RFC 8032 does;
* the controls come out not correct: the program's own OpenSSL path,
  which decodes keys leniently, on every class (it accepts the
  non-canonical and x = 0 keys), and the plain reference with the
  cofactored equation in the program's place (it accepts R with a
  torsion component);
* each fault a cell can have, planted under the timed path, comes out
  not correct: a step that returns its state unchanged, half of a batch
  left out, an answer altered where it is produced. The cells run on
  one card, so there is no exchange between cards to leave out.

The card-marked test runs each cell's program as committed, briefly, and
must come out correct.
"""

import asyncio
import os

import pytest

from benchmark import run
from benchmark.harness import manifest
from benchmark.reference import ed25519 as ref

H100 = "NVIDIA H100 80GB HBM3"
HERE = os.path.dirname(os.path.abspath(__file__))
OPENSSL_SOUND = ["r_flip", "s_flip", "msg_flip", "high_s", "wrong_len", "r_torsion"]
CPU = {"kind": "cpu", "mode": "per_sig"}
NET = {"clients": 8, "warmup_s": 1.0, "drain_s": 5.0, "generator_processes_per_node": 1,
       "tamper_share": 0.02, "sample_valid": 16, "sample_twins": 16}
REPLAY_CONFIG = {"verifier": CPU, "trace_transfers": 2048, "trace_senders": 128}
REPLAY = {"chunk": 256, "callers": 2, "in_flight": 2, "sign_workers": 2, "warmup_s": 0.5,
          "sample": 48, "sample_per_class": 3, "tamper_share": 0.05}


def net_run(seed, classes, server_target=None, seconds=3.0, cell="net4-unary", **traffic):
    bench = with_all_pending() if cell == "net4-batched" else None
    return run.run_cell(cell, seed, seconds, False, require_card=False, card=H100,
                        overrides={"config": {"verifier": CPU},
                                   "traffic": {**NET, "tamper_classes": classes, **traffic}},
                        server_target=server_target, bench=bench)


def with_replay():
    return manifest.with_pending(manifest.load_manifest(), "net32-replay")


def with_all_pending():
    return manifest.with_pending(with_replay(), "net4-batched")


def replay_run(seed, classes, make_verifier=None, seconds=2.0, **traffic):
    return run.run_cell("net32-replay", seed, seconds, False, require_card=False, card=H100,
                        overrides={"config": REPLAY_CONFIG,
                                   "traffic": {**REPLAY, "tamper_classes": classes, **traffic}},
                        make_verifier=make_verifier, bench=with_replay())


def failing(result):
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", ["net4-unary", "net4-batched"])
def test_net_sound_run_is_correct(cell):
    r = net_run(2**31 + 7, OPENSSL_SOUND, cell=cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["metrics"]["committed_tx_per_s"]["value"] > 0
    assert r["loaded_forbidden"] == []


def test_net_control_openssl_is_not_correct():
    r = net_run(11, ["noncanonical_y", "x0_sign"])
    assert not r["correct"]
    assert {"twins_accepted", "sample_mismatches"} <= failing(r)


@pytest.mark.parametrize("fault,caught", [
    ("unchanged", "valid_not_committed"),
    ("half", "valid_not_committed"),
    ("altered", "ledger_mismatches"),
])
def test_net_fault_is_not_correct(fault, caught):
    r = net_run(21, OPENSSL_SOUND, server_target=[os.path.join(HERE, "faulty_server.py"), fault])
    assert not r["correct"]
    assert caught in failing(r)


def test_net_client_out_of_balance_before_the_close_is_not_correct():
    # transfers of 20,000 take a client to its cap after 4 of them, long
    # before the window closes: the rate would no longer measure the net
    r = net_run(22, OPENSSL_SOUND, amounts=[20000])
    assert not r["correct"]
    assert failing(r) == {"clients_capped"}


def test_net_node_that_loads_jax_is_refused():
    r = net_run(23, OPENSSL_SOUND, seconds=1.0,
                server_target=[os.path.join(HERE, "faulty_server.py"), "loads_jax"])
    assert r["correct"]
    assert len(r["loaded_forbidden"]) == 4 and all("jax" in f for f in r["loaded_forbidden"])


class _Wrapped:
    """The port's host verifier under a planted fault."""

    def __init__(self, fault):
        from at2_node_tpu_torch.crypto.verifier import make_verifier

        self.inner = make_verifier("cpu", mode="per_sig")
        self.fault = fault

    async def warmup(self):
        await self.inner.warmup()

    def stats(self):
        return self.inner.stats()

    async def close(self):
        await self.inner.close()

    async def verify_many(self, items):
        if self.fault == "unchanged":
            return [True] * len(items)
        if self.fault == "half":
            head = await self.inner.verify_many(items[: len(items) // 2])
            return head + [True] * (len(items) - len(head))
        out = await self.inner.verify_many(items)
        return [not out[0]] + out[1:]


class _CofactoredReference:
    """The plain reference with the cofactored equation, in the
    verifier's place."""

    async def warmup(self):
        pass

    def stats(self):
        return {}

    async def close(self):
        pass

    async def verify_many(self, items):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: [ref.verify(*i, cofactored=True) for i in items])


def test_replay_sound_run_is_correct():
    r = replay_run(2**33 + 1, OPENSSL_SOUND + ["a_torsion"])
    assert r["correct"], r["checks"]
    assert r["metrics"]["verified_sigs_per_s"]["value"] > 0


def test_replay_control_openssl_is_not_correct():
    r = replay_run(12, ["noncanonical_y", "x0_sign"])
    assert not r["correct"]
    assert {"label_mismatches", "sample_mismatches"} <= failing(r)


def test_replay_control_cofactored_reference_is_not_correct():
    r = replay_run(13, ["r_torsion"], make_verifier=lambda v: _CofactoredReference(), seconds=1.0,
                   chunk=64, warmup_s=0.1, tamper_share=0.2)
    assert not r["correct"]
    assert "label_mismatches" in failing(r)


@pytest.mark.parametrize("fault", ["unchanged", "half", "flip"])
def test_replay_fault_is_not_correct(fault):
    r = replay_run(14, OPENSSL_SOUND, make_verifier=lambda v: _Wrapped(fault))
    assert not r["correct"]
    assert "label_mismatches" in failing(r)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["net4-unary", "net32-replay", "net4-batched"])
def test_cell_on_the_card_is_correct(card, cell):
    r = run.run_cell(cell, 2**31 + 99, 5.0, False, bench=with_all_pending())
    assert r["correct"], r["checks"]
    assert r["device"]["kind"] == card
