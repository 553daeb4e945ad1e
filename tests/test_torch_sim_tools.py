"""The port's five sim CLIs, run as their users run them.

* Every short gate of ``chip_smoke.SIM_GATES`` (the reference's
  ``scripts/ci.sh`` sim gates but the 50-episode campaign and the full
  grid, which phase 11 of ``chip_smoke.py`` runs) through the port's CLI as
  a subprocess: exit 0, its own bar held (no failing episode, no breaching
  cell, the A/B claim), and the hash the JAX package's CLI prints for it.
  The checks are phase 11's own (``chip_smoke.sim_gate_result``).
* The re-exec: ``sim_run``, ``scenario_grid`` and ``overload_ab`` started
  without ``PYTHONHASHSEED`` re-execute themselves under
  ``PYTHONHASHSEED=0`` as the port's modules, never the JAX package's, and
  the documents they bank name the port's tools.
* ``capture_replay``: a capture of an in-process port net over real
  sockets replays in both packages' sims to the same verdict hash, twice;
  the CLI replays the same file deterministically.
* ``bench_finality``: the production block and the wire bytes equal the
  reference's and the pinned ones; the CLI prints its document and writes
  no file unless asked.
"""

import asyncio
import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from at2_node_tpu_torch.broadcast.messages import CERT_SIG_WIRE, Payload
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.node.config import VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.tools import bench_finality
from at2_node_tpu_torch.tools._common import make_net_configs
from at2_node_tpu_torch.tools.capture_replay import replay_capture, verdict_hash
from at2_node_tpu_torch.types import ThinTransaction

SHORT_GATES = [name for name, gate in chip_smoke.SIM_GATES.items() if gate["short"]]


@pytest.mark.parametrize("name", SHORT_GATES)
def test_cli_gate_reproduces_reference_hash(name):
    gate = chip_smoke.SIM_GATES[name]
    run = chip_smoke.sim_tool(f"at2_node_tpu_torch.tools.{gate['tool']}", gate["argv"])
    res = chip_smoke.sim_gate_result(name, run)
    assert res["hash"] == gate["hash"], (name, res["hash"])
    if "p99_ms" in gate:
        assert res["p99_ms"] == gate["p99_ms"]
        assert res["committed"] == res["offered"]
    if "arms" in res:
        assert not res["arms"]["uncontrolled"]["slo_ok"] and res["arms"]["controlled"]["slo_ok"]


def test_short_gates_cover_every_tool():
    assert len(SHORT_GATES) == 8
    assert {chip_smoke.SIM_GATES[n]["tool"] for n in SHORT_GATES} == {"sim_run", "scenario_grid", "overload_ab"}
    assert {n for n, g in chip_smoke.SIM_GATES.items() if not g["short"]} == {"campaign", "grid_full"}


# a sitecustomize that records, at exit, the hash seed, argv and the
# at2 modules of whichever process finally runs the tool (the first one
# replaces itself with os.execve, so its atexit never runs)
_PROBE = """
import atexit, json, os, sys

def _report():
    mods = sorted(m for m in sys.modules if m.startswith("at2_node_tpu"))
    with open(os.environ["AT2_PROBE_OUT"], "a") as f:
        main = getattr(sys.modules.get("__main__"), "__file__", None)
        f.write(json.dumps({"hashseed": os.environ.get("PYTHONHASHSEED"), "argv": sys.argv, "main": main,
                            "modules": mods}) + "\\n")

if os.environ.get("AT2_PROBE_OUT"):
    atexit.register(_report)
"""


@pytest.mark.parametrize(
    "tool,argv",
    [
        ("sim_run", ["--seed", "7", "--episodes", "1", "--events", "6", "--duration", "4", "--quiet"]),
        ("scenario_grid", ["--seed", "7", "--smoke", "--txs", "8", "--duration", "2", "--quiet", "--json"]),
        ("overload_ab", ["--seed", "5", "--clients", "12", "--crowd", "8", "--txs", "16",
                         "--workload", "flash_crowd", "--quiet", "--json"]),
    ],
)
def test_cli_reexec_runs_the_port(tool, argv, tmp_path):
    probe_dir = tmp_path / "probe"
    probe_dir.mkdir()
    (probe_dir / "sitecustomize.py").write_text(_PROBE)
    out = tmp_path / "probe.jsonl"
    env = chip_smoke.checkout_env()
    env.pop("PYTHONHASHSEED", None)
    env["PYTHONPATH"] = str(probe_dir) + os.pathsep + env["PYTHONPATH"]
    env["AT2_PROBE_OUT"] = str(out)
    proc = subprocess.run([sys.executable, "-m", f"at2_node_tpu_torch.tools.{tool}", *argv],
                          capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode in (0, 1), proc.stderr[-3000:]  # 1: a small A/B may not hold its claim
    reports = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(reports) == 1, reports  # the re-executed process, and only it
    rep = reports[0]
    assert rep["hashseed"] == "0"
    tool_file = os.path.join("at2_node_tpu_torch", "tools", f"{tool}.py")
    assert rep["argv"][0].endswith(tool_file) and rep["main"].endswith(tool_file)
    assert "at2_node_tpu_torch.sim.campaign" in rep["modules"]
    assert not [m for m in rep["modules"] if m == "at2_node_tpu" or m.startswith("at2_node_tpu.")]
    if "--json" in argv:
        assert json.loads(proc.stdout)["generated_by"] == f"at2_node_tpu_torch.tools.{tool}"


# -- capture_replay -----------------------------------------------------------


async def _capture_of_port_net() -> dict:
    """ci.sh's capture contract on the port: three port nodes over real
    sockets commit 24 payloads; node 1's inbound capture after a beacon."""
    cfgs = make_net_configs(3, iter(chip_smoke.free_ports(6)), seed=41, verifier=VerifierConfig(kind="cpu"))
    services = []
    try:
        for c in cfgs:
            services.append(await Service.start(c))
        sender = SignKeyPair.from_hex("66" * 32)
        recipient = SignKeyPair.from_hex("67" * 32).public
        for seq in range(1, 25):
            await services[0].broadcast.broadcast(Payload.create(sender, seq, ThinTransaction(recipient, 1)))
        loop = asyncio.get_running_loop()
        t_end = loop.time() + 120
        while any(s.committed < 24 for s in services):
            assert loop.time() < t_end, [s.committed for s in services]
            await asyncio.sleep(0.02)
        for s in services:
            s._emit_beacon()
        await asyncio.sleep(0.3)
        return services[1].mesh.capture_dump()
    finally:
        for s in services:
            await s.close()


async def test_capture_replay_same_verdict_in_both_packages(tmp_path):
    from at2_node_tpu.tools.capture_replay import replay_capture as ref_replay_capture
    from at2_node_tpu.tools.capture_replay import verdict_hash as ref_verdict_hash

    doc = await _capture_of_port_net()
    assert doc["records"], "capture ring stayed empty"
    kinds = {r[2] for r in doc["records"]}
    assert len(kinds) >= 3, kinds  # payloads, attestations and beacons at least

    mine = [await asyncio.to_thread(replay_capture, doc, 5) for _ in range(2)]
    ref = await asyncio.to_thread(ref_replay_capture, doc, 5)
    hashes = {verdict_hash(v) for v in mine}
    assert len(hashes) == 1
    assert hashes == {ref_verdict_hash(ref)}
    assert mine[0] == ref
    assert not mine[0]["violations"]
    assert mine[0]["injected"] == len(doc["records"])

    path = tmp_path / "capturez.json"
    path.write_text(json.dumps({"node": "n1", **doc}))
    run = await asyncio.to_thread(
        chip_smoke.sim_tool, "at2_node_tpu_torch.tools.capture_replay",
        (str(path), "--seed", "5", "--repeat", "2", "--json"))
    assert run["rc"] == 0, run["err"][-3000:]
    verdict = json.loads(run["out"])
    assert verdict["deterministic"] is True
    assert verdict["violations"] == []
    assert verdict["injected"] == len(doc["records"])


# -- bench_finality -----------------------------------------------------------


def test_bench_finality_production_equals_reference():
    from at2_node_tpu.tools import bench_finality as ref_bench

    kw = dict(nodes=4, txs=48, audit_every=8, seed=7)
    mine = bench_finality.bench_production(**kw)
    ref = ref_bench.bench_production(**kw)
    assert mine == ref == chip_smoke.SIM_FINALITY["production"]
    _, cert = bench_finality.bench_verify(nodes=4, iters=2, seed=7)
    _, ref_cert = ref_bench.bench_verify(nodes=4, iters=2, seed=7)
    assert cert.encode() == ref_cert.encode()
    assert len(cert.encode()) == chip_smoke.SIM_FINALITY["cert_wire_bytes"]
    assert CERT_SIG_WIRE == chip_smoke.SIM_FINALITY["cosig_wire_bytes"]


def test_bench_finality_cli_prints_and_writes_only_when_asked(tmp_path):
    env = chip_smoke.checkout_env()
    argv = [sys.executable, "-m", "at2_node_tpu_torch.tools.bench_finality", "--verify-iters", "4"]
    proc = subprocess.run(argv, capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout)
    for key, want in chip_smoke.SIM_FINALITY.items():
        assert doc[key] == want, key
    assert doc["ok"] and doc["verify"]["subset_per_s"] > 0
    assert os.listdir(tmp_path) == []  # no BENCH_FINALITY.json unless --out
    proc = subprocess.run(argv + ["--out", "fin.json"], capture_output=True, text=True, env=env,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0
    with open(tmp_path / "fin.json") as f:
        assert json.load(f)["production"] == doc["production"]
