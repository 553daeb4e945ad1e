"""One run of a net cell: four ``server run`` nodes under closed-loop
gRPC clients, a measured window, the drain, the reference's judgement.

The window opens after the traffic file's ``warmup_s`` of load and lasts
``--seconds``. ``committed_tx_per_s`` counts the transfers that became
committed on every node inside it: at each end, each client's last
committed sequence is read on all nodes, and the smallest of them counts.
After the window the clients stop sending, the in-flight transfers drain
(untimed, up to ``drain_s``), and the harness reads every node's ledger,
then stops the nodes with SIGTERM.

What is compared (every limit is 0: the comparisons are exact):

* ``valid_refused``: valid transfers whose call did not return OK;
* ``valid_not_committed``: valid transfers sent but not committed on
  every node when the drain ended;
* ``ledger_mismatches``: (node, account) pairs whose sequence or balance
  differs from the reference ledger's (benchmark/reference/ledger.py)
  over the transfers sent;
* ``twins_accepted``: tampered twins whose call returned OK;
* ``twins_unanswered``: tampered twins refused with another code than
  INVALID_ARGUMENT, or not answered;
* ``sample_mismatches``: a seeded sample of sent valid transfers and
  twins, each verified by the plain RFC 8032 reference, against what the
  net did with it (a valid one committed on every node, a twin refused);
* ``clients_capped``: clients that reached their ``debit_cap`` before
  the window closed. Not a fault of the program: the traffic ran out, so
  the rate no longer measures the net. The cap is the initial balance
  less one call's largest debit; credits from the ring are not counted
  against it, since no node promises to commit them before the debits
  they would cover. It puts the cell's ceiling at ``clients`` x cap /
  (``warmup_s`` + the window) transfers a second.

The run is refused (``loaded_forbidden``) if a node or a generator
process loaded a module that :mod:`benchmark.harness.guard` forbids, or
if a node wrote no list of what it loaded.
"""

from __future__ import annotations

import asyncio
import multiprocessing
import os
import random
import tempfile
import time
from typing import Dict, List

import grpc

from benchmark.harness import chrome, guard, netload, workload
from benchmark.harness.net import SERVER, Net, Reader
from benchmark.harness.window import Window
from benchmark.reference import ed25519 as ref_ed25519
from benchmark.reference import ledger as ref_ledger

OK = grpc.StatusCode.OK.value[0]
INVALID_ARGUMENT = grpc.StatusCode.INVALID_ARGUMENT.value[0]
CRAFTED = tuple(workload.CRAFTED_KEYS.values())
LIMITS = {"valid_refused": 0, "valid_not_committed": 0, "ledger_mismatches": 0,
          "twins_accepted": 0, "twins_unanswered": 0, "sample_mismatches": 0, "clients_capped": 0}


def _gen_params(config: dict, traffic: dict, seed: int, uris: List[str]) -> dict:
    n = config["nodes"]
    return {
        "seed": seed, "clients": traffic["clients"], "rpc": traffic["rpc"],
        "rpc_batch": traffic["rpc_batch"], "in_flight": traffic["in_flight"],
        "amounts": traffic["amounts"], "tamper_share": traffic["tamper_share"],
        "tamper_classes": traffic["tamper_classes"], "call_timeout_s": traffic["call_timeout_s"],
        "twin_min_interval_s": traffic["twin_min_interval_s"],
        # no client can overdraw, whatever order its debits and the ring's
        # credits commit in: its debits stay within its initial balance
        "debit_cap": config["initial_balance"] - max(traffic["amounts"]) * traffic["rpc_batch"],
        "uris": [uris[c % n] for c in range(traffic["clients"])],
    }


def _spawn_generators(config: dict, traffic: dict, seed: int, uris: List[str]):
    """Generator processes, ``generator_processes_per_node`` a node; client
    c sends to node c mod n."""
    ctx = multiprocessing.get_context("spawn")
    n, per = config["nodes"], traffic["generator_processes_per_node"]
    base = _gen_params(config, traffic, seed, uris)
    gens = []
    for g in range(n * per):
        node, part = divmod(g, per)
        mine = [c for c in range(traffic["clients"]) if c % n == node and (c // n) % per == part]
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=netload.main, args=(child, {**base, "mine": mine}), daemon=True)
        proc.start()
        child.close()
        gens.append((proc, parent))
    return gens


def _recv(conn, timeout_s: float, what: str):
    if not conn.poll(timeout_s):
        raise RuntimeError(f"a generator process sent no {what} in {timeout_s} s")
    msg = conn.recv()
    if isinstance(msg, dict) and "error" in msg:
        raise RuntimeError(f"a generator process failed: {msg['error']}")
    return msg


async def _snapshot(reader: Reader, net: Net, publics: List[bytes]):
    """(wall clock at the middle of the reads, [node][client] sequences,
    every node's /metrics), read side by side."""
    loop = asyncio.get_running_loop()
    t0 = time.time()
    seqs, metrics = await asyncio.gather(reader.sequences(publics), loop.run_in_executor(None, net.metrics))
    return (t0 + time.time()) / 2, seqs, metrics


def _committed(seqs) -> List[int]:
    """Each client's sequence committed on every node."""
    return [min(col) for col in zip(*seqs)]


def _drive(net: Net, gens, traffic: dict, seed: int, seconds: float, t_start: float, memory) -> dict:
    keys = [workload.key(seed, "client", i) for i in range(traffic["clients"])]
    publics = [k.public for k in keys]

    async def go():
        reader = Reader(net.uris)
        try:
            for _, conn in gens:
                conn.send("go")
            await asyncio.sleep(traffic["warmup_s"])
            t_open, seq_open, m_open = await _snapshot(reader, net, publics)
            await asyncio.sleep(max(0.0, t_open + seconds - time.time()))
            t_close, seq_close, m_close = await _snapshot(reader, net, publics)
            for _, conn in gens:
                conn.send("stop")
            loop = asyncio.get_running_loop()
            results = await asyncio.gather(*(loop.run_in_executor(None, _recv, conn, 120.0, "result")
                                             for _, conn in gens))
            clients = sorted((c for r in results for c in r["clients"]), key=lambda c: c["index"])
            last_sent = [c["last_sent"] for c in clients]
            t_end = time.monotonic() + traffic["drain_s"]
            while True:
                final = await reader.sequences(publics)
                if all(s >= want for s, want in zip(_committed(final), last_sent)) or time.monotonic() > t_end:
                    break
                await asyncio.sleep(0.25)
            accounts = publics + list(CRAFTED)
            seqs = await reader.sequences(accounts)
            balances = await reader.balances(accounts)
            return dict(t_open=t_open, t_close=t_close, seq_open=seq_open, seq_close=seq_close,
                        m_open=m_open, m_close=m_close, clients=clients, last_sent=last_sent,
                        accounts=accounts, seqs=seqs, balances=balances,
                        gen_modules=[r["modules"] for r in results])
        finally:
            await reader.close()

    out = asyncio.run(go())
    out["keys"] = keys
    out["setup_s"] = out["t_open"] - t_start
    out["memory_peak_bytes"] = memory()
    return out


def _judge(d: dict, config: dict, traffic: dict, seed: int) -> Dict[str, int]:
    """The compared numbers of LIMITS, worked out by the reference."""
    keys, publics = d["keys"], [k.public for k in d["keys"]]
    records = [r for c in d["clients"] for r in c["records"]]
    twins = [t for c in d["clients"] for t in c["twins"]]
    final = _committed(d["seqs"])[: len(publics)]
    valid_refused = sum(r[2] for r in records if not r[3] and r[4] != OK)
    valid_not_committed = sum(max(0, want - got) for want, got in zip(d["last_sent"], final))
    # the reference ledger over every valid transfer sent
    sent = [[workload.transfer(seed, publics, c, s, traffic["amounts"]) for s in range(1, d["last_sent"][c] + 1)]
            for c in range(len(publics))]
    ledger = ref_ledger.final_state(sent, config["initial_balance"])
    ledger_mismatches = 0
    for node_seqs, node_bal in zip(d["seqs"], d["balances"]):
        for a, s, b in zip(d["accounts"], node_seqs, node_bal):
            ledger_mismatches += s != ledger.sequence_of(a) or b != ledger.balance_of(a)
    twins_accepted = sum(1 for t in twins if t[-1] == OK)
    twins_unanswered = sum(1 for t in twins if t[-1] not in (OK, INVALID_ARGUMENT))
    # a seeded sample, each item verified by the plain reference
    rng = random.Random(f"sample/{seed}")
    by_class: Dict[str, list] = {}
    for t in twins:
        by_class.setdefault(t[1], []).append(t)
    sample_twins = []
    for cls in sorted(by_class):
        rng.shuffle(by_class[cls])
    while len(sample_twins) < traffic["sample_twins"] and any(by_class.values()):
        for cls in sorted(by_class):
            if by_class[cls] and len(sample_twins) < traffic["sample_twins"]:
                sample_twins.append(by_class[cls].pop())
    mismatches = 0
    for _, _, sender, seq, recipient, amount, sig, status in sample_twins:
        ok = ref_ed25519.verify(sender, workload.signing_bytes(sender, seq, recipient, amount), sig)
        mismatches += ok != (status == OK)
    candidates = [(c, s) for c in range(len(publics)) for s in (1, d["last_sent"][c]) if d["last_sent"][c] >= s]
    candidates += [(c, rng.randint(1, d["last_sent"][c])) for c in range(len(publics))
                   for _ in range(4) if d["last_sent"][c] >= 1]
    rng.shuffle(candidates)
    for c, s in candidates[: traffic["sample_valid"]]:
        t = workload.transfer(seed, publics, c, s, traffic["amounts"])
        ok = ref_ed25519.verify(t[0], workload.signing_bytes(*t), keys[c].sign(workload.signing_bytes(*t)))
        mismatches += ok != (final[c] >= s)
    clients_capped = sum(1 for c in d["clients"] if c["capped_at"] is not None and c["capped_at"] < d["t_close"])
    return {"valid_refused": valid_refused, "valid_not_committed": valid_not_committed,
            "ledger_mismatches": ledger_mismatches, "twins_accepted": twins_accepted,
            "twins_unanswered": twins_unanswered, "sample_mismatches": mismatches,
            "clients_capped": clients_capped}


def run(cell, seed: int, seconds: float, traced: bool, t_start: float, env: dict, card: str,
        memory, server_target=None, build=None) -> dict:
    config, traffic = cell.config, cell.traffic
    workdir = tempfile.mkdtemp(prefix="at2-bench-")
    if build is not None:
        build(config["verifier"]["kind"])
    net = Net(config, seed, workdir, env, server_target or SERVER, traced)
    gens = _spawn_generators(config, traffic, seed, net.uris)
    try:
        net.spawn()
        for _, conn in gens:
            _recv(conn, traffic["up_deadline_s"], "ready")
        net.wait_up(traffic["up_deadline_s"])
        d = _drive(net, gens, traffic, seed, seconds, t_start, memory)
    except BaseException:
        net.kill()
        raise
    finally:
        for proc, conn in gens:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
            conn.close()
    rcs = net.stop()
    loaded_forbidden = []
    for i, names in enumerate(net.loaded_modules()):
        if names is None:
            loaded_forbidden.append(f"node {i}: wrote no list of its modules")
        elif guard.forbidden(names):
            loaded_forbidden.append(f"node {i}: {', '.join(guard.forbidden(names))}")
    for i, names in enumerate(d["gen_modules"]):
        if guard.forbidden(names):
            loaded_forbidden.append(f"generator {i}: {', '.join(guard.forbidden(names))}")
    records = [r for c in d["clients"] for r in c["records"]]
    committed = sum(b - a for a, b in zip(_committed(d["seq_open"]), _committed(d["seq_close"])))
    window = Window(d["t_open"], d["t_close"], card, calls=records, committed=committed,
                    counters=list(zip(d["m_open"], d["m_close"])))
    notes = []
    if traced:
        paths = net.trace_files()
        notes.append(f"traces: {len(paths)} files, {sum(os.path.getsize(p) for p in paths)} bytes")
        events = [ev for path in paths for ev in chrome.load(path)]
        window.device = chrome.DeviceWindow.from_events(events, d["t_open"], d["t_close"])
    checks = _judge(d, config, traffic, seed)
    inside = [r for r in records if d["t_open"] <= r[0] < d["t_close"]]
    final = _committed(d["seqs"])
    failed = sum(r[2] for r in inside if not r[3] and r[4] != OK)
    # acknowledged valid transfers not committed on every node
    failed += sum(max(0, r[6] + r[2] - 1 - max(final[r[5]], r[6] - 1))
                  for r in inside if not r[3] and r[4] == OK)
    return {
        "window": window, "setup_s": d["setup_s"], "memory_peak_bytes": d["memory_peak_bytes"],
        "attempted": sum(r[2] for r in inside), "failed": failed,
        "rates": {"committed_tx_per_s": committed / window.seconds},
        "checks": {k: (v, LIMITS[k]) for k, v in checks.items()},
        "loaded_forbidden": loaded_forbidden,
        "notes": notes + [f"calls sent in the window: {len(inside)}", f"committed in the window: {committed}",
                  f"node exit codes after SIGTERM: {rcs}",
                  "verifier signatures / batches in the window: "
                  f"{window.delta('at2_verifier_signatures'):.0f} / {window.delta('at2_verifier_batches'):.0f}; "
                  f"occupancy at its end: {[round(c.get('at2_verifier_batch_occupancy', -1), 4) for _, c in window.counters]}"],
        "workdir": workdir,
    }
