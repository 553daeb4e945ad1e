"""Amortized-verification benchmarks: the RLC engine's crossover grid.

Counterpart of ``at2_node_tpu/tools/aggregate_bench.py``.

Default mode measures the CPU Verifier's three per-signature routes IN
PROCESS (native libraries only, no device) over a (batch size x failure
rate) grid:

* **per_sig_python** — one `verify_one` (OpenSSL via `cryptography`)
  call per signature: the host's per-signature crypto floor.
* **per_sig_native** — `verify_bulk_native` pinned to ONE thread: the
  bulk C path's per-core rate (thread fan-out scales it, but the grid
  is a per-core story).
* **rlc** — `RlcEngine.verify_batch`: ONE random-linear-combination
  check per batch with certification cache, randomized torsion rounds,
  and bisection fallback — the cost INCLUDES the bisections the
  injected failure rate forces, so the grid shows exactly where
  amortization stops paying (the router's min_batch/budget evidence).

Every run merges a labeled row set into ``BENCH_AGGREGATE.json`` under
``--bank-dir`` (by default the package's git-ignored ``build/bench``),
each row carrying ``captured_at`` and the ``card`` stamp (the card's name
and power limit, or ``"cpu"`` with ``--device cpu``) where the
reference's carried ``tunnel_live_at_write``; ``--bank-e2e`` adds the
headline crypto-floor row to ``BENCH_E2E.json`` there.

``--cert-route`` is BASELINE config 4's measurement, the n = 64 quorum
certificate, as a device arm of the port, in process: the verify kernel
per signature (``ops.ed25519.verify_batch``) against the one-equation
aggregate on the RLC kernels (``ops.aggregate.aggregate_verify``), both
on ``cuda:0`` unless ``--device cpu`` runs their plain versions. Each
route reports its whole-call ms (host clock, as the reference's did)
and its kernels' ms on rows already on the card (CUDA events), and the
verdicts of a clean and a tampered certificate (with the aggregate's
``eq_ok``). Without a card and without ``--device cpu`` the tool raises.

Usage:
    python -m at2_node_tpu_torch.tools.aggregate_bench
        [--batches 64,256,1024] [--rates 0,0.004,0.05,0.5] [--rounds 3]
        [--device cuda|cpu] [--bank-dir DIR] [--bank-e2e] [--label L]
    python -m at2_node_tpu_torch.tools.aggregate_bench --cert-route [--n 64] ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ._common import OUT_DIR

N = 64
ROUNDS = 20


def _cert_items(n: int):
    """The reference's certificate: n deterministic keys, one attestation
    each, and fixed RLC coefficients."""
    from ..crypto.keys import SignKeyPair

    keys = [SignKeyPair.from_hex(("%02x" % (i + 1)) * 32) for i in range(n)]
    msgs = [b"attestation %d" % i for i in range(n)]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    pks = [k.public for k in keys]
    z = [(2 * i + 3) | 1 for i in range(n)]
    return pks, msgs, sigs, z


def _tampered(sigs: list) -> list:
    """The certificate with one signature's S altered (lane n // 2)."""
    j = len(sigs) // 2
    bad = list(sigs)
    bad[j] = sigs[j][:40] + bytes([sigs[j][40] ^ 2]) + sigs[j][41:]
    return bad


def _host_ms(fn, rounds: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(rounds):
        fn()
    return 1e3 * (time.perf_counter() - t0) / rounds


def _device_ms(dev, fn, rounds: int) -> float:
    """ms a call of ``fn`` takes on the card (CUDA events around
    ``rounds`` back-to-back calls on rows already there); the host clock
    on the CPU."""
    from ._common import device_seconds

    fn()
    return 1e3 * device_seconds(dev, lambda: [fn() for _ in range(rounds)]) / rounds


def cert_route(n: int, rounds: int, device: str = "cuda") -> dict:
    """Both routes of the n-signature certificate on ``device``; see the
    module docstring."""
    import contextlib

    import numpy as np
    import torch

    from ..ops import aggregate as agg
    from ..ops import cuda_rlc, cuda_verify
    from ..ops import ed25519 as v
    from ._common import card_stamp, tool_device

    dev = tool_device(device)
    pks, msgs, sigs, z = _cert_items(n)
    certs = {"clean": sigs, "tampered": _tampered(sigs)}
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        per_sig = {name: v.verify_batch(pks, msgs, s, batch_size=64, device=dev)
                   for name, s in certs.items()}
        aggregate, eq_ok = {}, {}
        for name, s in certs.items():
            aggregate[name] = agg.aggregate_verify(pks, msgs, s, _z_override=z, device=dev)
            rows = agg.rlc_prep(pks, msgs, s, _z_override=z)
            eq_ok[name] = agg._run(rows, dev, n)[0]
        ps_ms = _host_ms(lambda: v.verify_batch(pks, msgs, sigs, batch_size=64, device=dev),
                         rounds)
        ag_ms = _host_ms(lambda: agg.aggregate_verify(pks, msgs, sigs, _z_override=z, device=dev),
                         rounds)
        pool = v.StagingPool(pinned=dev.type == "cuda")
        packed = v.upload_packed(v.prep_packed(pks, msgs, sigs, 64, pool), dev).rows
        rlc_rows = agg.rlc_upload(agg.rlc_prep(pks, msgs, sigs, _z_override=z), dev).rows
        ps_dev = _device_ms(dev, lambda: cuda_verify.verify_packed(packed), rounds)
        ag_dev = _device_ms(dev, lambda: cuda_rlc.rlc_packed(rlc_rows), rounds)
    card = card_stamp(dev)
    return {
        "per_sig_kernel": {
            "ms": round(ps_ms, 3),
            "device_ms": round(ps_dev, 4),
            "device": dev.type,
            "verdicts": {k: np.asarray(x).tolist() for k, x in per_sig.items()},
            "card": card,
        },
        "rlc_aggregate": {
            "ms": round(ag_ms, 3),
            "device_ms": round(ag_dev, 4),
            "device": dev.type,
            "verdicts": aggregate,
            "eq_ok": eq_ok,
            "card": card,
        },
    }


def cert_route_main(args) -> int:
    from ._common import host_context

    routes = cert_route(args.n, args.rounds, args.device)
    per_sig, aggregate = routes["per_sig_kernel"], routes["rlc_aggregate"]
    ps_ms = per_sig.get("ms")
    ag_ms = aggregate.get("ms")
    if ps_ms is not None and (ag_ms is None or ps_ms <= ag_ms):
        winner = "per_sig_kernel"
    elif ag_ms is not None:
        winner = "rlc_aggregate"
    else:
        winner = "inconclusive"
    artifact = {
        "config": "BASELINE-4: n=64 quorum-certificate aggregate verify",
        "host_context": host_context(),
        "n": args.n,
        "per_sig_kernel": per_sig,
        "rlc_aggregate": aggregate,
        "winner": winner,
        "notes": (
            "Both routes run in process on the same device: the verify "
            "kernel once per signature, against the RLC kernels' one "
            "equation with the subgroup checks ([L]R, [L]A over the n "
            "lanes) inside it. ms is the whole call on the host clock; "
            "device_ms the kernels alone on rows already on the card."
        ),
        "routing": (
            "verify_certificate routes certificates through the per-sig "
            "kernel on the card; the RLC aggregate (with subgroup defense) "
            "remains the host's screening path with per-sig fallback"
            if winner == "per_sig_kernel"
            else "RLC aggregate should become the card's fast path"
        ),
        "card": per_sig["card"],
    }
    out_line = json.dumps(artifact)
    print(out_line)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(out_line + "\n")
    return 0


# --------------------------------------------------------------------------
# default mode: the CPU engine's (batch x failure-rate) grid
# --------------------------------------------------------------------------

BANK_PATH = os.path.join(OUT_DIR, "BENCH_AGGREGATE.json")


def _grid_batch(pool, n, n_bad, tag):
    """One measurement batch: ``n`` lanes over the deterministic key
    pool, ``n_bad`` evenly-spread lanes with a flipped s byte (exactly
    the salting adversary's cheapest shape — sim/hostile.py)."""
    items = []
    for i in range(n):
        kp = pool[i]
        msg = b"%s lane %d" % (tag, i)
        items.append((kp.public, msg, kp.sign(msg)))
    bad = set()
    if n_bad > 0:
        step = n / n_bad
        bad = {min(n - 1, int(i * step)) for i in range(n_bad)}
        for j in bad:
            pk, msg, sig = items[j]
            items[j] = (pk, msg, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:])
    return items, bad


def _rate(fn, items, rounds):
    """sigs/s over ``rounds`` timed runs (one untimed warm run first)."""
    fn(items)
    t0 = time.perf_counter()
    for _ in range(rounds):
        out = fn(items)
    dt = (time.perf_counter() - t0) / rounds
    return round(len(items) / dt, 1), out


def grid_main(args) -> int:
    import hashlib

    from ..crypto.keys import SignKeyPair, verify_one
    from ..crypto.verifier import RlcEngine
    from ..native.ingest import ingest_available, verify_bulk_native
    from ..native.rlc import rlc_available
    from ._common import card_stamp, host_context, tool_device

    card = card_stamp(tool_device(args.device))

    if not (ingest_available() and rlc_available()):
        print("native ingest/rlc libraries unavailable; grid needs both",
              file=sys.stderr)
        return 1

    batches = [int(b) for b in args.batches.split(",")]
    rates = [float(r) for r in args.rates.split(",")]
    captured_at = time.strftime("%Y-%m-%d", time.gmtime())
    row_labels = {"captured_at": captured_at, "card": card}

    pool = [
        SignKeyPair.from_hex(
            hashlib.sha256(b"aggregate-grid key %d" % i).hexdigest()
        )
        for i in range(max(batches))
    ]
    # ONE engine across the whole grid: the certification cache warm
    # after the first cell is the steady state a node actually runs in
    # (cert_misses stays == pool size for the entire run)
    engine = RlcEngine()

    grid = []
    for n in batches:
        for rate in rates:
            n_bad = round(rate * n)
            items, bad = _grid_batch(pool, n, n_bad, b"r%d" % int(rate * 1e4))
            expected = [i not in bad for i in range(n)]
            checks0 = engine.stats()["rlc_checks"]
            rlc_rate, out = _rate(engine.verify_batch, items, args.rounds)
            assert out == expected, "rlc verdicts diverged from ground truth"
            native_rate, nout = _rate(
                lambda it: verify_bulk_native(it, 1), items, args.rounds
            )
            assert list(nout) == expected
            cell = {
                "batch": n,
                "failure_rate": rate,
                "bad_lanes": n_bad,
                "rlc_sigs_per_sec": rlc_rate,
                "per_sig_native_sigs_per_sec": native_rate,
                "rlc_speedup": round(rlc_rate / native_rate, 2),
                "rlc_checks_per_batch": round(
                    (engine.stats()["rlc_checks"] - checks0)
                    / (args.rounds + 1), 1
                ),
                **row_labels,
            }
            grid.append(cell)
            if not args.quiet:
                print(json.dumps(cell), flush=True)

    # the crypto floor: per-call OpenSSL, ONE timed round (it is ~10x
    # slower than everything else in the grid and perfectly stable)
    floor_n = max(batches)
    items, _ = _grid_batch(pool, floor_n, 0, b"floor")
    t0 = time.perf_counter()
    assert all(verify_one(pk, m, s) for pk, m, s in items)
    floor_rate = round(floor_n / (time.perf_counter() - t0), 1)

    head = next(
        c for c in grid
        if c["batch"] == floor_n and c["failure_rate"] == 0.0
    )
    # largest failure rate at the biggest batch where amortization still
    # beats the native per-sig path: the router budget's evidence
    tolerated = [
        c["failure_rate"] for c in grid
        if c["batch"] == floor_n and c["rlc_speedup"] >= 1.0
    ]
    summary = {
        "bucket": floor_n,
        "per_sig_python_sigs_per_sec": floor_rate,
        "per_sig_native_1thread_sigs_per_sec":
            head["per_sig_native_sigs_per_sec"],
        "rlc_sigs_per_sec": head["rlc_sigs_per_sec"],
        "rlc_vs_crypto_floor": round(head["rlc_sigs_per_sec"] / floor_rate, 2),
        "rlc_vs_native_per_sig": head["rlc_speedup"],
        "max_tolerated_failure_rate": max(tolerated) if tolerated else 0.0,
        "target": ">=5x the per-sig crypto floor at bucket %d, one core"
                  % floor_n,
        "target_met": bool(head["rlc_sigs_per_sec"] >= 5 * floor_rate),
        **row_labels,
    }
    print(json.dumps(summary), flush=True)

    label = args.label or "grid_%s" % captured_at
    bank_path = os.path.join(args.bank_dir, os.path.basename(BANK_PATH))
    os.makedirs(args.bank_dir, exist_ok=True)
    doc = {}
    if os.path.exists(bank_path):
        with open(bank_path) as fp:
            doc = json.load(fp)
    doc.setdefault(
        "config",
        "CPU amortized-verification grid: RLC engine vs per-sig routes "
        "(batch x failure rate), all rates sigs/s on one core",
    )
    doc["host_context"] = host_context()
    doc.setdefault("runs", {})[label] = {
        **row_labels,
        "rounds": args.rounds,
        "grid": grid,
        "summary": summary,
    }
    doc["latest"] = label
    tmp = bank_path + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(doc, fp, indent=1)
        fp.write("\n")
    os.replace(tmp, bank_path)
    print("banked %s run %s" % (bank_path, label), file=sys.stderr)

    if args.bank_e2e:
        from .e2e_bench import _bank_e2e_row

        _bank_e2e_row(args.bank_dir, "crypto_floor_rlc", {
            **summary,
            "note": (
                "same-day A/B: all three routes measured in one process "
                "run on this host (see BENCH_AGGREGATE.json run %s for "
                "the full grid). This is the Verifier-seam crypto floor: "
                "CpuVerifier mode=auto routes qualifying flushes through "
                "the RLC engine at exactly these rates" % label
            ),
        })
        print("banked BENCH_E2E.json row crypto_floor_rlc", file=sys.stderr)
    return 0 if summary["target_met"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cert-route", action="store_true",
                    help="BASELINE-4 certificate-route measurement: the "
                    "verify kernel against the RLC kernels' one equation")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (cuda:0; the default, raising without a card) "
                    "or cpu (the plain versions on the host)")
    # cert-route knobs
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--rounds", type=int, default=None,
                    help="timed rounds per cell (grid default 3, "
                    "cert-route default %d)" % ROUNDS)
    ap.add_argument("--out", default=None)
    # grid knobs
    ap.add_argument("--batches", default="64,256,1024",
                    help="comma-separated batch sizes (default 64,256,1024)")
    ap.add_argument("--rates", default="0,0.004,0.05,0.5",
                    help="comma-separated failure rates (default "
                    "0,0.004,0.05,0.5 — clean / one-bad-ish / salted / "
                    "hostile-majority)")
    ap.add_argument("--bank-dir", default=OUT_DIR,
                    help="directory of BENCH_AGGREGATE.json (and, with "
                    "--bank-e2e, BENCH_E2E.json); default %(default)s")
    ap.add_argument("--bank-e2e", action="store_true",
                    help="also bank the headline crypto-floor row into "
                    "BENCH_E2E.json")
    ap.add_argument("--label", default=None,
                    help="run label in BENCH_AGGREGATE.json "
                    "(default grid_<utc-date>)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    if args.cert_route:
        args.rounds = ROUNDS if args.rounds is None else args.rounds
        return cert_route_main(args)
    args.rounds = 3 if args.rounds is None else args.rounds
    return grid_main(args)


if __name__ == "__main__":
    sys.exit(main())
