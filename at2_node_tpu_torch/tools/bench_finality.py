"""Finality-certificate benchmark: production lag, verify rate, bytes.

Counterpart of ``at2_node_tpu/tools/bench_finality.py``.

The finality acceptance numbers, measured end to end:

* **certificate production lag** — a simulated fleet with ``[finality]``
  enabled runs serialized honest transfers; for every certificate any
  node assembles, the lag is the VIRTUAL time between the moment some
  node's commit frontier first reached the certificate's ``commits``
  coordinate and the moment the certificate existed. p50/p99 over the
  episode — this is "how far behind the commit frontier does external
  finality trail", the number an operator alerts on (tools/top.py
  ``--cert-lag-deadline``).
* **light-client verify rate** — wall-clock verifies/sec of
  ``finality.LightVerifier`` over a real assembled certificate, in both
  modes: *subset* (the wallet case: f+1 known keys) and *full* (the CI
  gate case: complete member list, every bitmap bit checked). Pure
  ed25519 arithmetic; this is the stateless-client budget.
* **wire bytes** — the exact on-wire sizes: one kind-16 co-signature
  frame and one assembled certificate for the benched fleet size.

The sim half is (seed, config)-deterministic; the verify half is a
wall-clock microbench and inherently noisy — regress.py banks it with
its usual tolerance.

Usage:
    python -m at2_node_tpu_torch.tools.bench_finality [--nodes 4] [--txs 48]
        [--audit-every 8] [--verify-iters 200] [--seed 7]
        [--out PATH]

The document goes to stdout as one JSON line, and also to ``--out`` when
that is given (the JAX package's tool writes BENCH_FINALITY.json by
default; this one never overwrites that banked file unasked).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

from ..broadcast.messages import CERT_SIG_WIRE
from ..crypto.keys import SignKeyPair
from ..finality import CertAssembler, LightVerifier
from ..finality.light import default_threshold
from ..node.config import FinalityConfig, ObservabilityConfig


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(q * (len(ordered) - 1) + 0.5))
    return ordered[idx]


def bench_production(
    *, nodes: int, txs: int, audit_every: int, seed: int
) -> dict:
    """Virtual-time certificate lag behind the commit frontier."""
    from ..sim.net import SimNet, sim_client

    net = SimNet(
        nodes,
        (nodes - 1) // 3,
        seed,
        finality=FinalityConfig(enabled=True),
        observability=ObservabilityConfig(audit_every=audit_every),
    ).start()
    try:
        loop = net.loop
        client = sim_client(seed, 0)
        recipient = sim_client(seed, 1).public
        # frontier_t[c]: first virtual time ANY node's commit frontier
        # reached c; chain length watermark per node for new-cert detection
        frontier_t: Dict[int, float] = {}
        chain_seen = [0] * nodes
        lags: List[float] = []

        def sample():
            now = loop.time()
            for i, svc in enumerate(net.services):
                frontier_t.setdefault(svc.auditor.commits, now)
                chain = svc.certs.chain
                for cert in chain[chain_seen[i]:]:
                    born = min(
                        (t for c, t in frontier_t.items()
                         if c >= cert.commits),
                        default=now,
                    )
                    lags.append(now - born)
                chain_seen[i] = len(chain)
            loop.call_later(0.05, sample)

        sample()
        for k in range(txs):
            loop.call_later(
                0.2 + 0.2 * k,
                lambda k=k: net.fabric._tasks.add(
                    loop.create_task(
                        net.asubmit(k % nodes, client, k + 1, recipient, 1)
                    )
                ),
            )
        net.run_for(0.2 * txs + 1.0)
        net.settle(horizon=60.0)
        for i, svc in enumerate(net.services):
            svc._emit_beacon()
        net.settle(horizon=10.0)
        sample()  # pick up quiescence certificates
        assembled = sum(s.certs.counters["assembled"] for s in net.services)
        return {
            "certificates": assembled,
            "lag_samples": len(lags),
            "lag_p50_s": round(_percentile(lags, 0.50), 4),
            "lag_p99_s": round(_percentile(lags, 0.99), 4),
            "frontier": max(s.auditor.commits for s in net.services),
            "certified": max(
                (s.certs.latest.commits for s in net.services
                 if s.certs.latest),
                default=0,
            ),
            "violations": net.check_invariants(),
        }
    finally:
        net.close()


def bench_verify(*, nodes: int, iters: int, seed: int) -> tuple:
    """Wall-clock light-client verify rate over a real assembled
    certificate. Returns ``(measurements, certificate)`` — the
    certificate also feeds the wire-bytes number."""
    import random

    rng = random.Random(seed)
    kps = [
        SignKeyPair(bytes(rng.getrandbits(8) for _ in range(32)))
        for _ in range(nodes)
    ]
    asm = CertAssembler([kp.public for kp in kps])
    wm = bytes(rng.getrandbits(8) for _ in range(16))
    ranges = bytes(rng.getrandbits(8) for _ in range(128))
    dird = bytes(rng.getrandbits(8) for _ in range(8))
    from ..broadcast.messages import CertSig

    cert = None
    for i, kp in enumerate(kps):
        got = asm.add(CertSig.create(kp, 0, 100 + i, wm, ranges, dird))
        cert = got or cert
    assert cert is not None, "quorum never reached in verify bench"

    subset = LightVerifier(
        [kp.public for kp in kps[: default_threshold(nodes)]], total=nodes
    )
    full = LightVerifier([], members=[kp.public for kp in kps])
    out = {"cert_signers": cert.signer_count()}
    for label, verifier in (("subset", subset), ("full", full)):
        t0 = time.perf_counter()
        for _ in range(iters):
            assert verifier.verify(cert)["ok"]
        dt = time.perf_counter() - t0
        out[f"{label}_per_s"] = round(iters / dt, 1) if dt > 0 else 0.0
        out[f"{label}_ms"] = round(dt / iters * 1e3, 4)
    return out, cert


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--txs", type=int, default=48)
    ap.add_argument("--audit-every", type=int, default=8)
    ap.add_argument("--verify-iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None,
                    help="also write the document to PATH")
    args = ap.parse_args(argv)

    production = bench_production(
        nodes=args.nodes, txs=args.txs, audit_every=args.audit_every,
        seed=args.seed,
    )
    verify, cert = bench_verify(
        nodes=args.nodes, iters=args.verify_iters, seed=args.seed
    )
    doc = {
        "config": {
            "nodes": args.nodes,
            "txs": args.txs,
            "audit_every": args.audit_every,
            "verify_iters": args.verify_iters,
            "seed": args.seed,
        },
        "cosig_wire_bytes": CERT_SIG_WIRE,
        "cert_wire_bytes": len(cert.encode()),
        "production": production,
        "verify": verify,
        "ok": (
            production["certificates"] > 0
            and not production["violations"]
            and verify["subset_per_s"] > 0
        ),
    }
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(doc, fp, indent=1, sort_keys=True)
            fp.write("\n")
    print(json.dumps(doc, sort_keys=True))
    print(
        f"certificates={production['certificates']} "
        f"lag_p50={production['lag_p50_s']}s "
        f"lag_p99={production['lag_p99_s']}s "
        f"subset={verify['subset_per_s']}/s full={verify['full_per_s']}/s "
        f"cert={doc['cert_wire_bytes']}B cosig={CERT_SIG_WIRE}B"
        + (f" -> {args.out}" if args.out else ""),
        file=sys.stderr,
    )
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
