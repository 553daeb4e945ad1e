"""One run of a replay cell: ``verify_many`` of the port's verifier
driven from a seeded trace of signed transfers, in this process.

The trace (the configuration's ``trace_transfers`` distinct entries,
about ``tamper_share`` of them tampered) is signed at set-up in
``sign_workers`` spawned processes. ``callers`` asyncio tasks each keep
``in_flight`` calls of ``chunk`` signatures open, the chunks taken in
turn around the trace. ``verified_sigs_per_s`` counts the signatures of
every call that returned inside the window. A traced run records the
whole run with ``torch.profiler`` (started before the warm-up traffic)
and clips it to the window.

What is compared (every limit is 0):

* ``calls_failed``: calls that raised or returned a verdict list of
  another length;
* ``label_mismatches``: verdicts of every call against the verdict each
  entry was built to have;
* ``sample_mismatches``: a seeded sample of entries, every class in it,
  each verified by the plain RFC 8032 reference, against every verdict
  the program gave that entry.
"""

from __future__ import annotations

import asyncio
import gc
import multiprocessing
import os
import random
import tempfile
import time
from typing import Dict, List

import numpy as np

from benchmark.harness import chrome, workload
from benchmark.harness.window import Window
from benchmark.reference import ed25519 as ref_ed25519

LIMITS = {"calls_failed": 0, "label_mismatches": 0, "sample_mismatches": 0}


def make_trace(config: dict, traffic: dict, seed: int):
    """(items, labels, classes) of the whole trace, signed side by side."""
    n, workers = config["trace_transfers"], traffic["sign_workers"]
    step = -(-n // workers)
    jobs = [(seed, config["trace_senders"], lo, min(n, lo + step), traffic["tamper_share"],
             tuple(traffic["tamper_classes"])) for lo in range(0, n, step)]
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        parts = pool.map(workload.replay_block, jobs)
    entries = [e for part in parts for e in part]
    items = [(pk, msg, sig) for pk, msg, sig, _, _ in entries]
    labels = np.array([ok for *_, ok in entries], dtype=bool)
    classes = [cls for _, _, _, cls, _ in entries]
    return items, labels, classes


def sample(classes: List, seed: int, size: int, per_class: int) -> List[int]:
    """Seeded trace indices: up to ``per_class`` of every tamper class,
    the rest valid entries."""
    rng = random.Random(f"replay-sample/{seed}")
    by: Dict = {}
    for i, c in enumerate(classes):
        by.setdefault(c, []).append(i)
    out = []
    for c in sorted(k for k in by if k is not None):
        out += rng.sample(by[c], min(per_class, len(by[c])))
    valid = by.get(None, [])
    out += rng.sample(valid, min(len(valid), max(0, size - len(out))))
    return sorted(out)


class Callers:
    """``callers`` tasks, each with ``in_flight`` chunks in flight; call j
    covers trace entries [j * chunk, (j + 1) * chunk) around the trace."""

    def __init__(self, verifier, items, chunk: int, callers: int, in_flight: int) -> None:
        if len(items) % chunk:
            raise ValueError("the trace must hold a whole number of chunks")
        self.verifier, self.items, self.chunk = verifier, items, chunk
        self.n_chunks = len(items) // chunk
        self.callers, self.in_flight = callers, in_flight
        self.next = 0
        self.records: List[tuple] = []  # (t_send, t_done, n, call index, verdicts or None)
        self.stop = False

    async def _call(self, j: int) -> None:
        lo = (j % self.n_chunks) * self.chunk
        t0 = time.time()
        try:
            out = await self.verifier.verify_many(self.items[lo:lo + self.chunk])
            verdicts = np.asarray(out, dtype=bool) if len(out) == self.chunk else None
        except Exception:  # a failed call is recorded and judged
            verdicts = None
        self.records.append((t0, time.time(), self.chunk, j, verdicts))

    async def _caller(self) -> None:
        pending: set = set()
        while not self.stop:
            while len(pending) < self.in_flight and not self.stop:
                pending.add(asyncio.ensure_future(self._call(self.next)))
                self.next += 1
            _, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
        if pending:
            await asyncio.wait(pending)

    def start(self) -> list:
        return [asyncio.ensure_future(self._caller()) for _ in range(self.callers)]


def _start_profiler():
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def run(cell, seed: int, seconds: float, traced: bool, t_start: float, env: dict, card: str,
        memory, make_verifier=None, build=None) -> dict:
    config, traffic = cell.config, cell.traffic
    vcfg = dict(config["verifier"])
    if build is not None:
        build(vcfg["kind"])
    items, labels, classes = make_trace(config, traffic, seed)
    # the trace is the harness's input, resident for the whole run: keep
    # it out of the collections the program's own garbage triggers
    gc.collect()
    gc.freeze()
    workdir = tempfile.mkdtemp(prefix="at2-bench-")
    if make_verifier is None:
        from at2_node_tpu_torch.crypto.verifier import make_verifier as program_verifier

        def make_verifier(v):
            kind = v.pop("kind")
            return program_verifier(kind, **v)

    async def go():
        verifier = make_verifier(dict(vcfg))
        await verifier.warmup()
        prof = _start_profiler() if traced else None
        callers = Callers(verifier, items, traffic["chunk"], traffic["callers"], traffic["in_flight"])
        tasks = callers.start()
        await asyncio.sleep(traffic["warmup_s"])
        hist = getattr(verifier, "stage_histograms", None)
        t_open, s_open, h_open = time.time(), verifier.stats(), hist() if hist else None
        await asyncio.sleep(max(0.0, t_open + seconds - time.time()))
        t_close, s_close, h_close = time.time(), verifier.stats(), hist() if hist else None
        callers.stop = True
        await asyncio.gather(*tasks)
        trace_path = None
        if prof is not None:
            prof.stop()
            trace_path = os.path.join(workdir, "replay.trace.json")
            prof.export_chrome_trace(trace_path)
        peak = memory()
        await verifier.close()
        return dict(t_open=t_open, t_close=t_close, counters=[(s_open, s_close)],
                    stages=(h_open, h_close) if h_open else None, records=callers.records,
                    trace_path=trace_path, memory_peak_bytes=peak)

    d = asyncio.run(go())
    gc.unfreeze()
    window = Window(d["t_open"], d["t_close"], card,
                    calls=[(t0, t1, n, j, v is not None) for t0, t1, n, j, v in d["records"]],
                    counters=d["counters"], stages=d["stages"])
    if d["trace_path"]:
        window.device = chrome.DeviceWindow.from_events(chrome.load(d["trace_path"]), d["t_open"], d["t_close"])
    # judgement
    chunk, n = traffic["chunk"], len(items)
    n_chunks = n // chunk
    calls_failed = sum(1 for r in d["records"] if r[4] is None)
    label_mismatches = 0
    seen: Dict[int, List[bool]] = {}
    picked = sample(classes, seed, traffic["sample"], traffic["sample_per_class"])
    picked_set = set(picked)
    for _, _, _, j, verdicts in d["records"]:
        if verdicts is None:
            continue
        lo = (j % n_chunks) * chunk
        label_mismatches += int(np.count_nonzero(verdicts != labels[lo:lo + chunk]))
        for i in picked_set.intersection(range(lo, lo + chunk)):
            seen.setdefault(i, []).append(bool(verdicts[i - lo]))
    sample_mismatches = 0
    for i in picked:
        expect = ref_ed25519.verify(*items[i])
        sample_mismatches += sum(v != expect for v in seen.get(i, ()))
    inside = [r for r in d["records"] if d["t_open"] <= r[0] < d["t_close"]]
    verified = sum(r[2] for r in d["records"] if d["t_open"] <= r[1] < d["t_close"] and r[4] is not None)
    return {
        "window": window, "setup_s": d["t_open"] - t_start, "memory_peak_bytes": d["memory_peak_bytes"],
        "attempted": sum(r[2] for r in inside), "failed": sum(r[2] for r in inside if r[4] is None),
        "rates": {"verified_sigs_per_s": verified / window.seconds},
        "checks": {k: (v, LIMITS[k]) for k, v in (("calls_failed", calls_failed),
                                                  ("label_mismatches", label_mismatches),
                                                  ("sample_mismatches", sample_mismatches))},
        "notes": [f"trace: {n} entries, {int((~labels).sum())} expected invalid",
                  f"calls: {len(d['records'])}, sampled entries judged: {len(seen)}",
                  f"calls completed in the window: {sum(1 for r in d['records'] if d['t_open'] <= r[1] < d['t_close'])}"],
        "workdir": workdir,
    }
