"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``at2_node_tpu_torch``)
and ``BENCHMARK.json``. The cell's configuration, traffic mix and metric
readers are found by name (``benchmark/harness/manifest.py``). The run
needs the CUDA card(s) the cell asks for and exits 3 without them; it
exits 2 in a checkout without the program, and 4, printing no result,
if the harness, a node or a generator process loaded ``jax``,
``jaxlib``, ``flax`` or the JAX package (``harness/guard.py``). Its last
line on standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, every compared number with its limit; the same numbers end
standard error.

The program builds its libraries into ``at2_node_tpu_torch/build/``
inside the checkout (only a first run compiles); any other cache a
library could keep is pointed into ``.bench_cache/`` there.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time

T_START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import guard  # noqa: E402

PROGRAM = "at2_node_tpu_torch"


def checkout_env() -> dict:
    """The environment of every process of the run: the checkout first on
    the path, caches at fixed places inside the checkout, no flax."""
    cache = os.path.join(ROOT, ".bench_cache")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    env["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    env["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    env["USE_FLAX"] = "0"
    return env


class MemorySampler:
    """The card's memory in use, sampled by nvidia-smi every 250 ms; the
    peak over the fullest card (every process on it counts)."""

    def __init__(self) -> None:
        self.peak_mib = 0
        self.proc = None
        if shutil.which("nvidia-smi") is None:
            return
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits", "-lms", "250"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                self.peak_mib = max(self.peak_mib, int(line.strip()))
            except ValueError:
                continue

    def peak_bytes(self) -> int:
        peak = self.peak_mib * 1024 * 1024
        if "torch" in sys.modules:
            import torch

            if torch.cuda.is_available() and torch.cuda.is_initialized():
                peak = max(peak, torch.cuda.max_memory_allocated())
        return peak

    def close(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait()
            self.thread.join(timeout=5)


def build_program(kind: str) -> None:
    """Build (unless fresh) the libraries a node of this verifier kind
    loads: the kernel for the card's kinds, the host prep and the ingest."""
    from at2_node_tpu_torch.native import ingest, prep

    if kind in ("cuda", "pool"):
        from at2_node_tpu_torch.ops import cuda_verify

        cuda_verify.build()
    if not prep.native_available():
        raise RuntimeError("the port's native host prep did not build")
    if not ingest.ingest_available():
        raise RuntimeError("the port's native ingest did not build")


def card_info(chips: int) -> dict:
    """The card's name; raises SystemExit(3) without the cards the cell
    asks for."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        raise SystemExit(3)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, require_card: bool = True,
             card: str | None = None, overrides: dict | None = None, server_target=None, make_verifier=None,
             build=build_program, bench: dict | None = None) -> dict:
    """One run of cell ``name``; the result line as a dict. ``overrides``
    updates the cell's configuration (key ``config``) and traffic (key
    ``traffic``); ``server_target`` (the module or script a node runs,
    with its arguments), ``make_verifier`` and ``build`` put another
    program in the port's place; ``bench`` replaces
    BENCHMARK.json's contents. Tests use these; a run from the command
    line uses none of them."""
    from benchmark.harness import manifest, netrun, replay

    cell = manifest.cell(bench or manifest.load_manifest(ROOT), name, ROOT)
    for part in ("config", "traffic"):
        getattr(cell, part).update((overrides or {}).get(part, {}))
    device = card_info(cell.chips) if require_card else {"platform": "cpu", "kind": card or "cpu",
                                                        "count": cell.chips}
    env = checkout_env()
    os.environ.update({k: env[k] for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
                                           "USE_FLAX")})
    memory = MemorySampler()
    card_name = card or device["kind"]
    try:
        if cell.traffic["entry"] == "grpc":
            out = netrun.run(cell, seed, seconds, trace, T_START, env, card_name, memory.peak_bytes,
                             server_target=server_target, build=build)
        elif cell.traffic["entry"] == "verify_many":
            out = replay.run(cell, seed, seconds, trace, T_START, env, card_name, memory.peak_bytes,
                             make_verifier=make_verifier, build=build)
        else:
            raise ValueError(f"unknown traffic entry {cell.traffic['entry']!r}")
    finally:
        memory.close()
    w = out["window"]
    metrics = {}
    if trace:
        metrics = manifest.read_metrics(cell.per_layer, w)
    else:
        for m in cell.end_to_end:
            value = out["setup_s"] if m["name"] == "setup_s" else out["rates"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    result = {"correct": all(v <= lim for v, lim in out["checks"].values()),
              "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": device}
    if trace and w.device is not None:
        device["busy_s"] = w.device.busy_s()
        device["window_s"] = w.seconds
        result["breakdown"] = {"device_ops": w.device.top_ops(), "idle_gaps": w.device.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    result["notes"] = out["notes"]
    result["loaded_forbidden"] = out.get("loaded_forbidden", [])
    shutil.rmtree(out["workdir"], ignore_errors=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        print(f"benchmark: no {PROGRAM}/ in {ROOT}: nothing to measure", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    notes = result.pop("notes")
    found = result.pop("loaded_forbidden")
    if guard.forbidden(sys.modules):
        found.append(f"the harness: {', '.join(guard.forbidden(sys.modules))}")
    if found:
        print(f"benchmark: the run loaded what it may not: {'; '.join(found)}", file=sys.stderr)
        return 4
    for note in notes:
        print(f"note: {note}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
