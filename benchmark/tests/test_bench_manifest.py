"""BENCHMARK.json against the rules of its format (names, units, bounds, cells), every
name resolved to its file, a cell added as files and entries alone, and the import guard."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


PENDING = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark", "pending")))


@pytest.fixture(scope="module", params=["committed"] + PENDING + ["all pending"])
def bench(request):
    """BENCHMARK.json as committed, and with each pending cell's entries
    (``benchmark/pending/``) added as a later PR would add them."""
    out = manifest.load_manifest(ROOT)
    for name in PENDING:
        if request.param in (name, "all pending"):
            out = manifest.with_pending(out, name)
    return out


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_time_budget_fits_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in bench["configs"]:
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in bench["workloads"]:
        reported = [m for m in bench["end_to_end"] if manifest.applies(m, w["name"])]
        assert len(reported) >= 2, w["name"]
        assert any(manifest.applies(m, w["name"]) for m in bench["per_layer"]), w["name"]


def test_per_layer_metrics_move_a_metric_their_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert manifest.applies(e2e[m["moves"]], cell), (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(1 <= len(layer) <= 200 for layer in layers)


def test_roofline_and_share_units(bench):
    for m in bench["per_layer"]:
        if "_roofline" in m["name"] or m["name"].endswith("_pct") or "_pct." in m["name"]:
            assert m["unit"] == "%"


def test_names_resolve_to_files(bench):
    for c in bench["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("benchmark/") and os.path.isfile(path)
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert set(cfg["reduced"]) == set(c["reduced"])
        assert all(k in cfg for k in c["reduced"])
        assert cfg["source"] == c["source"] and "assumed" in cfg
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        cell = manifest.cell(bench, w["name"], ROOT)
        assert cell.traffic["entry"] in ("grpc", "verify_many")
        for m in cell.per_layer:
            assert callable(manifest.reader(m["name"]))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_chips(bench):
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert len(four) <= max(1, len(bench["workloads"]) // 4)


def test_a_cell_is_files_and_entries(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files with new entries, no existing file edited, resolve and read."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load_manifest(ROOT)
    with open(os.path.join(ROOT, "benchmark/configs/net4-f1.json")) as f:
        cfg = json.load(f)
    cfg.update(name="net4-f1-rlc", verifier={**cfg["verifier"], "mode": "rlc"})
    (tmp_path / "benchmark/configs/net4-f1-rlc.json").write_text(json.dumps(cfg))
    with open(manifest.traffic_path("unary16")) as f:
        traffic = json.load(f)
    (tmp_path / "benchmark/traffic/unary-deep.json").write_text(json.dumps({**traffic, "in_flight": 16}))
    (tmp_path / "benchmark/metrics/calls_per_s.net4.py").write_text(
        "def read(w):\n    return len(w.calls_sent_inside()) / w.seconds\n")
    bench["configs"].append({**bench["configs"][0], "name": "net4-f1-rlc", "file": "benchmark/configs/net4-f1-rlc.json"})
    bench["workloads"].append({"name": "net4-rlc", "config": "net4-f1-rlc", "traffic": "unary-deep", "chips": 1,
                               "why": "throwaway"})
    bench["per_layer"].append({"name": "calls_per_s.net4", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "RPC ingress", "moves": "committed_tx_per_s",
                               "workloads": ["net4-rlc"]})
    bench["end_to_end"][0]["workloads"].append("net4-rlc")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from benchmark.harness import manifest\n"
        "from benchmark.harness.window import Window\n"
        "m = manifest.load_manifest(sys.argv[1])\n"
        "c = manifest.cell(m, 'net4-rlc', sys.argv[1])\n"
        "assert c.config['verifier']['mode'] == 'rlc' and c.traffic['in_flight'] == 16\n"
        "assert manifest.__file__.startswith(sys.argv[1])\n"
        "w = Window(0.0, 2.0, 'x', calls=[(0.5, 0.6, 1, '', 0), (1.0, 1.1, 1, '', 0)])\n"
        "print(manifest.read_metrics(c.per_layer, w)['calls_per_s.net4']['value'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1.0"


IMPORT_GUARD = """
import sys
sys.path.insert(0, sys.argv[1])
from benchmark import run
from benchmark.harness import manifest, netrun, replay, netload, net, chrome, guard, wire, workload, yardstick
m = manifest.load_manifest(sys.argv[1])
for w in m['workloads']:
    cell = manifest.cell(m, w['name'], sys.argv[1])
    for metric in cell.per_layer:
        manifest.reader(metric['name'])
# what a run of each cell loads of the program
from at2_node_tpu_torch.crypto.verifier import make_verifier
from at2_node_tpu_torch.native import ingest, prep
from at2_node_tpu_torch.ops import cuda_verify
from at2_node_tpu_torch.parallel import pool
print(sorted({n.split('.')[0] for n in sys.modules}))
"""


def test_nothing_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORT_GUARD, ROOT], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "at2_node_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "at2_node_tpu"}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark.reference import ed25519, ledger\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"at2_node_tpu_torch", "at2_node_tpu", "jax", "torch", "numpy", "cryptography"}


def test_run_refuses_a_checkout_without_the_program(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "net4-unary", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_a_host_without_the_card():
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['benchmark/run.py', '--workload', 'net4-unary', '--seed', '4294967311', '--seconds', '1',"
            " '--trace', '0']\n"
            "runpy.run_path('benchmark/run.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 3 and out.stdout == ""
    assert "CUDA device" in out.stderr
