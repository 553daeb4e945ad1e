"""The port's release and gate surface: ``scripts/ci_torch.sh`` against
``scripts/ci.sh`` (the same gates in the same order, each on the port's
twin of the reference's test files and on modules that exist), the
``bin/torch/`` shims, the image's build step (``prebuild``, which never
falls back), the deploy unit's files, and ``chip_smoke.py`` phase 16 (the
runbook) with the host verifier."""

import importlib
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys

import pytest

import chip_smoke
from at2_node_tpu_torch import prebuild
from at2_node_tpu_torch.node.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CI = os.path.join(REPO, "scripts", "ci.sh")
CI_TORCH = os.path.join(REPO, "scripts", "ci_torch.sh")

# Each gate of scripts/ci.sh that names test files: the reference's targets
# and the port's twins that scripts/ci_torch.sh names under the same heading.
TWINS = {
    "pipeline smoke gate": (
        ["tests/test_pipeline.py"],
        ["tests/test_torch_verifier.py"],
    ),
    "metrics-endpoints smoke gate": (
        ["tests/test_obs.py"],
        ["tests/test_torch_obs.py"],
    ),
    "poison-slot chaos gate": (
        ["tests/test_faults.py::TestPoisonChaos", "tests/test_poison_resolution.py"],
        ["tests/test_torch_faults.py::TestPoisonChaos", "tests/test_torch_poison_resolution.py"],
    ),
    "broker roundtrip smoke gate": (
        ["tests/test_distill.py"],
        ["tests/test_torch_distill.py"],
    ),
    "amortized-verification gate": (
        ["tests/test_rlc_verify.py"],
        ["tests/test_torch_rlc.py",
         "tests/test_torch_verifier.py::test_rlc_flushes_give_exact_verdicts_and_count_fallbacks",
         "tests/test_torch_verifier.py::test_cancelled_verify_many_mid_rlc_releases_capacity",
         "tests/test_torch_verifier.py::test_auto_without_rlc_min_batch_never_routes_rlc",
         "tests/test_torch_verifier.py::test_rlc_warmup_checks_both_routes",
         "tests/test_torch_aggregate.py::test_rlc_verify_batch_and_aggregate_verify_match_the_reference",
         "tests/test_torch_aggregate.py::test_rlc_verify_batch_resolves_from_codes_without_the_exact_pass"],
    ),
    "sharded-plane gate": (
        ["tests/test_plane_shards.py"],
        ["tests/test_torch_plane_shards.py"],
    ),
    "finality gate": (
        ["tests/test_finality.py"],
        ["tests/test_torch_finality.py"],
    ),
}

# the release files that must neither import nor run the reference package
RELEASE_FILES = [
    "scripts/ci_torch.sh",
    "bin/torch/server",
    "bin/torch/client",
    "deploy/Dockerfile.torch",
    "deploy/docker-compose.torch.yml",
    "deploy/README_torch.md",
    ".github/workflows/ci_torch.yml",
    ".github/workflows/deploy_torch.yml",
    "at2_node_tpu_torch/prebuild.py",
]
FORBIDDEN = [
    re.compile(r"\bat2_node_tpu\b(?!_torch)"),  # the reference package, not at2_node_tpu_torch
    re.compile(r"\bjax\b", re.I),
]


def _read(rel: str) -> str:
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        return f.read()


def _gates(path: str) -> list:
    """[(heading, body without comment lines)] in the script's order."""
    text = open(path, encoding="utf-8").read()
    parts = re.split(r'^\s*echo "== (.+?) =="\s*$', text, flags=re.M)
    return [(parts[k], "\n".join(ln for ln in parts[k + 1].splitlines() if not ln.lstrip().startswith("#")))
            for k in range(1, len(parts), 2)]


def _targets(body: str) -> list:
    return re.findall(r"\btests/test_\w+\.py(?:::\w+)?", body)


def _shim_env() -> dict:
    # the shims exec `python`: this interpreter's directory first on PATH
    return dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"])


def test_gate_headings_equal_the_reference_in_order():
    ref, port = [h for h, _ in _gates(CI)], [h for h, _ in _gates(CI_TORCH)]
    assert len(ref) == 25 and port == ref


def test_ci_torch_is_executable_bash():
    assert os.access(CI_TORCH, os.X_OK)
    subprocess.run(["bash", "-n", CI_TORCH], check=True)


@pytest.mark.parametrize("rel", RELEASE_FILES)
def test_release_file_names_neither_jax_nor_the_reference_package(rel):
    text = _read(rel)
    hits = [m.group(0) for pat in FORBIDDEN for m in pat.finditer(text)]
    assert not hits, hits


@pytest.mark.parametrize("gate", sorted(TWINS))
def test_each_gate_runs_the_port_twins_of_the_reference_tests(gate):
    ref_body = dict(_gates(CI))[gate]
    port_body = dict(_gates(CI_TORCH))[gate]
    want_ref, want_port = TWINS[gate]
    assert _targets(ref_body) == want_ref
    assert _targets(port_body) == want_port


def test_no_other_gate_names_a_test_file():
    for gate, body in _gates(CI_TORCH):
        if gate not in TWINS:
            assert _targets(body) == [], gate


@pytest.mark.parametrize("target", sorted({t for _, port in TWINS.values() for t in port}))
def test_every_named_twin_exists(target):
    path, _, name = target.partition("::")
    text = _read(path)
    assert os.path.basename(path).startswith("test_torch_")
    if name:
        assert re.search(rf"^(class|def|async def) {name}\b", text, re.M), target


def _modules() -> list:
    return sorted(set(re.findall(r"python -m (at2_node_tpu_torch[\w.]*)", _read("scripts/ci_torch.sh"))))


def test_ci_torch_runs_every_tool_of_the_reference_on_the_port():
    ref = sorted(set(re.findall(r"python -m at2_node_tpu\.([\w.]+)", _read("scripts/ci.sh"))))
    assert [m.split(".", 1)[1] for m in _modules()] == ref


@pytest.mark.parametrize("module", _modules())
def test_every_module_the_gates_run_resolves(module):
    assert importlib.util.find_spec(module) is not None


def _imports() -> list:
    pairs = re.findall(r"^from (at2_node_tpu_torch[\w.]*) import ([\w, ]+)$", _read("scripts/ci_torch.sh"), re.M)
    return sorted({(mod, name.strip()) for mod, names in pairs for name in names.split(",")})


@pytest.mark.parametrize("module,name", _imports())
def test_every_name_the_heredocs_import_exists(module, name):
    assert hasattr(importlib.import_module(module), name)


def test_cpu_gates_ask_for_the_host_verifier():
    """The port defaults to the card: every gate that starts a real
    Service here says so (plane_bench's --verifier cpu, the capture's
    VerifierConfig(kind="cpu"))."""
    text = _read("scripts/ci_torch.sh")
    benches = re.findall(r"tools\.plane_bench([^\n]*)", text.replace("\\\n", " "))
    assert len(benches) == 5 and all("--verifier cpu" in b for b in benches)
    assert 'make_net_configs(3, port_counter(28400),\n                            verifier=VerifierConfig(kind="cpu"))' in text


def test_ci_torch_writes_its_scratch_files_under_a_directory_of_its_own():
    """Two checkouts gating at once never read each other's files: the
    script's scratch is one ``mktemp -d`` a run (under TMPDIR), and it
    names no fixed path under /tmp."""
    text = _read("scripts/ci_torch.sh")
    assert "/tmp/" not in text
    assert 'work="$(mktemp -d)"' in text and "trap 'rm -rf \"$work\"' EXIT" in text


def test_the_regression_sentry_reads_the_port_bank():
    """The sentry judges what the port's tools bank (their OUT_DIR), not
    the TPU's artifacts at the repo's root."""
    from at2_node_tpu_torch.tools._common import OUT_DIR

    body = dict(_gates(CI_TORCH))["bench-regression sentry gate"]
    bank = re.search(r"^bank=(\S+)$", body, re.M).group(1)
    assert os.path.join(REPO, bank) == OUT_DIR
    assert re.findall(r"tools\.regress --dir (\S+)", body) == ['"$bank"'] * 2


def test_ci_torch_refuses_an_unknown_tier():
    proc = subprocess.run([CI_TORCH, "nightly"], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2 and "usage" in proc.stderr


def test_gpu_tier_fails_without_a_card():
    proc = subprocess.run([CI_TORCH, "gpu"], capture_output=True, text=True, timeout=300, env=_shim_env())
    assert proc.returncode != 0
    assert "gpu tier FAILED" in proc.stderr and "CI gpu tier green" not in proc.stdout


def test_server_shim_writes_the_card_config_and_the_cpu_one_when_asked():
    shim = os.path.join(REPO, "bin", "torch", "server")
    cuda = subprocess.run([shim, "config", "new", "127.0.0.1:1", "127.0.0.1:2"], capture_output=True,
                          text=True, env=_shim_env(), timeout=60, check=True).stdout
    cpu = subprocess.run([shim, "config", "new", "--verifier", "cpu", "127.0.0.1:1", "127.0.0.1:2"],
                         capture_output=True, text=True, env=_shim_env(), timeout=60, check=True).stdout
    assert Config.loads(cuda).verifier.kind == "cuda" and Config.loads(cpu).verifier.kind == "cpu"
    assert Config.loads(cuda).rpc_address == "127.0.0.1:2"
    frag = subprocess.run([shim, "config", "get-node"], input=cuda, capture_output=True, text=True,
                          env=_shim_env(), timeout=60, check=True).stdout
    assert frag.startswith("[[nodes]]") and Config.loads(cuda).node_address in frag


def test_client_shim_makes_a_wallet():
    shim = os.path.join(REPO, "bin", "torch", "client")
    wallet = subprocess.run([shim, "config", "new", "http://127.0.0.1:2"], capture_output=True, text=True,
                            env=_shim_env(), timeout=60, check=True).stdout
    assert 'rpc_address = "http://127.0.0.1:2"' in wallet
    pub = subprocess.run([shim, "config", "get-public-key"], input=wallet, capture_output=True, text=True,
                         env=_shim_env(), timeout=60, check=True).stdout.strip()
    assert re.fullmatch(r"[0-9a-f]{64}", pub)


def test_server_run_with_the_card_config_exits_nonzero_without_a_card():
    shim = os.path.join(REPO, "bin", "torch", "server")
    a, b = chip_smoke.free_ports(2)
    cfg = subprocess.run([shim, "config", "new", f"127.0.0.1:{a}", f"127.0.0.1:{b}"], capture_output=True,
                         text=True, env=_shim_env(), timeout=60, check=True).stdout
    proc = subprocess.run([shim, "run"], input=cfg, capture_output=True, text=True, env=_shim_env(), timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_prebuild_without_nvcc_exits_naming_it():
    env = dict(os.environ, CUDA_HOME="/nonexistent", PATH=os.path.dirname(sys.executable) + ":/usr/bin:/bin")
    if prebuild.shutil.which("nvcc", path=env["PATH"]):
        pytest.fail("this test needs a PATH without nvcc")
    proc = subprocess.run([sys.executable, "-m", "at2_node_tpu_torch.prebuild"], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 2 and "nvcc" in proc.stderr


def test_prebuild_raises_when_a_kernel_does_not_build(monkeypatch):
    """No fallback: a kernel build that fails fails the build step."""
    from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify

    def no_nvcc():
        raise RuntimeError("nvcc not found (no such file)")

    monkeypatch.setattr(cuda_verify, "build", no_nvcc)
    monkeypatch.setattr(cuda_rlc, "build", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        prebuild.build_libs(log=lambda *a: None)
    monkeypatch.setattr(prebuild, "nvcc_path", lambda: None)
    assert prebuild.main() == 2


def test_parse_ptxas_reads_each_entry():
    log = ("ptxas info    : Compiling entry function 'ed25519_verify_kernel' for 'sm_90a'\n"
           "ptxas info    : Function properties for ed25519_verify_kernel\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n")
    assert prebuild.parse_ptxas(log, "ed25519_verify_kernel") == {
        "registers": 128, "stack_bytes": 0, "spill_bytes": 0, "spill_load_bytes": 0}
    with pytest.raises(RuntimeError, match="no ptxas report"):
        prebuild.parse_ptxas(log, "ed25519_rlc_fold")


def test_dockerfile_builds_and_runs_the_port():
    text = _read("deploy/Dockerfile.torch")
    assert re.search(r"^FROM nvidia/cuda:12\.8\.\d+-devel-ubuntu24\.04$", text, re.M)
    assert "download.pytorch.org/whl/cu128" in text
    assert re.search(r"^COPY at2_node_tpu_torch/ at2_node_tpu_torch/$", text, re.M)
    assert re.search(r"^COPY bin/torch/ bin/torch/$", text, re.M)
    assert not re.search(r"^COPY at2_node_tpu/", text, re.M)
    assert re.search(r"^RUN python -m at2_node_tpu_torch\.prebuild$", text, re.M)
    entry = re.search(r"^ENTRYPOINT (.+)$", text, re.M).group(1)
    assert json.loads(entry) == ["python", "-m", "at2_node_tpu_torch.cli.server"]


def test_compose_unit_runs_the_port_on_one_card():
    text = _read("deploy/docker-compose.torch.yml")
    assert chip_smoke.compose_entrypoint() == [
        "/bin/sh", "-c", "exec python -m at2_node_tpu_torch.cli.server run < /etc/at2/node.toml"]
    assert "stop_grace_period: 30s" in text and "at2-data:/data" in text
    assert re.search(r"- driver: nvidia\n\s+count: 1\n\s+capabilities: \[gpu\]", text)


def test_dockerignore_keeps_the_port_build_out():
    assert "at2_node_tpu_torch/build/" in _read(".dockerignore").splitlines()


def test_workflows_run_the_torch_gate_and_ship_the_torch_unit():
    ci = _read(".github/workflows/ci_torch.yml")
    assert "scripts/ci_torch.sh all" in ci and "scripts/ci_torch.sh gpu" in ci
    assert 'entry.dryrun_multichip(4, devices=["cpu"] * 4)' in ci
    from at2_node_tpu_torch import entry

    assert "devices" in inspect.signature(entry.dryrun_multichip).parameters
    deploy = _read(".github/workflows/deploy_torch.yml")
    assert "-f deploy/Dockerfile.torch" in deploy and "deploy/docker-compose.torch.yml" in deploy
    assert 'workflows: ["CI (torch port)"]' in deploy and "name: CI (torch port)" in ci
    assert "ref: ${{ github.event.workflow_run.head_sha }}" in deploy and "DEPLOY_KNOWN_HOSTS" in deploy


@pytest.mark.asyncio
async def test_chip_smoke_phase16_runs_the_runbook_with_the_cpu_kind(capsys):
    """Phase 16 with ``--verifier cpu`` configs: four units configured and
    started as the runbook says, traffic through the CLI and a seeded
    batch, the down (exit 0 within the grace period, checkpoints equal to
    the replay), the up (catchup -> live, balances read back through the
    client shim) and one more transfer."""
    out = await chip_smoke.deploy_path(9, "cpu", kind="cpu", n_clients=4, per_client=8, cli_sends=1)
    text = capsys.readouterr().out
    assert out["transfers"] == 4 * 8 + 2 + 1 and out["launches"] == 0
    for p in out["nodes"]:
        assert p["states"] == ["catchup", "live"]
        assert 0 < p["down_s"] < chip_smoke.DEPLOY_GRACE_S
        assert 0 < p["rpc_up_s"] <= p["live_s"] < chip_smoke.DEPLOY_LIVE_S
    assert "each checkpoint written at its stop and equal to the replay" in text
    assert "`bin/torch/client get-balance` read back" in text
    assert "one more `client send-asset` committed on all 4 nodes" in text
    assert 'entrypoint /bin/sh -c "exec python -m at2_node_tpu_torch.cli.server run < /etc/at2/node.toml"' in text
