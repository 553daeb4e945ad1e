"""The port's CLIs end to end: real ``server`` / ``client`` processes of
``at2_node_tpu_torch``, TOML over stdin, output over stdout.

* The reference's CLI tests (config plumbing, a double bind, DNS names, a
  3-node net's transfer conservation and latest transactions, a client
  against a dead server) against ``python -m at2_node_tpu_torch.cli.*``.
* (``test_torch_shell.py`` runs the four ``tests/shell/`` scripts
  against the port.)
* ``config new`` writes ``[verifier] kind = "cuda"`` by default, and such
  a server on a host without a GPU exits non-zero: it never carries on on
  the CPU. Every other server here is configured with ``--verifier cpu``.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVER = [sys.executable, "-m", "at2_node_tpu_torch.cli.server"]
CLIENT = [sys.executable, "-m", "at2_node_tpu_torch.cli.client"]

TICK = 0.1
TIMEOUT = 30.0


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def run_cli(argv, stdin=None, check=True):
    proc = subprocess.run(argv, input=stdin, capture_output=True, text=True, env=_env(), timeout=60)
    if check and proc.returncode != 0:
        raise AssertionError(f"{argv} failed: {proc.stderr}")
    return proc


def wait_for_port(port, proc=None, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            if proc is not None and proc.poll() is not None:
                raise AssertionError(f"server exited {proc.returncode}: {proc.stderr.read()}")
            time.sleep(TICK)
    raise TimeoutError(f"port {port} never came up")


class ServerProcess:
    def __init__(self, config):
        self.proc = subprocess.Popen(SERVER + ["run"], stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                                     stderr=subprocess.PIPE, text=True, env=_env())
        self.proc.stdin.write(config)
        self.proc.stdin.close()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                return self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        return self.proc.wait()


def new_config(node_port, rpc_port, host="127.0.0.1", verifier=("--verifier", "cpu")):
    """``config new``; the host verifier unless ``verifier`` is () (the
    default table, the card's)."""
    return run_cli(SERVER + ["config", "new", *verifier, f"{host}:{node_port}", f"{host}:{rpc_port}"]).stdout


@pytest.fixture
def network_3():
    ports = chip_smoke.free_ports(6)
    pairs = list(zip(ports[0::2], ports[1::2]))
    configs = [new_config(np_, rp) for np_, rp in pairs]
    fragments = [run_cli(SERVER + ["config", "get-node"], stdin=c).stdout for c in configs]
    servers = [ServerProcess(c + "\n" + "\n".join(f for j, f in enumerate(fragments) if j != i))
               for i, c in enumerate(configs)]
    try:
        for (np_, rp), s in zip(pairs, servers):
            wait_for_port(np_, s.proc)
            wait_for_port(rp, s.proc)
        yield [rp for _, rp in pairs]
    finally:
        rcs = [s.stop() for s in servers]
    assert rcs == [0, 0, 0], "a server did not exit 0 on SIGTERM"


def new_wallet(rpc_port):
    return run_cli(CLIENT + ["config", "new", f"http://127.0.0.1:{rpc_port}"]).stdout


def wallet_pubkey(wallet):
    return run_cli(CLIENT + ["config", "get-public-key"], stdin=wallet).stdout.strip()


def get_balance(wallet):
    return int(run_cli(CLIENT + ["get-balance"], stdin=wallet).stdout)


def wait_for_sequence(wallet, seq):
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        if int(run_cli(CLIENT + ["get-last-sequence"], stdin=wallet).stdout) == seq:
            return
        time.sleep(TICK)
    raise TimeoutError(f"sequence {seq} not reached")


class TestConfigPlumbing:
    def test_server_config_roundtrip(self):
        assert '[verifier]\nkind = "cuda"\nbatch_size = 256\n' in new_config(1, 2, verifier=())
        cfg = new_config(1, 2)
        assert '[verifier]\nkind = "cpu"' in cfg and 'mode = "auto"' in cfg
        fragment = run_cli(SERVER + ["config", "get-node"], stdin=cfg).stdout
        assert "[[nodes]]" in fragment and 'address = "127.0.0.1:1"' in fragment

    def test_client_config_roundtrip(self):
        assert len(bytes.fromhex(wallet_pubkey(new_wallet(9)))) == 32

    def test_double_bind_fails(self):
        np_, rp = chip_smoke.free_ports(2)
        first = ServerProcess(new_config(np_, rp))
        try:
            wait_for_port(np_, first.proc)
            second = ServerProcess(new_config(np_, rp))
            assert second.proc.wait(timeout=TIMEOUT) != 0
        finally:
            first.stop()

    def test_dns_names_resolve(self):
        np_, rp = chip_smoke.free_ports(2)
        server = ServerProcess(new_config(np_, rp, host="localhost"))
        try:
            wait_for_port(np_, server.proc)
            wait_for_port(rp, server.proc)
            assert get_balance(new_wallet(rp)) == 100_000
        finally:
            assert server.stop() == 0

    def test_cuda_kind_without_a_gpu_exits_nonzero(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("this host has a GPU: the server would start")
        np_, rp = chip_smoke.free_ports(2)
        server = ServerProcess(new_config(np_, rp, verifier=()))
        assert server.proc.wait(timeout=TIMEOUT) != 0
        assert "no CUDA device" in server.proc.stderr.read()


class TestNetworkE2E:
    def test_transfer_conservation(self, network_3):
        sender, receiver = new_wallet(network_3[0]), new_wallet(network_3[0])
        run_cli(CLIENT + ["send-asset", "1", wallet_pubkey(receiver), "100"], stdin=sender)
        wait_for_sequence(sender, 1)
        assert get_balance(sender) == 99_900
        assert get_balance(receiver) == 100_100

    def test_tx_shows_in_latest(self, network_3):
        sender, receiver = new_wallet(network_3[0]), new_wallet(network_3[0])
        run_cli(CLIENT + ["send-asset", "1", wallet_pubkey(receiver), "77"], stdin=sender)
        wait_for_sequence(sender, 1)
        out = run_cli(CLIENT + ["get-latest-transactions"], stdin=sender).stdout
        assert "send 77¤" in out and "(success)" in out

    def test_client_against_dead_server_fails(self):
        proc = run_cli(CLIENT + ["send-asset", "1", "ab" * 32, "10"], stdin=new_wallet(1), check=False)
        assert proc.returncode != 0
