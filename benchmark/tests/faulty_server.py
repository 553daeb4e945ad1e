"""The port's ``server run`` with one fault planted, for the tests that
show a broken program comes out not correct:

    python benchmark/tests/faulty_server.py <fault> < node.toml

* ``unchanged``: the ledger's commit step leaves its state unchanged;
* ``half``: every second transfer a node takes in is acknowledged and
  left out (half of each SendAssetBatch, every second SendAsset);
* ``altered``: GetBalance answers one more than the ledger holds;
* ``loads_jax``: a module named ``jax`` is put into ``sys.modules``
  (the import guard's case; nothing else changes).
"""

import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from at2_node_tpu_torch.cli import server  # noqa: E402
from at2_node_tpu_torch.ledger import accounts  # noqa: E402
from at2_node_tpu_torch.node import service  # noqa: E402
from at2_node_tpu_torch.proto import at2_pb2  # noqa: E402


def plant(fault: str) -> None:
    if fault == "unchanged":
        accounts.Accounts._transfer = lambda self, *args: None
    elif fault == "half":
        ingest = service.Service._ingest
        taken = [0]

        async def half(self, payloads):
            kept = [p for i, p in enumerate(payloads, start=taken[0]) if i % 2 == 0]
            taken[0] += len(payloads)
            if kept:
                await ingest(self, kept)

        service.Service._ingest = half
    elif fault == "altered":
        get_balance = service.Service.GetBalance

        async def altered(self, request, context):
            reply = await get_balance(self, request, context)
            return at2_pb2.GetBalanceReply(amount=reply.amount + 1)

        service.Service.GetBalance = altered
    elif fault == "loads_jax":
        sys.modules["jax"] = types.ModuleType("jax")
    else:
        raise SystemExit(f"unknown fault {fault!r}")


if __name__ == "__main__":
    plant(sys.argv[1])
    sys.exit(server.main(["run"]))
