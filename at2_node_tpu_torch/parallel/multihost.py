"""Multi-process runtime bring-up (``torch.distributed`` over gloo).

Counterpart of ``at2_node_tpu/parallel/multihost.py``, with its scaling
model:

* **Verification pools stay local.** A node's ``PoolVerifier`` flushes its
  own traffic on its own schedule, so two processes' pools never run one
  program in lockstep; ``pool.make_pool_devices()`` takes this process's
  CUDA devices only, also under a process group.
* **Scale-out across hosts is the replication itself:** more nodes, each
  owning its host's cards.
* What the process group carries is scalars: ``pool.verify_and_count``
  with a group sums the valid count of every rank's local shards with one
  ``all_reduce``. The backend is gloo, on the CPU: only a scalar travels,
  and NCCL cannot run two ranks on one card.

Configuration is by environment, the reference's variables:

    AT2_COORDINATOR   host:port of rank 0's store (presence enables init)
    AT2_NUM_PROCESSES total process count
    AT2_PROCESS_ID    this process's rank

``maybe_initialize()`` is a no-op without ``AT2_COORDINATOR``; with it,
call it once before the process group is needed (the server CLI does so
before ``Service.start``).
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

_initialized = False


def maybe_initialize() -> bool:
    """Join the process group named by the ``AT2_*`` variables; True if it
    is (now or already) up, False when unconfigured. Idempotent."""
    global _initialized
    if _initialized:
        return True
    coordinator = os.environ.get("AT2_COORDINATOR")
    if not coordinator:
        return False
    try:
        num_processes = int(os.environ["AT2_NUM_PROCESSES"])
        process_id = int(os.environ["AT2_PROCESS_ID"])
    except (KeyError, ValueError) as exc:
        raise ValueError(
            "AT2_COORDINATOR is set, so AT2_NUM_PROCESSES and "
            "AT2_PROCESS_ID must both be set to integers — the three "
            "variables configure the multi-host runtime together"
        ) from exc
    import torch.distributed as dist

    dist.init_process_group(
        backend="gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )
    _initialized = True
    logger.info("multi-host runtime up: process %d/%d", process_id, num_processes)
    return True


def process_info() -> dict:
    """Operator-facing snapshot of the topology, with the reference's keys.
    Under a process group ``global_devices`` is an ``all_reduce`` of every
    rank's CUDA device count, so every rank must call it."""
    import torch
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    local = torch.cuda.device_count()
    total = local
    if up:
        t = torch.tensor([local], dtype=torch.int64)
        dist.all_reduce(t)
        total = int(t.item())
    return {
        "initialized": _initialized,
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": local,
        "global_devices": total,
    }
