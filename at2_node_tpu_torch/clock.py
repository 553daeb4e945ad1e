"""The clock seam: one injectable time source for timed components.

Counterpart of ``at2_node_tpu/clock.py``. The batch verifier takes an
optional ``clock`` (default :data:`SYSTEM_CLOCK`, real time) so tests and a
simulator can drive its flush timer with virtual time.
"""

from __future__ import annotations

import asyncio
import time


class SystemClock:
    """Real time: the default for every production component."""

    def monotonic(self) -> float:
        return time.monotonic()

    def wall(self) -> float:
        return time.time()

    async def sleep(self, delay: float) -> None:
        await asyncio.sleep(delay)


SYSTEM_CLOCK = SystemClock()
