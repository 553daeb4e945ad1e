"""Virtual-time event loop: the heart of the deterministic simulator.

Counterpart of ``at2_node_tpu/sim/scheduler.py``.

``SimScheduler`` subclasses ``asyncio.SelectorEventLoop`` with a
selector that never touches the OS: ``select(timeout)`` *is* the
passage of time. When asyncio computes "nothing runnable for the next
``timeout`` seconds" the virtual selector advances ``loop.time()`` by
exactly that much and returns no I/O events — so an episode's worth of
GC ticks, retransmission timers, catchup windows, and flush delays
execute back-to-back in microseconds of real time, in a total order
fixed entirely by the schedule.

Determinism notes:

* asyncio's ready queue is FIFO and its timer heap tie-breaks equal
  deadlines with a monotonic insertion counter, so callback order is a
  pure function of the schedule — no randomness to pin down here. Seeded
  tie-breaking for *network* events lives in the fabric (per-delivery
  jitter drawn from the episode rng).
* ``run_in_executor`` executes the function INLINE and returns an
  already-completed future: the CPU verifier's thread pool, checkpoint
  ``asyncio.to_thread`` saves, and verifier warm-up all become synchronous
  and ordered. Nothing in the sim ever runs off-loop.
* ``time()`` starts at :data:`SIM_START` (not 0.0): several components
  use ``0.0`` as a "never happened" sentinel (e.g. a slot's
  ``content_requested_at``), and a virtual epoch of zero would alias
  those.
* A ``select(None)`` — no runnable callbacks AND no timers — can never
  make progress in virtual time; it raises :class:`SimDeadlockError`
  instead of hanging, turning a lost-wakeup bug into a test failure.
"""

from __future__ import annotations

import asyncio
import selectors

# Virtual monotonic epoch. Nonzero so "stamp == 0.0 means unset"
# sentinels in the production code never collide with a real sim stamp.
SIM_START = 1000.0

# Virtual wall-clock epoch (2026-01-01T00:00:00Z). Only uniqueness
# matters to the code under test (batch_seq derivation).
SIM_WALL_EPOCH = 1_767_225_600.0


class SimDeadlockError(RuntimeError):
    """The loop would wait forever: no ready callbacks and no timers."""


class _VirtualSelector(selectors.BaseSelector):
    """A selector whose ``select`` advances virtual time.

    File registrations (the event loop's internal self-pipe, mostly)
    are recorded but never polled: no simulated component owns a real
    socket, and the inline executor means no thread ever needs the
    self-pipe wakeup.
    """

    def __init__(self, advance) -> None:
        self._advance = advance
        self._fd_to_key: dict = {}

    def register(self, fileobj, events, data=None):
        key = selectors.SelectorKey(
            fileobj, self._fileobj_fd(fileobj), events, data
        )
        self._fd_to_key[key.fd] = key
        return key

    def unregister(self, fileobj):
        return self._fd_to_key.pop(self._fileobj_fd(fileobj))

    def modify(self, fileobj, events, data=None):
        self.unregister(fileobj)
        return self.register(fileobj, events, data)

    def select(self, timeout=None):
        if timeout is None:
            raise SimDeadlockError(
                "simulation deadlock: no runnable callbacks and no timers"
                " — every task is awaiting an event nothing will fire"
            )
        if timeout > 0:
            self._advance(timeout)
        return []

    def close(self) -> None:
        self._fd_to_key.clear()

    def get_map(self):
        return {key.fileobj: key for key in self._fd_to_key.values()}

    @staticmethod
    def _fileobj_fd(fileobj) -> int:
        return fileobj if isinstance(fileobj, int) else fileobj.fileno()


class SimScheduler(asyncio.SelectorEventLoop):
    """Deterministic virtual-time asyncio loop.

    Drive it like any loop: ``loop.run_until_complete(coro)``. A
    convenience ``run_for(duration)`` advances virtual time by exactly
    ``duration``, executing everything scheduled inside the window.
    """

    def __init__(self, start: float = SIM_START) -> None:
        self._sim_now = start
        super().__init__(_VirtualSelector(self._advance_time))

    # -- virtual time ------------------------------------------------------

    def time(self) -> float:
        return self._sim_now

    def _advance_time(self, delta: float) -> None:
        self._sim_now += delta

    def run_for(self, duration: float) -> None:
        """Advance virtual time by ``duration``, running all work due."""
        self.run_until_complete(asyncio.sleep(duration))

    # -- no real threads ---------------------------------------------------

    def run_in_executor(self, executor, func, *args):
        fut = self.create_future()
        try:
            fut.set_result(func(*args))
        except BaseException as exc:  # delivered through the future
            fut.set_exception(exc)
        return fut


class SimClock:
    """The injectable clock (see ``at2_node_tpu_torch.clock``) bound to a
    :class:`SimScheduler`: ``monotonic()`` is the loop's virtual time,
    ``wall()`` offsets it to a fixed virtual epoch, and ``sleep``
    suspends in virtual time via the loop's timer heap."""

    def __init__(self, loop: SimScheduler) -> None:
        self._loop = loop
        self._wall_offset = SIM_WALL_EPOCH - loop.time()

    def monotonic(self) -> float:
        return self._loop.time()

    def wall(self) -> float:
        return self._wall_offset + self._loop.time()

    async def sleep(self, delay: float) -> None:
        await asyncio.sleep(delay)
