"""Scale-out: the device pool (pool.py) and the multi-process runtime
(multihost.py), and the sharded broadcast plane's executors (plane.py,
plane_worker.py, ring.py).

Counterpart of ``at2_node_tpu/parallel/__init__.py``. Lazy exports (PEP
562): importing this package imports neither torch nor the pool, and the
plane names resolve to ``plane.py`` alone, which is stdlib only: a spawn
plane worker re-imports this package and must not load torch or CUDA.
"""

__all__ = [
    "PoolVerifier",
    "make_pool_devices",
    "pool_bucket_for",
    "verify_and_count",
    "verify_batch_sharded",
    "InlinePlaneExecutor",
    "SPSCQueue",
    "ThreadPlaneExecutor",
    "make_plane_executor",
]

_PLANE = {
    "InlinePlaneExecutor",
    "SPSCQueue",
    "ThreadPlaneExecutor",
    "make_plane_executor",
}


def __getattr__(name):
    if name in _PLANE:
        from . import plane

        return getattr(plane, name)
    if name in __all__:
        from . import pool

        return getattr(pool, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
