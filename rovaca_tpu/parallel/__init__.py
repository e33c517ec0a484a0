"""Multi-device / multi-process parallel runtime.

Re-exports resolve lazily: ``sharding`` imports jax (a ~2s interpreter-start
cost), and pure-CPU pipeline runs only need ``host_executor``.
"""

_SHARDING_EXPORTS = ("make_data_mesh", "shard_intervals",
                     "sharded_pairhmm_step", "ordered_merge")


def __getattr__(name):
    if name in _SHARDING_EXPORTS:
        from . import sharding
        return getattr(sharding, name)
    raise AttributeError(name)
