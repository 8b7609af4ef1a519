"""Multi-rank scale: reservoir-axis sharding of one engine over ranks
(:mod:`.sharded`), joining a process group (:mod:`.multihost`), and
stream-axis parallelism, one logical stream sampled by several shards whose
reservoirs merge into one exact sample (:mod:`.merge`).  A rank is a torch
device, and a card may be named more than once."""

from . import multihost
from .sharded import (
    Mesh,
    make_mesh,
    reservoir_sharding,
    shard_state,
    sharded_result,
    sharded_update,
    state_shardings,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "multihost",
    "reservoir_sharding",
    "shard_state",
    "sharded_update",
    "sharded_result",
    "state_shardings",
]
