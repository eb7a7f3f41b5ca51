"""Device mesh helpers for the sharded pipeline.

The reference's distribution unit is an MPI rank; ours is a mesh shard. One
1-D `shards` axis covers every device: on one host the cards reach each
other all to all (NVLink), so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

SHARD_AXIS = "shards"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devs), (SHARD_AXIS,))


def shard_spec() -> P:
    return P(SHARD_AXIS)


def replicated_spec() -> P:
    return P()
