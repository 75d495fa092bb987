"""Device mesh + sharding layout.

The reference's only parallelism is rayon work-stealing over 8x8 pixel blocks
(/root/reference/src/lib.rs:532-550). The replacement here: rays are
data-parallel across devices on a 1-D ``jax.sharding.Mesh`` axis ``"rays"``;
MLP parameters (~2.4 MB per network) are replicated, so gradient sync is a
single psum all-reduce XLA inserts automatically for sharded-batch /
replicated-param jit. TP/PP/EP are deliberately not built — they do not apply
to a 595K-param MLP (SURVEY.md §2).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name "rays"."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (ray/batch) dimension across the mesh."""
    return NamedSharding(mesh, P(RAY_AXIS))

def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully replicated (used for MLP parameters)."""
    return NamedSharding(mesh, P())


def shard_rays(mesh: Mesh, *arrays):
    """Place arrays with their leading axis sharded over the mesh."""
    sh = ray_sharding(mesh)
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out[0] if len(out) == 1 else out


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (e.g. params) on every device of the mesh."""
    sh = replicated_sharding(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)
