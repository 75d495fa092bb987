"""Multi-host runtime setup.

The reference has no multi-process capability (SURVEY.md §2: rayon threads
only). Here, scaling past one host is JAX's distributed runtime: every host
calls `initialize()` before touching devices; XLA then runs collectives
within a host (NVLink) and across hosts with the same mesh code used on
one device (parallel/mesh.py builds the mesh from `jax.devices()`, which
is already global after initialization).

Rendering multi-host: each host renders the ray shards of ITS devices
(render_sharded works unchanged — shard_map addresses the global mesh) and
`gather_image_shards` assembles host-local pixels for the writer, the
analogue of the reference's scatter into the flat image (lib.rs:552-557).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the multi-host runtime (env-var driven).

    Arguments default to $JAX_COORDINATOR_ADDRESS / $JAX_NUM_PROCESSES /
    $JAX_PROCESS_ID. When both args and env are absent nothing is
    attempted (single-process startup must stay cheap and offline);
    set $NERF_MULTIHOST_AUTO=1 to opt into calling
    ``jax.distributed.initialize()`` with no arguments, which uses JAX's
    own cluster auto-detection (SLURM / Open MPI env). Returns
    True when a multi-process runtime is active. Safe to call again after
    a successful bring-up (the duplicate initialize is swallowed).
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else (
        int(os.environ["JAX_NUM_PROCESSES"]) if "JAX_NUM_PROCESSES" in os.environ else None
    )
    process_id = process_id if process_id is not None else (
        int(os.environ["JAX_PROCESS_ID"]) if "JAX_PROCESS_ID" in os.environ else None
    )
    try:
        if coordinator_address is None and num_processes is None:
            if os.environ.get("NERF_MULTIHOST_AUTO") == "1":
                jax.distributed.initialize()
            return jax.process_count() > 1
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e).lower():
            raise
    return jax.process_count() > 1


def process_ray_slice(n_rays: int, cfg=None) -> slice:
    """The contiguous slice of REAL (unpadded) global ray indices owned by
    this process, matching render_flat_sharded's actual layout: the padded
    ray axis is split n_per_dev rows per device, devices process-major
    (mesh.make_mesh over jax.devices() order). A plain
    ceil(n/process_count) would disagree with the per-device padding
    whenever n_per_dev rounds up."""
    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.utils import round_up

    cfg = cfg or RenderConfig()
    n_dev = jax.device_count()
    chunk = min(cfg.ray_chunk, round_up(max(n_rays // n_dev, 1), 128))
    n_per_dev = round_up(-(-n_rays // n_dev), chunk)
    first_dev = jax.process_index() * jax.local_device_count()
    lo = first_dev * n_per_dev
    hi = lo + jax.local_device_count() * n_per_dev
    return slice(min(lo, n_rays), min(hi, n_rays))


def gather_image_shards(local_pixels: np.ndarray, n_rays: int) -> Optional[np.ndarray]:
    """Host-gather pixel shards to process 0 (None elsewhere).

    Uses jax's cross-process allgather on host data; single-process input
    is returned unchanged.
    """
    if jax.process_count() == 1:
        return local_pixels[:n_rays]
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(local_pixels)
    full = np.concatenate([np.asarray(g) for g in gathered], axis=0)[:n_rays]
    return full if jax.process_index() == 0 else None


def local_ray_rows(rgb_flat) -> np.ndarray:
    """Host-local rows of a P("rays")-sharded global array, in global row
    order (shards sorted by their global row offset)."""
    shards = sorted(rgb_flat.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def render_image_multihost(
    params_coarse,
    params_fine,
    camera,
    height: int,
    width: int,
    key,
    cfg=None,
    grid=None,
) -> Optional[np.ndarray]:
    """Multi-process render: every process executes the same global
    shard_map program over the global mesh (its devices compute their ray
    shards), then host-gathers pixels to process 0.

    Returns the (height, width, 3) image on process 0, None elsewhere —
    the analogue of the reference's rayon scatter into one flat image
    (lib.rs:552-557), with hosts in place of threads. Bitwise identical
    to render.render_image on one device (global-ray-index RNG streams).
    In a single-process runtime it degrades to render_image_sharded.
    """
    from nerf_rs_tpu.parallel.render_sharded import render_flat_sharded

    rgb_flat, n = render_flat_sharded(
        params_coarse, params_fine, camera, height, width, key, cfg,
        grid=grid,
    )
    local = local_ray_rows(rgb_flat)
    full = gather_image_shards(local, n)
    return None if full is None else full.reshape(height, width, 3)
