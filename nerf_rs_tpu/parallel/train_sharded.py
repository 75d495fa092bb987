"""Multi-device training: ray-data-parallel over a jax.sharding.Mesh.

Shardings: batch leading axis -> P("rays"), params/opt-state replicated.
The step is an explicit shard_map program: each device runs fwd+bwd on its
ray shard with GLOBAL ray ids (so the jitter matches the single-device
step bitwise per ray), then ONE fused pmean all-reduces gradients and
metrics together (NCCL over NVLink on a multi-GPU host). Explicit shard_map — rather than letting the
partitioner propagate through a global program — matters for the accel
path: compact_apply's cumsum/scatter over a globally-flattened sample
axis is not partitionable, and XLA inserts all-gathers that replicate the
whole MLP batch onto every device (6 all-gathers in the compiled HLO). Per-device
compaction keeps the step collective-minimal (tests/test_hlo.py pins it).

Multi-host: call `jax.distributed.initialize()` before building the mesh;
the same code then spans hosts (the collective crosses the hosts'
network instead of NVLink).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from nerf_rs_tpu.config import TrainConfig
from nerf_rs_tpu.parallel.mesh import (
    RAY_AXIS, make_mesh, ray_sharding, replicate, replicated_sharding,
)
from nerf_rs_tpu.train import (
    TrainState, create_train_state, make_optimizer, nerf_loss,
)


def shard_batch(mesh, batch: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    """Leading-axis-shard the per-ray arrays ((B, ...), ndim >= 2);
    replicate scalars and single vectors like a shared (3,) origin."""
    ray_sh = ray_sharding(mesh)
    rep_sh = replicated_sharding(mesh)
    out = {}
    for k, v in batch.items():
        v = jnp.asarray(v)
        out[k] = jax.device_put(v, ray_sh if v.ndim >= 2 else rep_sh)
    return out


def create_sharded_train_state(key: jax.Array, cfg: TrainConfig, mesh=None) -> Tuple[Any, TrainState]:
    mesh = mesh or make_mesh()
    state = create_train_state(key, cfg)
    state = replicate(mesh, state)
    return mesh, state


def _batch_specs(batch):
    return {k: (P(RAY_AXIS) if jnp.ndim(v) >= 2 else P())
            for k, v in batch.items()}


@functools.partial(jax.jit, donate_argnums=(1,),
                   static_argnames=("cfg", "mesh", "n_local", "has_grid"))
def _sharded_step(mesh, state: TrainState, batch, key, cfg: TrainConfig,
                  grid, n_local: int, has_grid: bool):
    def per_device(params, local_batch, local_grid):
        dev = jax.lax.axis_index(RAY_AXIS)
        ids = dev * n_local + jnp.arange(n_local, dtype=jnp.int32)

        def loss_fn(p):
            return nerf_loss(p, local_batch, key, cfg,
                             local_grid if has_grid else None, ray_ids=ids)

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        # ONE collective: grads + metrics pmean'd together (equal shard
        # sizes make the pmean of per-shard means the global mean).
        return jax.lax.pmean((grads, metrics), RAY_AXIS)

    fn = shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), _batch_specs(batch), P()),
        out_specs=(P(), P()),
        # With varying-axis checking on, the compiled step carries one
        # all-reduce per gradient leaf (49) instead of ONE fused pmean
        # (tests/test_hlo.py).
        check_vma=False,
    )
    grads, metrics = fn(state.params, batch,
                        grid if has_grid else jnp.zeros((), jnp.float32))
    # psnr is not linear in mse — recompute from the pooled fine mse.
    metrics["psnr"] = -10.0 * jnp.log10(jnp.maximum(metrics["mse_fine"], 1e-10))
    updates, opt_state = make_optimizer(cfg).update(
        grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), metrics


def sharded_train_step(mesh, state: TrainState, batch, key: jax.Array,
                       cfg: TrainConfig, grid=None):
    """One data-parallel step (see module docstring). ``grid``
    (accel.OccupancyGrid) is replicated to every device."""
    # Check divisibility BEFORE shard_batch: device_put on a non-divisible
    # leading axis raises its own (less helpful) error first otherwise.
    n_total = jnp.shape(jnp.asarray(batch["dirs"]))[0]
    n_dev = mesh.devices.size
    if n_total % n_dev:
        raise ValueError(f"batch of {n_total} rays does not divide over "
                         f"{n_dev} devices")
    batch = shard_batch(mesh, batch)
    if grid is not None:
        grid = jax.device_put(grid, replicated_sharding(mesh))
    return _sharded_step(mesh, state, batch, key, cfg, grid,
                         n_total // n_dev, grid is not None)
