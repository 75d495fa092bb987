"""Multi-device image rendering: rays sharded over the mesh via shard_map.

The replacement for the reference's rayon par_iter over 8x8 pixel blocks
(/root/reference/src/lib.rs:532-550): the pixel grid becomes one flat ray
axis, sharded across every device of a `jax.sharding.Mesh`; each device
runs the same single-device chunked render (shard_map gives each device
its own program). Parameters are replicated; no collectives are
needed in the forward render, and the host gathers pixel shards exactly
like the reference's scatter into the flat image (lib.rs:552-557).

Because RNG streams are derived from *global* ray indices
(render.render_rays ray_ids), the sharded render is bitwise identical to
the single-device render.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from nerf_rs_tpu.config import RenderConfig
from nerf_rs_tpu.ops.rays import Camera, camera_rays
from nerf_rs_tpu.parallel.mesh import RAY_AXIS, make_mesh
from nerf_rs_tpu.render import _render_flat, _render_flat_aux


from nerf_rs_tpu.utils import round_up as _round_up


def effective_chunk(n_rays: int, n_devices: int, cfg: RenderConfig) -> int:
    """The per-device lax.map chunk the sharded render actually uses —
    pass to accel.{suggest,calibrate}_capacities so capacity tuning sees
    the same chunk partition. It is exactly the chunk the per-device
    padding is a multiple of (the sharded render passes it through to
    _render_flat explicitly)."""
    return min(cfg.ray_chunk, _round_up(max(n_rays // n_devices, 1), 128))


@functools.partial(jax.jit,
                   static_argnames=("n_per_dev", "cfg", "mesh", "chunk"))
def _render_flat_sharded(params_coarse, params_fine, origin, dirs_flat, near,
                         far, key, n_per_dev: int, cfg: RenderConfig, mesh,
                         grid=None, chunk: Optional[int] = None,
                         ray_ids_flat: Optional[jnp.ndarray] = None,
                         ray_ranges_flat: Optional[jnp.ndarray] = None):
    """``ray_ids_flat`` ((n_pad,) int32, ray-sharded like dirs) supplies
    explicit per-ray RNG ids — the ray-culled sharded render passes each
    packed ray's original image index so packing and sharding stay
    RNG-invariant (render._render_flat). ``ray_ranges_flat`` ((n_pad, 2),
    requires ids) carries precomputed per-ray sample ranges the same way."""
    if ray_ids_flat is None:
        def per_device(dirs_shard):
            dev = jax.lax.axis_index(RAY_AXIS)
            base = (dev * n_per_dev).astype(jnp.int32)
            return _render_flat(params_coarse, params_fine, origin,
                                dirs_shard, near, far, key, n_per_dev, cfg,
                                ray_id_base=base, grid=grid, chunk=chunk)

        in_specs, args = (P(RAY_AXIS),), (dirs_flat,)
    elif ray_ranges_flat is None:
        def per_device(dirs_shard, ids_shard):
            return _render_flat(params_coarse, params_fine, origin,
                                dirs_shard, near, far, key, n_per_dev, cfg,
                                grid=grid, chunk=chunk,
                                ray_ids_flat=ids_shard)

        in_specs, args = (P(RAY_AXIS), P(RAY_AXIS)), (dirs_flat, ray_ids_flat)
    else:
        def per_device(dirs_shard, ids_shard, ranges_shard):
            return _render_flat(params_coarse, params_fine, origin,
                                dirs_shard, near, far, key, n_per_dev, cfg,
                                grid=grid, chunk=chunk,
                                ray_ids_flat=ids_shard,
                                ray_ranges_flat=ranges_shard)

        in_specs = (P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS))
        args = (dirs_flat, ray_ids_flat, ray_ranges_flat)

    fn = shard_map(
        per_device, mesh=mesh,
        in_specs=in_specs,
        out_specs=P(RAY_AXIS),
    )
    return fn(*args)


@functools.partial(jax.jit,
                   static_argnames=("n_per_dev", "cfg", "mesh", "chunk"))
def _render_flat_aux_sharded(params_coarse, params_fine, origin, dirs_flat,
                             near, far, key, n_per_dev: int,
                             cfg: RenderConfig, mesh, grid=None,
                             chunk: Optional[int] = None):
    def per_device(dirs_shard):
        dev = jax.lax.axis_index(RAY_AXIS)
        base = (dev * n_per_dev).astype(jnp.int32)
        return _render_flat_aux(params_coarse, params_fine, origin,
                                dirs_shard, near, far, key, n_per_dev, cfg,
                                grid=grid, chunk=chunk, ray_id_base=base)

    fn = shard_map(
        per_device, mesh=mesh,
        in_specs=(P(RAY_AXIS),),
        out_specs=(P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
    )
    return fn(dirs_flat)


def render_image_aux_sharded(
    params_coarse, params_fine, camera: Camera, height: int, width: int,
    key: jax.Array, cfg: Optional[RenderConfig] = None, mesh=None, grid=None,
):
    """Sharded variant of render.render_image_aux: (rgb, depth, acc) with
    rays data-parallel over the mesh, bitwise equal to single-device."""
    cfg = cfg or RenderConfig()
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    _, dirs = camera_rays(camera, height, width)
    n = height * width
    chunk = min(cfg.ray_chunk, _round_up(max(n // n_dev, 1), 128))
    n_per_dev = _round_up(-(-n // n_dev), chunk)
    n_pad = n_per_dev * n_dev
    dirs_flat = dirs.reshape(n, 3)
    if n_pad > n:
        dirs_flat = jnp.concatenate(
            [dirs_flat, jnp.ones((n_pad - n, 3), dirs.dtype)], axis=0)
    rgb, depth, acc = _render_flat_aux_sharded(
        params_coarse, params_fine, jnp.asarray(camera.position), dirs_flat,
        jnp.asarray(camera.near), jnp.asarray(camera.far), key,
        n_per_dev, cfg, mesh, grid=grid, chunk=chunk,
    )
    return (rgb[:n].reshape(height, width, 3),
            depth[:n].reshape(height, width),
            acc[:n].reshape(height, width))


def render_image_sharded(
    params_coarse,
    params_fine,
    camera: Camera,
    height: int,
    width: int,
    key: jax.Array,
    cfg: Optional[RenderConfig] = None,
    mesh=None,
    grid=None,
) -> jnp.ndarray:
    """Render (height, width, 3) with rays data-parallel over the mesh.

    Bitwise identical to render.render_image for the same key thanks to
    global-ray-index RNG streams. ``grid`` (accel.OccupancyGrid) is
    replicated to every device. With cfg.accel_cull_rays, background rays
    are packed away before sharding (the multi-chip variant of
    render._render_image_culled); surviving rays stay bitwise equal.
    """
    cfg = cfg or RenderConfig()
    if grid is not None and cfg.accel_cull_rays:
        return _render_image_culled_sharded(
            params_coarse, params_fine, camera, height, width, key, cfg,
            mesh or make_mesh(), grid)
    rgb, n = render_flat_sharded(
        params_coarse, params_fine, camera, height, width, key, cfg, mesh,
        grid=grid,
    )
    return rgb[:n].reshape(height, width, 3)


def _render_image_culled_sharded(params_c, params_f, camera, height, width,
                                 key, cfg, mesh, grid):
    """Ray-culled sharded render: pack hit rays first (device-side stable
    sort, one hit-count host sync — render._ray_cull_order), shard the
    packed prefix evenly over the mesh, and scatter results back over a
    background frame. Each device renders ceil(hits / n_dev) rays instead
    of ceil(n / n_dev) — the ray-culling win composes with data
    parallelism. NOT used by the multihost flat path (render_flat_sharded
    keeps its static ray-sharded layout for .addressable_shards readers).
    """
    from nerf_rs_tpu.render import _image_ray_ranges

    n_dev = mesh.devices.size
    _, dirs = camera_rays(camera, height, width)
    n = height * width
    dirs_flat = dirs.reshape(n, 3)
    origin = jnp.asarray(camera.position)
    near, far = jnp.asarray(camera.near), jnp.asarray(camera.far)
    (t0, t1), order, n_hit = _image_ray_ranges(
        grid, origin, dirs.reshape(height, width, 3), near, far, cfg)
    n_hit = max(int(n_hit), 1)                      # the one host sync point
    chunk = effective_chunk(n, n_dev, cfg)
    dense_per_dev = _round_up(-(-n // n_dev), chunk)
    n_per_dev = min(_round_up(-(-n_hit // n_dev), chunk), dense_per_dev)
    n_render = n_per_dev * n_dev
    # Wrap-pad with leading (hit) rays — duplicates render to identical
    # values (same ray id -> same RNG stream). Modular take handles
    # n_render > 2n (many devices x chunk on small images).
    order_r = jnp.take(order, jnp.arange(n_render, dtype=jnp.int32) % n)
    ranges_flat = None
    if cfg.accel_sample_aabb:
        ranges_flat = jnp.take(
            jnp.concatenate([t0, t1], axis=-1), order_r, axis=0)
    rgb = _render_flat_sharded(
        params_c, params_f, origin, jnp.take(dirs_flat, order_r, axis=0),
        near, far, key, n_per_dev, cfg, mesh, grid=grid, chunk=chunk,
        ray_ids_flat=order_r, ray_ranges_flat=ranges_flat,
    )
    bg = 1.0 if cfg.white_background else 0.0
    img = jnp.full((n, 3), bg, jnp.float32).at[order_r].set(rgb)
    return img.reshape(height, width, 3)


def render_flat_sharded(
    params_coarse,
    params_fine,
    camera: Camera,
    height: int,
    width: int,
    key: jax.Array,
    cfg: Optional[RenderConfig] = None,
    mesh=None,
    grid=None,
):
    """Flat variant: returns ((n_pad, 3) ray-sharded rgb, n_valid).

    The rgb array keeps its P("rays") sharding — in a multi-process
    runtime it is a global (not fully addressable) array whose local rows
    are read via ``.addressable_shards`` (parallel/multihost.py)."""
    cfg = cfg or RenderConfig()
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    _, dirs = camera_rays(camera, height, width)
    n = height * width

    chunk = min(cfg.ray_chunk, _round_up(max(n // n_dev, 1), 128))
    n_per_dev = _round_up(-(-n // n_dev), chunk)
    n_pad = n_per_dev * n_dev
    dirs_flat = dirs.reshape(n, 3)
    if n_pad > n:
        dirs_flat = jnp.concatenate(
            [dirs_flat, jnp.ones((n_pad - n, 3), dirs.dtype)], axis=0
        )
    rgb = _render_flat_sharded(
        params_coarse, params_fine, jnp.asarray(camera.position), dirs_flat,
        jnp.asarray(camera.near), jnp.asarray(camera.far), key,
        n_per_dev, cfg, mesh, grid=grid, chunk=chunk,
    )
    return rgb, n
