"""Occupancy-grid acceleration: empty-space skipping for inference.

The reference marches every ray through all 64+128 samples regardless of
content (/root/reference/src/lib.rs:375-459); its only work-saver is the
T<1e-4 early-out *inside* the weight loop. Here the equivalent lever is
skipping MLP evaluations entirely for samples in empty space, using a
precomputed conservative density grid (the NerfAcc recipe — see PAPERS.md)
— an opt-in fast mode; the exact reference-parity path stays the default.

Pieces:
- ``build_occupancy_grid``: one-time dense sigma sweep of the scene AABB on
  the pretrained network (chunked through the bf16 MLP), thresholded and
  dilated by one cell (3^3 max-pool) so the grid over-approximates
  occupancy.
- ``query_occupancy``: nearest-cell lookup for sample points (one flat
  gather).
- ``compact_apply``: evaluate ``fn`` only at masked rows by compacting
  them to a fixed-capacity buffer (static shapes under jit) and gathering
  results back; rows beyond capacity fall back to ``fill`` (overflow is
  counted so callers can validate). Two formulations: cumsum + scatter,
  and gather-only (cumsum + binary search).

Numerics: a skipped sample contributes sigma = 0 exactly. With a
conservative grid (low threshold + dilation) the image deviation is
bounded by the mass the grid misses; validated at the image level
(PSNR >= 40 dB vs the exact path on the lego scene).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class OccupancyGrid(NamedTuple):
    occ: jnp.ndarray        # (R, R, R) bool
    aabb_min: jnp.ndarray   # (3,) f32
    aabb_max: jnp.ndarray   # (3,) f32

    @property
    def resolution(self) -> int:
        return self.occ.shape[0]


@functools.lru_cache(maxsize=None)
def _default_grid_mlp_fn():
    """One cached partial (bf16 operands, f32 accumulation — the grid is
    thresholded and dilated, so bf16 sigma is ample): a fresh partial per
    build would defeat _grid_sweep's jit cache (mlp_fn identity is part of
    its key)."""
    from nerf_rs_tpu.models.mlp import nerf_mlp

    return functools.partial(nerf_mlp, sigma_only=True, dtype="bfloat16")


@functools.partial(jax.jit, static_argnames=("mlp_fn", "chunk", "r", "dilate",
                                             "return_sigma"))
def _grid_sweep(params, pts, sigma_threshold, *, mlp_fn, chunk: int, r: int,
                dilate: int, return_sigma: bool = False):
    """Module-level jit (NOT a per-call closure) so repeated grid builds —
    cli train --accel-every refreshes every N steps — compile once per
    (mlp_fn, chunk, r, dilate) instead of every call. ``return_sigma``
    additionally returns the raw density lattice (geometry extraction,
    extract.py)."""
    dirs = jnp.zeros((1, 3), jnp.float32).at[0, 2].set(1.0)  # sigma ignores dirs
    n = pts.shape[0]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    pts_p = jnp.pad(pts, ((0, pad), (0, 0))).reshape(n_chunks, chunk, 3)

    def body(p):
        _, sigma = mlp_fn(params, p, dirs)
        return sigma

    sig = jax.lax.map(body, pts_p).reshape(-1)[:n]
    occ = (sig > sigma_threshold).reshape(r, r, r)
    for _ in range(dilate):
        occ = jax.lax.reduce_window(
            occ, False, jax.lax.bitwise_or,
            window_dimensions=(3, 3, 3), window_strides=(1, 1, 1),
            padding="SAME",
        )
    if return_sigma:
        return occ, sig.reshape(r, r, r)
    return occ


@functools.lru_cache(maxsize=None)
def hashgrid_grid_kwargs(cfg) -> dict:
    """build_scene_grid kwargs for a hashgrid RenderConfig: sweep the hash
    field itself over ITS aabb. The default sweep assumes the MLP family
    (models/mlp.py) and the default (-2, 2) box — a hashgrid trained
    with a wider --hash-extent would otherwise have everything outside
    (-2, 2) silently culled (out-of-AABB = unoccupied, query_occupancy).
    Cached per (frozen, hashable) cfg so the sigma_fn identity is stable —
    _grid_sweep's jit cache keys on it (a per-call closure would recompile
    every grid refresh)."""
    from nerf_rs_tpu.render import get_mlp_fn

    mlp = get_mlp_fn(cfg)

    def sigma_fn(p, x, d):
        return mlp(p, x, d, sigma_only=True)

    return {"mlp_fn": sigma_fn, "aabb": cfg.hash.aabb}


def build_occupancy_grid(
    params,
    *,
    resolution: int = 128,
    aabb: Tuple[float, float] = (-2.0, 2.0),
    sigma_threshold: float = 0.01,
    dilate: int = 1,
    chunk: int = 262_144,
    mlp_fn: Optional[Callable] = None,
) -> OccupancyGrid:
    """Dense sigma sweep at cell centers -> thresholded, dilated bool grid.

    ``mlp_fn(params, points, viewdirs) -> (rgb, sigma)`` defaults to the
    bf16 MLP's sigma-only path. One-time cost: resolution^3 MLP evals
    (~2M at 128^3).
    """
    if mlp_fn is None:
        mlp_fn = _default_grid_mlp_fn()
    chunk = min(chunk, resolution ** 3)  # don't pad a small sweep 64x

    lo, hi = float(aabb[0]), float(aabb[1])
    r = resolution
    centers_1d = lo + (jnp.arange(r, dtype=jnp.float32) + 0.5) * ((hi - lo) / r)
    gx, gy, gz = jnp.meshgrid(centers_1d, centers_1d, centers_1d, indexing="ij")
    pts = jnp.stack([gx, gy, gz], axis=-1).reshape(-1, 3)      # (r^3, 3)

    occ = _grid_sweep(params, pts, jnp.float32(sigma_threshold),
                      mlp_fn=mlp_fn, chunk=chunk, r=r, dilate=dilate)
    return OccupancyGrid(
        occ=occ,
        aabb_min=jnp.full((3,), lo, jnp.float32),
        aabb_max=jnp.full((3,), hi, jnp.float32),
    )


def density_grid(
    params,
    *,
    resolution: int = 128,
    aabb: Tuple[float, float] = (-2.0, 2.0),
    chunk: int = 262_144,
    mlp_fn: Optional[Callable] = None,
) -> jnp.ndarray:
    """Raw sigma lattice at cell centers, (R, R, R) f32 — the input to
    geometry extraction (extract.extract_voxel_mesh). Same sweep machinery
    as build_occupancy_grid, without thresholding."""
    if mlp_fn is None:
        mlp_fn = _default_grid_mlp_fn()
    chunk = min(chunk, resolution ** 3)
    lo, hi = float(aabb[0]), float(aabb[1])
    r = resolution
    centers_1d = lo + (jnp.arange(r, dtype=jnp.float32) + 0.5) * ((hi - lo) / r)
    gx, gy, gz = jnp.meshgrid(centers_1d, centers_1d, centers_1d, indexing="ij")
    pts = jnp.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    _, sig = _grid_sweep(params, pts, jnp.float32(0.0), mlp_fn=mlp_fn,
                         chunk=chunk, r=r, dilate=0, return_sigma=True)
    return sig


def build_scene_grid(params_coarse, params_fine, **kw) -> OccupancyGrid:
    """Union occupancy of the coarse AND fine networks — the fine pass is
    culled by this grid too, and the two networks disagree slightly about
    surface extents (coarse-only grids measured ~24 dB vs ~120 dB image
    agreement on lego)."""
    gc = build_occupancy_grid(params_coarse, **kw)
    gf = build_occupancy_grid(params_fine, **kw)
    return OccupancyGrid(occ=gc.occ | gf.occ, aabb_min=gc.aabb_min,
                         aabb_max=gc.aabb_max)


def query_occupancy(grid: OccupancyGrid, points: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) points -> (...) bool: is the containing cell occupied?
    Out-of-AABB points are unoccupied."""
    r = grid.resolution
    scale = r / (grid.aabb_max - grid.aabb_min)
    ijk = jnp.floor((points - grid.aabb_min) * scale).astype(jnp.int32)
    in_bounds = jnp.all((ijk >= 0) & (ijk < r), axis=-1)
    ijk = jnp.clip(ijk, 0, r - 1)
    flat = (ijk[..., 0] * r + ijk[..., 1]) * r + ijk[..., 2]
    occ = jnp.take(grid.occ.reshape(-1), flat.reshape(-1)).reshape(flat.shape)
    return occ & in_bounds


def occupied_aabb(grid: OccupancyGrid) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Tight world-space AABB of the occupied cells, (lo, hi) each (3,).

    Three any-reductions + index min/max over the bool grid (~R^3 ops,
    microseconds next to one MLP chunk). A fully empty grid yields an
    inverted box (lo > hi) — ray_aabb_range then degenerates every ray's
    range to a point, which composites to pure background."""
    r = grid.resolution
    cell = (grid.aabb_max - grid.aabb_min) / r
    idx = jnp.arange(r, dtype=jnp.float32)
    axes = [jnp.any(grid.occ, axis=ax) for ax in ((1, 2), (0, 2), (0, 1))]
    first = jnp.stack([jnp.min(jnp.where(a, idx, jnp.float32(r))) for a in axes])
    last = jnp.stack([jnp.max(jnp.where(a, idx, jnp.float32(-1))) for a in axes])
    lo = grid.aabb_min + first * cell
    hi = grid.aabb_min + (last + 1.0) * cell
    return lo, hi


def ray_aabb_range(grid: OccupancyGrid, origin: jnp.ndarray,
                   dirs: jnp.ndarray, near, far,
                   pad_cells: float = 1.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-ray sample range [t0, t1] = the ray's intersection with the
    occupied-cell AABB (slab test), clamped to [near, far].

    With cfg.accel_sample_aabb the stratified sampler runs over [t0, t1]
    instead of [near, far]: the same Nc samples then resolve the occupied
    span at (far-near)/(t1-t0) times the density — on lego roughly 2x —
    which is what lets reduced-sample presets hold quality. The box is
    padded by ``pad_cells`` cells on each side (the grid is additionally
    dilated at build time). Rays that miss the box get t1 == t0: every
    sample lands on one point outside occupancy, is culled, and the ray
    composites to the background.

    Returns (t0, t1) shaped (*batch, 1) for direct use as the sampler's
    per-ray near/far. origin may be (3,) shared or (*batch, 3).
    """
    lo, hi = occupied_aabb(grid)
    # A fully empty grid yields an inverted box; the per-axis min/max of the
    # slab test would re-sort it into a spurious valid range, so collapse
    # explicitly below.
    is_empty = jnp.any(lo > hi)
    cell = (grid.aabb_max - grid.aabb_min) / grid.resolution
    lo = lo - pad_cells * cell
    hi = hi + pad_cells * cell
    # Slab test; zero components get a huge inverse so their slabs are
    # (-inf, inf) unless the origin lies outside — handled by the clamp.
    safe = jnp.where(jnp.abs(dirs) < 1e-9,
                     jnp.where(dirs < 0, -1e-9, 1e-9), dirs)
    inv = 1.0 / safe
    ta = (lo - origin) * inv
    tb = (hi - origin) * inv
    tmin = jnp.max(jnp.minimum(ta, tb), axis=-1, keepdims=True)
    tmax = jnp.min(jnp.maximum(ta, tb), axis=-1, keepdims=True)
    t0 = jnp.clip(tmin, near, far)
    t1 = jnp.clip(tmax, t0, far)   # misses (tmax < tmin) collapse to t1 == t0
    t1 = jnp.where(is_empty, t0, t1)
    return t0, t1


def ray_occupied_range(grid: OccupancyGrid, origin: jnp.ndarray,
                       dirs: jnp.ndarray, near, far, *, probes: int = 128,
                       pad_probes: float = 1.0,
                       pad_cells: float = 1.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-ray [t0, t1] spanning the ray's FIRST..LAST occupied cell.

    Strictly tighter than :func:`ray_aabb_range` (which it pre-clips with):
    a ray grazing the corner of the occupied box gets the short span it
    actually traverses, not the box chord. ``probes`` equally spaced grid
    lookups along the box span locate the occupied run; the result is
    padded by ``pad_probes`` probe intervals on each side (plus the grid's
    own build-time dilation) so thin features between probes stay covered.
    Rays with no occupied probe collapse to a point (background).

    Cost: probes lookups per ray, no MLP — at 800x800x128 this is ~80M
    int gathers once per render, microseconds-to-ms next to the MLP.
    """
    t0, t1 = ray_aabb_range(grid, origin, dirs, near, far,
                            pad_cells=pad_cells)
    frac = jnp.linspace(0.0, 1.0, probes, dtype=jnp.float32)
    ts = t0 + (t1 - t0) * frac                              # (*batch, P)
    pts = origin[..., None, :] + dirs[..., None, :] * ts[..., :, None]
    occ = query_occupancy(grid, pts)                        # (*batch, P)
    idx = jnp.arange(probes, dtype=jnp.float32)
    first = jnp.min(jnp.where(occ, idx, jnp.float32(probes)),
                    axis=-1, keepdims=True)
    last = jnp.max(jnp.where(occ, idx, jnp.float32(-1)),
                   axis=-1, keepdims=True)
    step = (t1 - t0) / (probes - 1)
    r0 = jnp.clip(t0 + (first - pad_probes) * step, t0, t1)
    r1 = jnp.clip(t0 + (last + pad_probes) * step, r0, t1)
    no_hit = first > last
    return jnp.where(no_hit, t0, r0), jnp.where(no_hit, t0, r1)


def strided_ray_ranges(grid: OccupancyGrid, origin: jnp.ndarray,
                       dirs_img: jnp.ndarray, near, far, *, stride: int,
                       probes: int = 128) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-ray occupied ranges computed on a ``stride``-subsampled ray
    grid, conservatively expanded back to full resolution.

    Why: exact per-ray probe ranges at 800x800x128 probes are 82 M grid
    gathers per frame. Probing one ray per stride x stride
    block cuts the gathers by stride^2; a 3x3 min/max union-pool over the
    coarse grid then widens each block's range to cover its neighbors, so
    intra-block geometry variation is bounded by a whole extra block of
    slack in every direction (plus the grid's own dilation + pad_probes).
    Bounded-error by the same argument as the rest of the accel mode and
    guarded by the image-level PSNR contract.

    dirs_img: (H, W, 3) unit directions. Returns (t0, t1) each (H*W, 1).
    """
    h, w = dirs_img.shape[:2]
    s = int(stride)
    if s <= 1:
        t0, t1 = ray_occupied_range(grid, origin, dirs_img.reshape(-1, 3),
                                    near, far, probes=probes)
        return t0, t1
    iy = jnp.minimum(jnp.arange(-(-h // s)) * s + s // 2, h - 1)
    ix = jnp.minimum(jnp.arange(-(-w // s)) * s + s // 2, w - 1)
    dirs_c = dirs_img[iy][:, ix]                       # (hs, ws, 3) centers
    hs, ws = dirs_c.shape[:2]
    t0c, t1c = ray_occupied_range(grid, origin, dirs_c.reshape(-1, 3),
                                  near, far, probes=probes)
    t0c = t0c.reshape(hs, ws)
    t1c = t1c.reshape(hs, ws)
    # Conservative 3x3 union: earliest entry, latest exit of any
    # neighboring block (a miss block bordering a hit block adopts the
    # hit's range and stays live).
    def pool(x, op, init):
        return jax.lax.reduce_window(
            x, init, op, window_dimensions=(3, 3), window_strides=(1, 1),
            padding="SAME")

    t0p = -pool(-t0c, jax.lax.max, -jnp.inf)
    t1p = pool(t1c, jax.lax.max, -jnp.inf)
    t0f = jnp.repeat(jnp.repeat(t0p, s, 0)[:h], s, 1)[:, :w]
    t1f = jnp.repeat(jnp.repeat(t1p, s, 0)[:h], s, 1)[:, :w]
    t1f = jnp.maximum(t1f, t0f)
    return t0f.reshape(-1, 1), t1f.reshape(-1, 1)


def compact_apply(
    fn: Callable[[jnp.ndarray], Tuple[jnp.ndarray, ...]],
    rows: jnp.ndarray,
    mask: jnp.ndarray,
    capacity: int,
    fills: Tuple[jnp.ndarray, ...],
    impl: Optional[str] = None,
):
    """Apply ``fn`` to only the masked rows of ``rows`` (N, F).

    Masked rows are scatter-compacted to a (capacity, F) buffer (overflow
    rows beyond ``capacity`` are dropped to their ``fill`` value), fn maps
    the buffer, and results scatter back to full shape. Returns
    (outputs..., n_live) with each output (N, ...) matching fn's per-row
    outputs; ``fills`` supplies the value for masked-off/overflowed rows.
    ``n_live`` is the TRUE number of masked rows (it can exceed
    ``capacity`` — callers should treat n_live > capacity as an overflow
    signal and raise the capacity fraction).

    ``impl`` selects the compaction formulation ("scatter" | "gather";
    defaults to $NERF_ACCEL_COMPACT or "scatter"). Render callers thread
    RenderConfig.accel_compact here — including its "none" (mask-only)
    mode, which never reaches this function (render._mlp_culled handles
    it densely).
    """
    import os

    n = rows.shape[0]
    mask = mask.reshape(n)
    csum = jnp.cumsum(mask.astype(jnp.int32))        # inclusive live count
    pos = csum - 1                                   # position among live rows
    live_total = csum[-1]
    dest = jnp.where(mask & (pos < capacity), pos, capacity)  # capacity = trash
    if impl is None:
        impl = os.environ.get("NERF_ACCEL_COMPACT", "scatter")
    if impl == "gather":
        # Scatter-free alternative: find the j-th live row by binary
        # search over the inclusive cumsum (log2(n)~20 vectorized gathers)
        # and gather rows to the buffer.
        slots = jnp.arange(1, capacity + 1, dtype=csum.dtype)
        src = jnp.searchsorted(csum, slots, side="left")
        valid = (jnp.arange(capacity) < live_total)[:, None]
        buf = jnp.where(valid,
                        jnp.take(rows, jnp.minimum(src, n - 1), axis=0),
                        jnp.zeros((), rows.dtype))
        outs = fn(buf)
    else:  # impl == "scatter": the original formulation, kept for A/B
        buf = jnp.zeros((capacity + 1, rows.shape[1]), rows.dtype)
        buf = buf.at[dest].set(rows, mode="drop")
        outs = fn(buf[:capacity])
    gathered = []
    for out, fill in zip(outs, fills):
        # dest < capacity selects rows that were actually evaluated
        g = jnp.take(out, jnp.minimum(dest, capacity - 1), axis=0)
        keep = (dest < capacity)
        keep = keep.reshape((n,) + (1,) * (out.ndim - 1))
        gathered.append(jnp.where(keep, g, fill))
    return (*gathered, live_total)


def capacities_from_occupancy(frac: float, cfg, *, margin_coarse: float = 2.2,
                              margin_fine: float = 1.15,
                              quantum: float = 0.125):
    """Heuristic (cap_coarse, cap_fine) from a volume-occupancy fraction.

    Camera-free capacity model for when no ray geometry is available (the
    training loop's per-refresh grids, cli train --accel-every): rays
    concentrate on the object, so the coarse capacity is the volume
    fraction with a generous margin; the fine pass resamples only near
    geometry, so its bound is the usual (cap_c*Nc + Nf)/(Nc + Nf) blend
    (same model as suggest_capacities' camera-aware variant). Capacities
    are floored at the cfg defaults and quantized to ``quantum`` steps so
    refresh-to-refresh drift doesn't recompile the step every time.
    """
    def up(v: float) -> float:
        return min(1.0, -(-v // quantum) * quantum)

    cap_c = max(cfg.accel_coarse_capacity, up(margin_coarse * frac))
    nc, nf = cfg.n_coarse, cfg.n_fine
    cap_f = max(cfg.accel_fine_capacity,
                up(margin_fine * (cap_c * nc + nf) / (nc + nf)))
    return cap_c, cap_f


@jax.jit
def _worst_chunk_frac(grid, origin, mids, dirs_chunks):
    """Module-level jit (stable cache across suggest_capacities calls)."""
    def body(d):
        pts = origin + d[:, None, :] * mids[None, :, None]
        return jnp.mean(query_occupancy(grid, pts).astype(jnp.float32))

    return jnp.max(jax.lax.map(body, dirs_chunks))


def suggest_capacities(grid: OccupancyGrid, camera, height: int, width: int,
                       cfg, margin: float = 1.3,
                       chunk: Optional[int] = None):
    """Derive chunk-safe static capacity fractions for the accel path.

    The accel capacities are jit-static fractions; too small and real
    samples overflow to sigma = 0 (quality loss), too large and the MLP
    batch shrinks less (speed loss). This measures what the image actually
    needs: it casts the image's rays with render_image's exact chunking and
    padding, samples every coarse bin at its jitter-free midpoint, and
    queries the grid — pure lookups, no MLP evals (~n_rays*n_coarse cells,
    a few ms). The coarse capacity becomes the occupied fraction of the
    WORST chunk times ``margin`` (stratified jitter moves a sample only
    within its bin, and the grid is dilated by one cell, so midpoints are a
    faithful proxy); the fine capacity uses the all-fine-samples-occupied
    upper bound of that worst chunk (importance resampling concentrates
    fine samples inside occupied cells). Termination culling usually needs
    less than the bound — tune accel_fine_capacity down if profiling shows
    headroom.

    Returns ``cfg`` with accel_{coarse,fine}_capacity replaced.
    """
    from nerf_rs_tpu.ops.rays import camera_rays

    _, dirs = camera_rays(camera, height, width)
    n = height * width
    # ``chunk`` overrides the partition when the caller renders with a
    # different chunking than render_image's (e.g. the per-device chunk of
    # render_image_sharded — parallel.render_sharded.effective_chunk).
    chunk = chunk or min(cfg.ray_chunk, max(n, 1))
    pad = (-n) % chunk
    dirs_flat = jnp.asarray(dirs, jnp.float32).reshape(n, 3)
    if pad:
        dirs_flat = jnp.concatenate(
            [dirs_flat, jnp.ones((pad, 3), jnp.float32)], axis=0
        )
    near, far = float(camera.near), float(camera.far)
    mids = near + (jnp.arange(cfg.n_coarse, dtype=jnp.float32) + 0.5) * (
        (far - near) / cfg.n_coarse
    )
    origin = jnp.asarray(camera.position, jnp.float32)

    worst = float(_worst_chunk_frac(grid, origin, mids,
                                    dirs_flat.reshape(-1, chunk, 3)))
    coarse = min(1.0, margin * worst + 1e-3)
    fine_ub = (worst * cfg.n_coarse + cfg.n_fine) / (cfg.n_coarse + cfg.n_fine)
    fine = min(1.0, margin * fine_ub)
    return cfg.replace(accel_coarse_capacity=coarse, accel_fine_capacity=fine)


def calibrate_capacities(params_coarse, params_fine, grid: OccupancyGrid,
                         camera, height: int, width: int, key, cfg,
                         margin: float = 1.15,
                         chunk: Optional[int] = None):
    """Measure-then-tighten the accel capacity fractions.

    Runs ONE instrumented render at capacity 1.0 (no overflow possible)
    recording the true worst-chunk live sample counts of both passes, then
    returns ``cfg`` with capacities set to measured/maximum x ``margin``.
    Unlike suggest_capacities (geometry-only, conservative about the fine
    pass because it cannot see termination culling), this measures what the
    scene + sampler actually need, so the fine capacity tightens to the
    post-culling live set — the knob that matters, since the fine pass is
    ~2/3 of the FLOPs. One render of calibration cost; re-calibrate when
    the camera moves substantially (capacities are jit-static, so a changed
    value recompiles).

    The stratified jitter differs per key; margin absorbs that (jitter
    moves samples within their bin and the grid is dilated by one cell).
    """
    n = height * width
    # ``chunk`` overrides the partition to match a different chunking than
    # render_image's (e.g. render_image_sharded's per-device chunk). The
    # measurement builds the SAME padded flat layout the real render uses
    # — chunk-dividing padding with (1,1,1) pad rays — so the live counts
    # cover exactly the chunks (pad rays included: their samples can hit
    # occupied cells and consume capacity too). A plain render_image here
    # would re-derive min(chunk, n) and mis-scale small images.
    chunk = chunk or min(cfg.ray_chunk, max(n, 1))
    wide = cfg.replace(accel_coarse_capacity=1.0, accel_fine_capacity=1.0)
    from nerf_rs_tpu.ops.rays import camera_rays
    from nerf_rs_tpu.render import _render_flat
    from nerf_rs_tpu.utils import round_up

    _, dirs = camera_rays(camera, height, width)
    n_pad = round_up(max(n, 1), chunk)
    dirs_flat = jnp.asarray(dirs, jnp.float32).reshape(n, 3)
    if n_pad > n:
        dirs_flat = jnp.concatenate(
            [dirs_flat, jnp.ones((n_pad - n, 3), dirs_flat.dtype)], axis=0
        )
    _, (live_c, live_f) = _render_flat(
        params_coarse, params_fine, jnp.asarray(camera.position), dirs_flat,
        jnp.asarray(camera.near), jnp.asarray(camera.far), key,
        n_pad, wide, grid=grid, return_live=True, chunk=chunk,
    )
    coarse = min(1.0, margin * float(live_c) / (chunk * cfg.n_coarse))
    fine = min(1.0, margin * float(live_f)
               / (chunk * (cfg.n_coarse + cfg.n_fine)))
    return cfg.replace(accel_coarse_capacity=coarse, accel_fine_capacity=fine)
