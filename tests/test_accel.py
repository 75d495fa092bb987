"""Occupancy-grid acceleration: grid build, queries, compaction, and the
image-level guarantee (accelerated render ~= exact render)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.accel import (
    OccupancyGrid,
    build_occupancy_grid,
    compact_apply,
    query_occupancy,
)
from nerf_rs_tpu.config import RenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden
from nerf_rs_tpu.models.mlp import nerf_mlp
from nerf_rs_tpu.render import render_image


def _sphere_grid(res=16, radius=0.5):
    """Analytic grid: occupied inside a radius-0.5 sphere at the origin."""
    c = -1.0 + (np.arange(res) + 0.5) * (2.0 / res)
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    occ = (gx**2 + gy**2 + gz**2) < radius**2
    return OccupancyGrid(
        occ=jnp.asarray(occ),
        aabb_min=jnp.full((3,), -1.0, jnp.float32),
        aabb_max=jnp.full((3,), 1.0, jnp.float32),
    )


def test_query_occupancy_sphere():
    grid = _sphere_grid()
    pts = jnp.asarray([[0.0, 0.0, 0.0], [0.9, 0.9, 0.9], [5.0, 0.0, 0.0],
                       [0.3, 0.0, 0.0]], jnp.float32)
    got = np.asarray(query_occupancy(grid, pts))
    np.testing.assert_array_equal(got, [True, False, False, True])
    # batched shapes preserved
    got2 = query_occupancy(grid, pts.reshape(2, 2, 3))
    assert got2.shape == (2, 2)


def test_compact_apply_matches_dense():
    rng = np.random.default_rng(0)
    rows = jnp.asarray(rng.normal(size=(64, 6)).astype(np.float32))
    mask = jnp.asarray(rng.uniform(size=64) < 0.4)

    def fn(buf):
        return (buf[:, :3] * 2.0, jnp.sum(buf, axis=1, keepdims=True))

    a, b, n_live = compact_apply(fn, rows, mask, capacity=64, fills=(0.0, 0.0))
    want_a = np.where(np.asarray(mask)[:, None], np.asarray(rows[:, :3]) * 2, 0)
    want_b = np.where(np.asarray(mask)[:, None], np.asarray(rows).sum(1, keepdims=True), 0)
    np.testing.assert_allclose(np.asarray(a), want_a, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b), want_b, atol=1e-6)
    assert int(n_live) == int(np.asarray(mask).sum())


def test_compact_apply_overflow_falls_back_to_fill():
    rows = jnp.ones((32, 2), jnp.float32)
    mask = jnp.ones((32,), bool)

    def fn(buf):
        return (buf * 3.0,)

    (out, n_live) = compact_apply(fn, rows, mask, capacity=8, fills=(-1.0,))
    out = np.asarray(out)
    assert (out[:8] == 3.0).all()          # first 8 live rows evaluated
    assert (out[8:] == -1.0).all()          # overflow -> fill
    assert int(n_live) == 32                # TRUE live count signals overflow


def test_compact_apply_gather_matches_scatter(monkeypatch):
    """The gather-only compaction is bit-equal to the scatter
    formulation, including the overflow regime (capacity < live count)."""
    rng = np.random.default_rng(3)
    rows = jnp.asarray(rng.normal(size=(128, 6)).astype(np.float32))
    mask = jnp.asarray(rng.uniform(size=128) < 0.6)

    def fn(buf):
        return (buf[:, :3] - 1.0, jnp.max(buf, axis=1, keepdims=True))

    outs = {}
    for impl in ("gather", "scatter"):
        monkeypatch.setenv("NERF_ACCEL_COMPACT", impl)
        for cap in (128, 16):  # ample and overflowing
            a, b, n_live = compact_apply(fn, rows, mask, capacity=cap,
                                         fills=(0.0, -2.0))
            outs[(impl, cap)] = (np.asarray(a), np.asarray(b), int(n_live))
    for cap in (128, 16):
        ga, gb, gn = outs[("gather", cap)]
        sa, sb, sn = outs[("scatter", cap)]
        np.testing.assert_array_equal(ga, sa)
        np.testing.assert_array_equal(gb, sb)
        assert gn == sn == int(np.asarray(mask).sum())


def test_build_grid_and_accel_render_close_to_exact(lego_params, golden):
    """End-to-end: accelerated lego render within tight PSNR of the exact
    render (the accel contract from accel.py's docstring)."""
    from nerf_rs_tpu.accel import build_scene_grid

    cfg = RenderConfig(n_coarse=32, n_fine=64, ray_chunk=256)
    grid = build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=48, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=48 * 48 * 48, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )
    frac = float(jnp.mean(grid.occ.astype(jnp.float32)))
    assert 0.005 < frac < 0.6, f"implausible occupancy fraction {frac}"

    cam = camera_from_golden(golden)
    key = jax.random.key(11)
    exact = render_image(lego_params["coarse"], lego_params["fine"], cam,
                         16, 16, key, cfg)
    fast = render_image(lego_params["coarse"], lego_params["fine"], cam,
                        16, 16, key, cfg, grid=grid)
    mse = float(jnp.mean((exact - fast) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    assert psnr > 40.0, f"accel render deviates: {psnr:.1f} dB"


def test_suggest_capacities_synthetic():
    """suggest_capacities derives the coarse fraction from actual ray/grid
    geometry: an empty grid suggests ~0, a solid grid suggests what the
    rays actually traverse (bounded by time inside the AABB)."""
    from nerf_rs_tpu.accel import suggest_capacities
    from nerf_rs_tpu.ops.rays import Camera

    cam = Camera(
        position=np.asarray([0.0, 0.0, 3.0], np.float32),
        forward=np.asarray([0.0, 0.0, -1.0], np.float32),
        up=np.asarray([0.0, 1.0, 0.0], np.float32),
        alpha_width=np.float32(0.3), alpha_height=np.float32(0.3),
        near=np.float32(2.0), far=np.float32(6.0),
    )
    cfg = RenderConfig(n_coarse=32, n_fine=64, ray_chunk=256)

    empty = OccupancyGrid(
        occ=jnp.zeros((8, 8, 8), bool),
        aabb_min=jnp.full((3,), -1.0, jnp.float32),
        aabb_max=jnp.full((3,), 1.0, jnp.float32),
    )
    got = suggest_capacities(empty, cam, 16, 16, cfg)
    assert got.accel_coarse_capacity < 0.01

    solid = empty._replace(occ=jnp.ones((8, 8, 8), bool))
    got = suggest_capacities(solid, cam, 16, 16, cfg)
    # the 2-wide AABB spans half the 4-long sample range -> ~50% of samples
    # inside, x margin 1.3
    assert 0.4 < got.accel_coarse_capacity < 0.9
    assert got.accel_fine_capacity > 0.9   # fine concentrates in occupancy


def test_suggest_capacities_fixes_overflow(lego_params, golden):
    """At image sizes where the default static capacities overflow (real
    samples silently dropped to sigma=0), suggest_capacities restores the
    >40 dB accel contract."""
    from nerf_rs_tpu.accel import build_scene_grid, suggest_capacities

    # Overflow only exists in the compaction modes — mask-only (the
    # default since round 3) evaluates densely and cannot drop samples.
    cfg = RenderConfig(n_coarse=32, n_fine=64, ray_chunk=2048,
                       accel_compact="scatter")
    grid = build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=48, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=48 * 48 * 48, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )
    cam = camera_from_golden(golden)
    key = jax.random.key(0)
    size = 48
    exact = np.asarray(render_image(lego_params["coarse"], lego_params["fine"],
                                    cam, size, size, key, cfg))

    def psnr(c):
        fast = np.asarray(render_image(lego_params["coarse"], lego_params["fine"],
                                       cam, size, size, key, c, grid=grid))
        mse = float(np.mean((exact - fast) ** 2))
        return -10.0 * np.log10(max(mse, 1e-12))

    # This scene/size overflows the default 0.25 coarse capacity (~46%
    # of samples occupied) — quality visibly degrades...
    assert psnr(cfg) < 40.0
    # ...and the geometry-derived capacities restore the contract.
    tuned = suggest_capacities(grid, cam, size, size, cfg)
    assert tuned.accel_coarse_capacity > 0.4
    assert psnr(tuned) > 40.0


def test_calibrate_capacities(lego_params, golden):
    """Measured calibration: tight capacities (especially fine, where
    termination culling bites) that still render >40 dB vs exact."""
    from nerf_rs_tpu.accel import build_scene_grid, calibrate_capacities

    cfg = RenderConfig(n_coarse=32, n_fine=64, ray_chunk=2048)
    grid = build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=48, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=48 * 48 * 48, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )
    cam = camera_from_golden(golden)
    key = jax.random.key(0)
    size = 48
    tuned = calibrate_capacities(lego_params["coarse"], lego_params["fine"],
                                 grid, cam, size, size, key, cfg)
    # Tighter than the geometry bound's fine capacity (1.0 on this scene).
    assert 0.0 < tuned.accel_coarse_capacity < 0.9
    assert 0.0 < tuned.accel_fine_capacity < 0.95

    exact = np.asarray(render_image(lego_params["coarse"], lego_params["fine"],
                                    cam, size, size, key, cfg))
    fast = np.asarray(render_image(lego_params["coarse"], lego_params["fine"],
                                   cam, size, size, key, tuned, grid=grid))
    mse = float(np.mean((exact - fast) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    assert psnr > 40.0, f"calibrated accel render deviates: {psnr:.1f} dB"


def test_occupied_aabb_and_ray_range_geometry():
    """ray_aabb_range slab test against a synthetic single-block grid:
    center rays bracket the block, side rays miss (t1 == t0), and an empty
    grid degenerates every ray."""
    from nerf_rs_tpu.accel import OccupancyGrid, occupied_aabb, ray_aabb_range

    r = 16
    occ = jnp.zeros((r, r, r), bool)
    occ = occ.at[6:10, 6:10, 6:10].set(True)   # cells 6..9 -> world [-0.5, 0.5]
    grid = OccupancyGrid(occ=occ,
                         aabb_min=jnp.full((3,), -2.0),
                         aabb_max=jnp.full((3,), 2.0))
    lo, hi = occupied_aabb(grid)
    np.testing.assert_allclose(np.asarray(lo), [-0.5] * 3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(hi), [0.5] * 3, atol=1e-6)

    origin = jnp.asarray([0.0, 0.0, -4.0])
    dirs = jnp.asarray([
        [0.0, 0.0, 1.0],    # straight through the block
        [0.0, 1.0, 0.0],    # parallel miss (runs along y at z=-4)
    ])
    t0, t1 = ray_aabb_range(grid, origin, dirs, 2.0, 6.0, pad_cells=0.0)
    t0, t1 = np.asarray(t0), np.asarray(t1)
    # Through-ray: enters at z=-0.5 (t=3.5), exits z=0.5 (t=4.5).
    np.testing.assert_allclose(t0[0, 0], 3.5, atol=1e-5)
    np.testing.assert_allclose(t1[0, 0], 4.5, atol=1e-5)
    # Miss: degenerate range inside [near, far].
    assert t1[1, 0] == t0[1, 0]

    empty = OccupancyGrid(occ=jnp.zeros((r, r, r), bool),
                          aabb_min=grid.aabb_min, aabb_max=grid.aabb_max)
    t0e, t1e = ray_aabb_range(empty, origin, dirs, 2.0, 6.0)
    assert np.all(np.asarray(t0e) == np.asarray(t1e))


def test_aabb_sampling_miss_rays_are_background(lego_params, golden):
    """Rays whose AABB range degenerates must composite to the exact white
    background — all their samples land on one culled point."""
    from nerf_rs_tpu.accel import build_scene_grid
    from nerf_rs_tpu.render import render_rays

    grid = build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=32, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=32 * 32 * 32, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64,
                       accel_sample_aabb=True)
    cam = camera_from_golden(golden)
    origin = jnp.asarray(cam.position)
    # Rays pointing AWAY from the scene (camera looks at the origin).
    away = -jnp.asarray(cam.forward)[None, :] * jnp.ones((8, 1))
    rgb = render_rays(lego_params["coarse"], lego_params["fine"], origin,
                      away, cam.near, cam.far, jax.random.key(0), cfg,
                      grid=grid)
    np.testing.assert_array_equal(np.asarray(rgb), 1.0)


def test_aabb_sampling_improves_reduced_sample_quality(lego_params, golden):
    """The point of accel_sample_aabb: at a reduced sample count, clamped
    placement should track the full-quality render at least as well as
    uniform placement (and stay a sane image in absolute terms)."""
    from nerf_rs_tpu.accel import build_scene_grid

    grid = build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=48, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=48 * 48 * 48, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )
    cam = camera_from_golden(golden)
    key = jax.random.key(3)
    full = np.asarray(render_image(
        lego_params["coarse"], lego_params["fine"], cam, 16, 16, key,
        RenderConfig(n_coarse=64, n_fine=128, ray_chunk=256)))

    def psnr_vs_full(aabb: bool) -> float:
        cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=256,
                           accel_sample_aabb=aabb)
        img = np.asarray(render_image(
            lego_params["coarse"], lego_params["fine"], cam, 16, 16, key,
            cfg, grid=grid))
        mse = float(np.mean((full - img) ** 2))
        return -10.0 * np.log10(max(mse, 1e-12))

    uniform_db = psnr_vs_full(False)
    clamped_db = psnr_vs_full(True)
    # Measured on CPU at this config: uniform ~20.1 dB, clamped ~24.1 dB —
    # the clamp concentrates 16 coarse bins on the ~2-unit occupied span.
    assert clamped_db > 22.0, f"clamped render too far off: {clamped_db:.1f} dB"
    assert clamped_db > uniform_db + 0.5, (
        f"AABB clamping should win at reduced samples: "
        f"{clamped_db:.1f} vs {uniform_db:.1f} dB")


def test_probe_range_tighter_than_box(lego_params, golden):
    """ray_occupied_range nests inside ray_aabb_range, and probe-refined
    rendering still composites misses to background."""
    from nerf_rs_tpu.accel import build_scene_grid, ray_aabb_range, ray_occupied_range
    from nerf_rs_tpu.render import render_rays

    grid = build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=32, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=32 * 32 * 32, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )
    cam = camera_from_golden(golden)
    origin = jnp.asarray(cam.position)
    fwd = jnp.asarray(cam.forward)[None, :]
    dirs = jnp.concatenate([fwd, -fwd], axis=0)   # through-ray + away-ray
    b0, b1 = ray_aabb_range(grid, origin, dirs, cam.near, cam.far)
    p0, p1 = ray_occupied_range(grid, origin, dirs, cam.near, cam.far)
    assert np.all(np.asarray(p0) >= np.asarray(b0) - 1e-5)
    assert np.all(np.asarray(p1) <= np.asarray(b1) + 1e-5)
    assert np.asarray(p1 - p0)[0, 0] > 0.5        # through-ray keeps a real span
    assert np.asarray(p1)[1, 0] == np.asarray(p0)[1, 0]   # away-ray collapses

    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64,
                       accel_sample_aabb=True, accel_aabb_probes=64)
    rgb = render_rays(lego_params["coarse"], lego_params["fine"], origin,
                      -fwd * jnp.ones((8, 1)), cam.near, cam.far,
                      jax.random.key(0), cfg, grid=grid)
    np.testing.assert_array_equal(np.asarray(rgb), 1.0)


# ---------------------------------------------------------------------------
# Mask-only culling + ray-level packing (the accel defaults).
# ---------------------------------------------------------------------------


def _lego_grid(lego_params, res=32):
    from nerf_rs_tpu.accel import build_scene_grid

    return build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=res, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=res * res * res, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )


def test_mask_only_matches_compact_at_full_capacity(lego_params, golden):
    """accel_compact='none' (dense eval + zeroed sigma) evaluates exactly
    the same culled set as the compaction forms; with ample capacity the
    images agree to float tolerance (different batch layouts only)."""
    grid = _lego_grid(lego_params)
    cam = camera_from_golden(golden)
    key = jax.random.key(3)
    base = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=128,
                        accel_coarse_capacity=1.0, accel_fine_capacity=1.0)
    mask = render_image(lego_params["coarse"], lego_params["fine"], cam,
                        16, 16, key, base.replace(accel_compact="none"),
                        grid=grid)
    compact = render_image(lego_params["coarse"], lego_params["fine"], cam,
                           16, 16, key, base.replace(accel_compact="scatter"),
                           grid=grid)
    np.testing.assert_allclose(np.asarray(mask), np.asarray(compact),
                               atol=2e-5)


def test_mask_only_is_the_default_and_holds_contract(lego_params, golden):
    """The default accel mode (no cfg overrides) is mask-only and stays
    within the 40 dB accel contract vs the exact render."""
    assert RenderConfig().accel_compact == "none"
    grid = _lego_grid(lego_params)
    cam = camera_from_golden(golden)
    key = jax.random.key(5)
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=128)
    exact = render_image(lego_params["coarse"], lego_params["fine"], cam,
                         16, 16, key, cfg)
    fast = render_image(lego_params["coarse"], lego_params["fine"], cam,
                        16, 16, key, cfg, grid=grid)
    mse = float(jnp.mean((exact - fast) ** 2))
    assert -10.0 * np.log10(max(mse, 1e-12)) > 40.0


def test_cull_rays_bitwise_matches_unpacked(lego_params, golden):
    """Ray-level packing is a pure reordering: per-ray RNG ids keep every
    surviving ray bitwise identical to the unpacked accel render, and
    culled rays composite to the same background the unpacked render
    evaluates them to."""
    grid = _lego_grid(lego_params)
    cam = camera_from_golden(golden)
    key = jax.random.key(7)
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64)
    unpacked = render_image(lego_params["coarse"], lego_params["fine"], cam,
                            24, 24, key, cfg, grid=grid)
    packed = render_image(lego_params["coarse"], lego_params["fine"], cam,
                          24, 24, key, cfg.replace(accel_cull_rays=True),
                          grid=grid)
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(unpacked))


def test_cull_rays_with_aabb_probe_placement(lego_params, golden):
    """Packing composes with probe-refined AABB sample placement (the
    culling test then uses the probe ranges too) and stays bitwise equal
    to its own unpacked render."""
    grid = _lego_grid(lego_params)
    cam = camera_from_golden(golden)
    key = jax.random.key(9)
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64,
                       accel_sample_aabb=True, accel_aabb_probes=32)
    unpacked = render_image(lego_params["coarse"], lego_params["fine"], cam,
                            24, 24, key, cfg, grid=grid)
    packed = render_image(lego_params["coarse"], lego_params["fine"], cam,
                          24, 24, key, cfg.replace(accel_cull_rays=True),
                          grid=grid)
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(unpacked))


def test_cull_rays_empty_grid_is_background(lego_params, golden):
    """A fully empty grid culls every ray: the packed render must still
    return a complete frame (pure background), not crash on a zero hit
    count."""
    grid = _lego_grid(lego_params)
    empty = OccupancyGrid(occ=jnp.zeros_like(grid.occ),
                          aabb_min=grid.aabb_min, aabb_max=grid.aabb_max)
    cam = camera_from_golden(golden)
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64,
                       accel_cull_rays=True)
    img = render_image(lego_params["coarse"], lego_params["fine"], cam,
                       16, 16, jax.random.key(0), cfg, grid=empty)
    np.testing.assert_array_equal(np.asarray(img), 1.0)


def test_cull_rays_gradients_not_needed_path_guard(lego_params, golden):
    """return_live (capacity calibration) ignores the packing flag — the
    calibration measurement keeps the dense layout it was written for."""
    grid = _lego_grid(lego_params)
    cam = camera_from_golden(golden)
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64,
                       accel_cull_rays=True, accel_compact="scatter",
                       accel_coarse_capacity=1.0, accel_fine_capacity=1.0)
    img, (live_c, live_f) = render_image(
        lego_params["coarse"], lego_params["fine"], cam, 16, 16,
        jax.random.key(1), cfg, grid=grid, return_live=True)
    assert img.shape == (16, 16, 3)
    assert int(live_c) >= 0 and int(live_f) >= 0


def test_cull_rays_full_grid_matches_unpacked(lego_params, golden):
    """All-occupied grid: every ray hits, the packed layout degenerates to
    the dense one (capped at the dense pad), and the image still matches
    the unpacked accel render bitwise — the cap/wrap-pad arithmetic is
    exercised at its boundary."""
    grid = _lego_grid(lego_params)
    full = OccupancyGrid(occ=jnp.ones_like(grid.occ),
                         aabb_min=grid.aabb_min, aabb_max=grid.aabb_max)
    cam = camera_from_golden(golden)
    key = jax.random.key(2)
    cfg = RenderConfig(n_coarse=8, n_fine=16, ray_chunk=64)
    unpacked = render_image(lego_params["coarse"], lego_params["fine"], cam,
                            24, 24, key, cfg, grid=full)
    packed = render_image(lego_params["coarse"], lego_params["fine"], cam,
                          24, 24, key, cfg.replace(accel_cull_rays=True),
                          grid=full)
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(unpacked))


def test_accel_off_hit_rays_are_bitwise_exact(lego_params, golden):
    """accel_compact='off' + ray packing: rendered (hit) rays are bitwise
    equal to the EXACT dense render — no occupancy mask touches them —
    and only packed-away background rays composite to plain white."""
    from nerf_rs_tpu.accel import ray_aabb_range
    from nerf_rs_tpu.render import render_image

    grid = _lego_grid(lego_params)
    cam = camera_from_golden(golden)
    key = jax.random.key(21)
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64)
    exact = np.asarray(render_image(lego_params["coarse"],
                                    lego_params["fine"], cam, 24, 24, key,
                                    cfg))
    off = np.asarray(render_image(
        lego_params["coarse"], lego_params["fine"], cam, 24, 24, key,
        cfg.replace(accel_compact="off", accel_cull_rays=True), grid=grid))
    from nerf_rs_tpu.ops.rays import camera_rays

    _, dirs = camera_rays(cam, 24, 24)
    t0, t1 = ray_aabb_range(grid, jnp.asarray(cam.position),
                            dirs.reshape(-1, 3), cam.near, cam.far)
    hit = np.asarray(t1 > t0).reshape(24, 24)
    np.testing.assert_array_equal(off[hit], exact[hit])
    np.testing.assert_array_equal(off[~hit], 1.0)


def test_accel_off_aabb_packed_matches_unpacked(lego_params, golden):
    """off + AABB placement: misses collapse to zero-delta ranges that
    composite to exact white even unpacked, so the packed render is
    bitwise equal to the unpacked one."""
    from nerf_rs_tpu.render import render_image

    grid = _lego_grid(lego_params)
    cam = camera_from_golden(golden)
    key = jax.random.key(23)
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64,
                       accel_compact="off", accel_sample_aabb=True,
                       accel_aabb_probes=32)
    unpacked = render_image(lego_params["coarse"], lego_params["fine"], cam,
                            24, 24, key, cfg, grid=grid)
    packed = render_image(lego_params["coarse"], lego_params["fine"], cam,
                          24, 24, key, cfg.replace(accel_cull_rays=True),
                          grid=grid)
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(unpacked))


def test_accel_off_probe_cull_without_placement_change(lego_params, golden):
    """off + probes WITHOUT accel_sample_aabb: sample placement stays the
    exact [near, far] stratification (rendered rays bitwise equal to the
    exact render) while the cull uses the probe test — more rays packed
    away than the box test, still compositing to background."""
    from nerf_rs_tpu.accel import ray_occupied_range
    from nerf_rs_tpu.ops.rays import camera_rays
    from nerf_rs_tpu.render import render_image

    grid = _lego_grid(lego_params)
    cam = camera_from_golden(golden)
    key = jax.random.key(29)
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64,
                       accel_compact="off", accel_cull_rays=True,
                       accel_aabb_probes=32)
    assert not cfg.accel_sample_aabb
    exact = np.asarray(render_image(lego_params["coarse"],
                                    lego_params["fine"], cam, 24, 24, key,
                                    RenderConfig(n_coarse=16, n_fine=32,
                                                 ray_chunk=64)))
    off = np.asarray(render_image(lego_params["coarse"],
                                  lego_params["fine"], cam, 24, 24, key,
                                  cfg, grid=grid))
    _, dirs = camera_rays(cam, 24, 24)
    p0, p1 = ray_occupied_range(grid, jnp.asarray(cam.position),
                                dirs.reshape(-1, 3), cam.near, cam.far,
                                probes=32)
    hit = np.asarray(p1 > p0).reshape(24, 24)
    np.testing.assert_array_equal(off[hit], exact[hit])
    np.testing.assert_array_equal(off[~hit], 1.0)
    # the probe cull removes strictly more rays than the box test here
    from nerf_rs_tpu.accel import ray_aabb_range

    b0, b1 = ray_aabb_range(grid, jnp.asarray(cam.position),
                            dirs.reshape(-1, 3), cam.near, cam.far)
    assert int(np.asarray(p1 > p0).sum()) <= int(np.asarray(b1 > b0).sum())


def test_strided_ray_ranges_conservative(lego_params, golden):
    """Strided probe ranges (stride-subsampled + 3x3 union-pool) must
    cover the exact per-ray ranges on smooth geometry: every exactly-hit
    ray stays hit, and the strided interval contains the exact one (to a
    probe-interval tolerance)."""
    from nerf_rs_tpu.accel import ray_occupied_range, strided_ray_ranges
    from nerf_rs_tpu.ops.rays import camera_rays

    grid = _lego_grid(lego_params)
    cam = camera_from_golden(golden)
    H = W = 48
    _, dirs = camera_rays(cam, H, W)
    o = jnp.asarray(cam.position)
    e0, e1 = ray_occupied_range(grid, o, dirs.reshape(-1, 3),
                                cam.near, cam.far, probes=64)
    s0, s1 = strided_ray_ranges(grid, o, dirs.reshape(H, W, 3),
                                cam.near, cam.far, stride=4, probes=64)
    hit_e = np.asarray(e1 > e0).reshape(-1)
    hit_s = np.asarray(s1 > s0).reshape(-1)
    assert hit_s[hit_e].all(), "strided culling dropped an exactly-hit ray"
    tol = float(cam.far - cam.near) / 16  # a few probe intervals of slack
    assert (np.asarray(s0).reshape(-1)[hit_e]
            <= np.asarray(e0).reshape(-1)[hit_e] + tol).all()
    assert (np.asarray(s1).reshape(-1)[hit_e]
            >= np.asarray(e1).reshape(-1)[hit_e] - tol).all()
    # stride=1 degenerates to the exact ranges bitwise
    x0, x1 = strided_ray_ranges(grid, o, dirs.reshape(H, W, 3),
                                cam.near, cam.far, stride=1, probes=64)
    np.testing.assert_array_equal(np.asarray(x0), np.asarray(e0))
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(e1))


def test_strided_render_holds_psnr(lego_params, golden):
    """The full strided pipeline (off + cull + probes + aabb placement,
    stride 4) stays within the accel contract vs the exact render."""
    from nerf_rs_tpu.render import render_image

    grid = _lego_grid(lego_params)
    cam = camera_from_golden(golden)
    key = jax.random.key(31)
    base = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64)
    exact = np.asarray(render_image(lego_params["coarse"],
                                    lego_params["fine"], cam, 32, 32, key,
                                    base))
    cfg = base.replace(accel_compact="off", accel_cull_rays=True,
                       accel_aabb_probes=32, accel_range_stride=4)
    img = np.asarray(render_image(lego_params["coarse"],
                                  lego_params["fine"], cam, 32, 32, key,
                                  cfg, grid=grid))
    mse = float(np.mean((exact - img) ** 2))
    assert -10.0 * np.log10(max(mse, 1e-12)) > 40.0
