"""End-to-end render tests: small lego frames on CPU, checked for sanity and
against a downsample of the reference's committed output.ppm (perceptual
anchor — the reference's thread_rng renders are not bitwise reproducible,
SURVEY.md §7 "Hard parts")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import RenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden
from nerf_rs_tpu.io.image import load_ppm
from nerf_rs_tpu.ops.rays import camera_rays
from nerf_rs_tpu.render import render_image, render_rays

SMALL_CFG = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024)


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float32) - np.asarray(b, np.float32)) ** 2)
    return -10.0 * np.log10(max(mse, 1e-10))


def test_camera_matches_golden_ray(golden):
    """Pixel (200,200) of the 400x400 golden camera reproduces the example
    ray direction (the JSON's examples carry ray_d per pixel)."""
    cam = camera_from_golden(golden)
    _, dirs = camera_rays(cam, 400, 400)
    for ex in golden["examples"]:
        i, j = ex["pixel"]
        got = np.asarray(dirs[i, j])
        want = np.asarray(ex["viewdir_unit"], np.float32)
        np.testing.assert_allclose(got, want, atol=2e-3)


def test_render_rays_shapes_and_range(lego_params, golden):
    cam = camera_from_golden(golden)
    _, dirs = camera_rays(cam, 16, 16)
    rgb, aux = render_rays(
        lego_params["coarse"], lego_params["fine"],
        jnp.asarray(cam.position), dirs.reshape(-1, 3),
        cam.near, cam.far, jax.random.key(0), SMALL_CFG, return_aux=True,
    )
    assert rgb.shape == (256, 3)
    assert np.all(np.isfinite(rgb))
    # white background + sigmoid colors => [0, 1+eps]
    assert float(jnp.min(rgb)) >= 0.0 and float(jnp.max(rgb)) <= 1.0 + 1e-4
    assert aux["rgb_coarse"].shape == (256, 3)
    assert aux["t_fine"].shape == (256, SMALL_CFG.n_coarse + SMALL_CFG.n_fine)
    # merged t's sorted
    assert np.all(np.diff(np.asarray(aux["t_fine"]), axis=-1) >= 0)


def test_render_image_vs_reference_ppm(lego_params, golden):
    """64x64 quick render vs the committed 512x512 reference render,
    box-downsampled — a coarse perceptual anchor only: output.ppm is from an
    earlier reference config with a visibly different zoom (SURVEY.md §6), so
    the bar is low (random images score ~7-8 dB, correct renders ~15+). The
    strict numerics anchor is test_golden.py."""
    ref_path = "/root/reference/output.ppm"
    import os

    if not os.path.exists(ref_path):
        pytest.skip("reference output.ppm unavailable")
    cam = camera_from_golden(golden)
    img = render_image(
        lego_params["coarse"], lego_params["fine"], cam, 64, 64,
        jax.random.key(0), SMALL_CFG,
    )
    ref = load_ppm(ref_path)  # (512, 512, 3)
    ref64 = ref.reshape(64, 8, 64, 8, 3).mean(axis=(1, 3))
    score = psnr(img, ref64)
    assert score > 14.0, f"PSNR vs reference render too low: {score:.2f} dB"


def test_render_sharded_matches_single_device(lego_params, golden):
    """Rays sharded over an 8-device mesh render BITWISE identically to the
    single-device path (global-ray-index RNG streams)."""
    from nerf_rs_tpu.parallel.mesh import make_mesh
    from nerf_rs_tpu.parallel.render_sharded import render_image_sharded

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    cam = camera_from_golden(golden)
    key = jax.random.key(3)
    single = render_image(lego_params["coarse"], lego_params["fine"], cam,
                          16, 16, key, SMALL_CFG)
    mesh = make_mesh(jax.devices()[:8])
    sharded = render_image_sharded(lego_params["coarse"], lego_params["fine"],
                                   cam, 16, 16, key, SMALL_CFG, mesh)
    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))


def test_render_chunk_invariant(lego_params, golden):
    """Per-ray RNG streams make the image independent of ray_chunk."""
    cam = camera_from_golden(golden)
    key = jax.random.key(4)
    a = render_image(lego_params["coarse"], lego_params["fine"], cam, 16, 16,
                     key, RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64))
    b = render_image(lego_params["coarse"], lego_params["fine"], cam, 16, 16,
                     key, RenderConfig(n_coarse=16, n_fine=32, ray_chunk=256))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_host_split_invariant(lego_params, golden):
    """cfg.host_chunk_rays splits a frame across several device-program
    executions; global-ray-index RNG makes the split bitwise invariant."""
    cam = camera_from_golden(golden)
    key = jax.random.key(4)
    base = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64)
    a = render_image(lego_params["coarse"], lego_params["fine"], cam, 16, 16,
                     key, base.replace(host_chunk_rays=-1))
    b = render_image(lego_params["coarse"], lego_params["fine"], cam, 16, 16,
                     key, base.replace(host_chunk_rays=64))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_host_split_invariant_culled(lego_params, golden):
    """Same invariance through the ray-culled accel path (packed rays keep
    their original image-index RNG ids)."""
    from nerf_rs_tpu.accel import build_scene_grid

    cam = camera_from_golden(golden)
    key = jax.random.key(4)
    grid = build_scene_grid(lego_params["coarse"], lego_params["fine"],
                            resolution=16)
    base = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=64,
                        accel_compact="off", accel_cull_rays=True,
                        accel_aabb_probes=16)
    a = render_image(lego_params["coarse"], lego_params["fine"], cam, 16, 16,
                     key, base.replace(host_chunk_rays=-1), grid=grid)
    b = render_image(lego_params["coarse"], lego_params["fine"], cam, 16, 16,
                     key, base.replace(host_chunk_rays=64), grid=grid)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_image_vs_committed_golden(lego_params, golden):
    """Tight image regression vs a render committed from this framework
    (f32 XLA path, fixed key): any numerics drift in camera, sampling,
    MLP, or compositing shows up here at high PSNR."""
    import os

    path = os.path.join(os.path.dirname(__file__), "goldens",
                        "lego_64x64_16c32f_key0.ppm")
    cam = camera_from_golden(golden)
    img = render_image(
        lego_params["coarse"], lego_params["fine"], cam, 64, 64,
        jax.random.key(0), RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024),
    )
    ref = load_ppm(path)
    score = psnr(img, ref)
    # u8 quantization alone caps agreement near ~50 dB; cross-backend float
    # drift costs a little more.
    assert score > 45.0, f"PSNR vs committed golden too low: {score:.2f} dB"


def test_render_strip_vs_committed_fullres_golden(lego_params, golden):
    """Pin the FULL-QUALITY committed golden (256x256, 64+128 samples, f32,
    key 0 — the analogue of the reference's committed output.ppm). A whole
    256x256 render at these sample counts costs ~12 min on CPU, so this
    renders only a 16-row center strip: per-ray RNG streams are keyed by
    global ray index, making the strip bitwise-equal to the same rows of
    the full render (chunk invariance), so the comparison is as strict as
    re-rendering everything."""
    import os

    from nerf_rs_tpu.render import _render_flat

    path = os.path.join(os.path.dirname(__file__), "goldens",
                        "lego_256x256_64c128f_key0.ppm")
    ref = load_ppm(path)
    cam = camera_from_golden(golden)
    _, dirs = camera_rays(cam, 256, 256)
    r0, r1 = 120, 136  # center rows over the bulldozer body
    strip_dirs = dirs[r0:r1].reshape(-1, 3)
    cfg = RenderConfig(n_coarse=64, n_fine=128, ray_chunk=4096)
    strip = _render_flat(
        lego_params["coarse"], lego_params["fine"], jnp.asarray(cam.position),
        strip_dirs, jnp.asarray(cam.near), jnp.asarray(cam.far),
        jax.random.key(0), strip_dirs.shape[0], cfg,
        ray_id_base=jnp.int32(r0 * 256),
    ).reshape(r1 - r0, 256, 3)
    score = psnr(strip, ref[r0:r1])
    assert score > 45.0, f"PSNR vs full-res committed golden: {score:.2f} dB"


def test_render_deterministic(lego_params, golden):
    """Counter-based keys => bitwise reproducible renders (unlike the
    reference's thread_rng)."""
    cam = camera_from_golden(golden)
    img1 = render_image(lego_params["coarse"], lego_params["fine"], cam, 16, 16,
                        jax.random.key(5), SMALL_CFG)
    img2 = render_image(lego_params["coarse"], lego_params["fine"], cam, 16, 16,
                        jax.random.key(5), SMALL_CFG)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))


def test_effective_chunk_matches_sharded_partition():
    """effective_chunk (what capacity tuning must see) equals the chunk
    _render_flat uses inside render_image_sharded, and divides
    render_image's chunk so the partitions align."""
    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.parallel.render_sharded import _round_up, effective_chunk

    # 1028/8 and 1025/8 (ray_chunk=192): n//n_dev is 128-aligned with a
    # remainder, so n_per_dev rounds up past the chunk — the sharded
    # render now passes its chunk to _render_flat explicitly, so the
    # partition is always the one the padding was computed with.
    for n, n_dev, ray_chunk in [(256 * 256, 8, 8192), (48 * 48, 8, 2048),
                                (100, 8, 8192), (800 * 800, 4, 16384),
                                (1028, 8, 8192), (1025, 8, 192),
                                (32769, 4, 12288)]:
        cfg = RenderConfig(ray_chunk=ray_chunk)
        # replicate render_image_sharded's internal math
        chunk = min(cfg.ray_chunk, _round_up(max(n // n_dev, 1), 128))
        n_per_dev = _round_up(-(-n // n_dev), chunk)
        eff = effective_chunk(n, n_dev, cfg)
        assert eff == chunk, (n, n_dev, ray_chunk, eff, chunk)
        # single-device measurement with ray_chunk=eff uses the same
        # partition (eff divides both n_per_dev and the padded total)
        assert n_per_dev % eff == 0


def test_orbit_camera(golden):
    """orbit_camera(0) is the identity (exactly), a full turn returns to
    the start, and the orbit is a rigid rotation: distance to the target
    axis and the camera basis' orthonormality are preserved."""
    from nerf_rs_tpu.io.golden import camera_from_golden
    from nerf_rs_tpu.ops.rays import camera_basis, orbit_camera

    cam = camera_from_golden(golden)
    same = orbit_camera(cam, 0.0)
    np.testing.assert_array_equal(np.asarray(same.position),
                                  np.asarray(cam.position))
    np.testing.assert_array_equal(np.asarray(same.forward),
                                  np.asarray(cam.forward))

    full = orbit_camera(cam, 2.0 * np.pi)
    np.testing.assert_allclose(np.asarray(full.position),
                               np.asarray(cam.position), atol=1e-5)

    quarter = orbit_camera(cam, np.pi / 2)
    p0, p1 = np.asarray(cam.position), np.asarray(quarter.position)
    assert abs(np.linalg.norm(p0[:2]) - np.linalg.norm(p1[:2])) < 1e-5
    assert abs(p0[2] - p1[2]) < 1e-6
    f, r, u = (np.asarray(v) for v in camera_basis(quarter))
    for a, b in [(f, r), (f, u), (r, u)]:
        assert abs(float(a @ b)) < 1e-6


def test_render_sharded_nondividing_ray_chunk(lego_params, golden):
    """Regression: a ray_chunk that does not divide the padded per-device
    shard (1025 rays / 8 devices, ray_chunk=192 -> shard 256) used to
    crash _render_flat's reshape at trace time; it must render and match
    the single-device image bitwise."""
    from nerf_rs_tpu.io.golden import camera_from_golden
    from nerf_rs_tpu.parallel.render_sharded import render_image_sharded
    from nerf_rs_tpu.render import render_image

    cam = camera_from_golden(golden)
    cfg = RenderConfig(n_coarse=4, n_fine=4, ray_chunk=192)
    key = jax.random.key(5)
    h, w = 25, 41  # 1025 rays
    img_s = render_image_sharded(lego_params["coarse"], lego_params["fine"],
                                 cam, h, w, key, cfg)
    img_1 = render_image(lego_params["coarse"], lego_params["fine"],
                         cam, h, w, key, cfg)
    np.testing.assert_array_equal(np.asarray(img_s), np.asarray(img_1))


def test_sharded_render_with_accel_aabb_matches_single(lego_params, golden):
    """The full accel stack (occupancy culling + AABB-clamped placement +
    probe-refined ranges) under shard_map must equal the single-device
    render bitwise — per-ray RNG streams and replicated grid make the
    sharding invisible."""
    from nerf_rs_tpu.accel import build_scene_grid
    from nerf_rs_tpu.io.golden import camera_from_golden
    from nerf_rs_tpu.models.mlp import nerf_mlp
    from nerf_rs_tpu.parallel.render_sharded import render_image_sharded
    from nerf_rs_tpu.render import render_image

    grid = build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=24, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=24 * 24 * 24, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )
    cam = camera_from_golden(golden)
    cfg = RenderConfig(n_coarse=8, n_fine=16, ray_chunk=64,
                       accel_sample_aabb=True, accel_aabb_probes=32,
                       accel_coarse_capacity=1.0, accel_fine_capacity=1.0)
    key = jax.random.key(9)
    img_s = render_image_sharded(lego_params["coarse"], lego_params["fine"],
                                 cam, 16, 16, key, cfg, grid=grid)
    img_1 = render_image(lego_params["coarse"], lego_params["fine"],
                         cam, 16, 16, key, cfg, grid=grid)
    np.testing.assert_array_equal(np.asarray(img_s), np.asarray(img_1))


def test_render_image_aux_depth_acc(lego_params, golden):
    """render_image_aux: rgb matches the standard render's pipeline (same
    weights, XLA chain), depth lies in [near, far] where opaque, acc in
    [0, 1], background rays have ~zero acc."""
    from nerf_rs_tpu.io.golden import camera_from_golden
    from nerf_rs_tpu.render import render_image_aux

    cam = camera_from_golden(golden)
    cfg = RenderConfig(n_coarse=8, n_fine=16, ray_chunk=64)
    rgb, depth, acc = render_image_aux(lego_params["coarse"],
                                       lego_params["fine"], cam, 16, 16,
                                       jax.random.key(0), cfg)
    rgb, depth, acc = np.asarray(rgb), np.asarray(depth), np.asarray(acc)
    assert rgb.shape == (16, 16, 3) and depth.shape == (16, 16)
    assert np.all(acc >= 0) and np.all(acc <= 1 + 1e-5)
    solid = acc > 0.5
    assert solid.any(), "expected some opaque pixels"
    assert np.all(depth[solid] >= cam.near - 1e-3)
    assert np.all(depth[solid] <= cam.far + 1e-3)
    # corners look past the object -> transparent
    assert acc[0, 0] < 0.05 and acc[-1, -1] < 0.05


def test_sharded_aux_matches_single(lego_params, golden):
    """Sharded depth/acc render == single-device bitwise (global-ray-id
    RNG + replicated params make the sharding invisible)."""
    from nerf_rs_tpu.io.golden import camera_from_golden
    from nerf_rs_tpu.parallel.render_sharded import render_image_aux_sharded
    from nerf_rs_tpu.render import render_image_aux

    cam = camera_from_golden(golden)
    cfg = RenderConfig(n_coarse=4, n_fine=8, ray_chunk=128)
    key = jax.random.key(2)
    a = render_image_aux(lego_params["coarse"], lego_params["fine"], cam,
                         16, 16, key, cfg)
    b = render_image_aux_sharded(lego_params["coarse"], lego_params["fine"],
                                 cam, 16, 16, key, cfg)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _unit_dirs(key, n):
    d = jax.random.normal(key, (n, 3))
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def test_single_pass_mode(lego_params, golden):
    """n_fine == 0: no hierarchical resampling — the render IS the coarse
    field integrated directly (the Instant-NGP regime; the reference is
    always two-pass). Must equal manual compositing of the coarse pass and
    serve the aux path."""
    from nerf_rs_tpu.models.mlp import nerf_mlp
    from nerf_rs_tpu.ops.sampling import stratified_samples
    from nerf_rs_tpu.ops.volume import composite, compute_weights

    cfg = SMALL_CFG.replace(n_fine=0)
    key = jax.random.key(5)
    dirs = _unit_dirs(jax.random.key(6), 8)
    ids = jnp.arange(8, dtype=jnp.int32)
    origin = jnp.zeros(3)
    rgb, aux = render_rays(lego_params["coarse"], lego_params["fine"],
                           origin, dirs, 2.0, 6.0, key, cfg,
                           ray_ids=ids, return_aux=True)
    # manual: same RNG stream -> same stratified t's -> same composite
    k_coarse, _ = jax.random.split(key)
    k_coarse = jax.vmap(lambda i: jax.random.fold_in(k_coarse, i))(ids)
    t_c = stratified_samples(k_coarse, 2.0, 6.0, cfg.n_coarse, (8,))
    pts = origin + dirs[:, None, :] * t_c[..., None]
    rgb_c, sigma_c = nerf_mlp(lego_params["coarse"], pts, dirs[:, None, :])
    w = compute_weights(sigma_c, t_c, 6.0, t_threshold=cfg.t_threshold)
    want = composite(rgb_c, w, white_background=True)
    np.testing.assert_allclose(np.asarray(rgb), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(aux["rgb_coarse"]), np.asarray(rgb))
    assert aux["t_fine"].shape == (8, cfg.n_coarse)


def test_single_pass_training_reduces_loss(lego_params):
    from nerf_rs_tpu.config import TrainConfig
    from nerf_rs_tpu.train import create_train_state, train_step

    cfg = TrainConfig(batch_rays=32, render=SMALL_CFG.replace(n_fine=0))
    state = create_train_state(jax.random.key(0), cfg)
    dirs = _unit_dirs(jax.random.key(1), 32)
    batch = {"origins": jnp.zeros(3), "dirs": dirs,
             "rgb": jnp.full((32, 3), 0.4), "near": 2.0, "far": 6.0}
    first = last = None
    for i in range(6):
        state, m = train_step(state, batch, jax.random.key(i), cfg)
        first = first if first is not None else float(m["loss"])
        last = float(m["loss"])
    assert last < first


def test_single_pass_accel_matches_dense(lego_params):
    """Single-pass mode through the compaction path: an everything-occupied
    grid reproduces the dense single-pass render exactly."""
    from nerf_rs_tpu.accel import OccupancyGrid

    cfg = SMALL_CFG.replace(n_fine=0, accel_coarse_capacity=2.0,
                            accel_t_threshold=0.0)
    grid = OccupancyGrid(occ=jnp.ones((8, 8, 8), bool),
                         aabb_min=jnp.full((3,), -8.0),
                         aabb_max=jnp.full((3,), 8.0))
    key = jax.random.key(9)
    dirs = _unit_dirs(jax.random.key(2), 8)
    ids = jnp.arange(8, dtype=jnp.int32)
    dense = render_rays(lego_params["coarse"], lego_params["fine"],
                        jnp.zeros(3), dirs, 2.0, 6.0, key, cfg, ray_ids=ids)
    accel = render_rays(lego_params["coarse"], lego_params["fine"],
                        jnp.zeros(3), dirs, 2.0, 6.0, key, cfg, ray_ids=ids,
                        grid=grid)
    np.testing.assert_allclose(np.asarray(accel), np.asarray(dense), atol=1e-5)


def test_sharded_culled_render_matches_single(lego_params, golden):
    """Ray-level packing under shard_map (accel_cull_rays): each device
    renders only its share of the packed hit rays, yet the frame is
    bitwise equal to the single-device render — packing, sharding, and
    chunking are all RNG-invariant reorderings."""
    from nerf_rs_tpu.accel import build_scene_grid
    from nerf_rs_tpu.io.golden import camera_from_golden
    from nerf_rs_tpu.models.mlp import nerf_mlp
    from nerf_rs_tpu.parallel.render_sharded import render_image_sharded
    from nerf_rs_tpu.render import render_image

    grid = build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=24, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=24 * 24 * 24, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )
    cam = camera_from_golden(golden)
    cfg = RenderConfig(n_coarse=8, n_fine=16, ray_chunk=64,
                       accel_cull_rays=True)
    key = jax.random.key(13)
    img_s = render_image_sharded(lego_params["coarse"], lego_params["fine"],
                                 cam, 24, 24, key, cfg, grid=grid)
    img_1 = render_image(lego_params["coarse"], lego_params["fine"],
                         cam, 24, 24, key, cfg, grid=grid)
    np.testing.assert_array_equal(np.asarray(img_s), np.asarray(img_1))
    # ...and both equal the unpacked dense-layout render.
    plain = render_image(lego_params["coarse"], lego_params["fine"],
                         cam, 24, 24, key, cfg.replace(accel_cull_rays=False),
                         grid=grid)
    np.testing.assert_array_equal(np.asarray(img_1), np.asarray(plain))


def test_bf16_render_psnr_vs_f32(lego_params, golden):
    """bf16 operands with f32 accumulation, f32 encoding and f32
    bias+ReLU (models/mlp.py) keep the bf16 frame >= 47 dB from the f32
    frame at 48x48, 32+64 samples, key 0. (Casting points to bf16 before
    the 2^9-frequency encoding, and rounding each layer's output to bf16,
    measured 39.5 dB here.)"""
    cam = camera_from_golden(golden)
    cfg = RenderConfig(n_coarse=32, n_fine=64, ray_chunk=2304)
    key = jax.random.key(0)
    f32 = np.asarray(render_image(lego_params["coarse"], lego_params["fine"],
                                  cam, 48, 48, key, cfg))
    bf16 = np.asarray(render_image(lego_params["coarse"], lego_params["fine"],
                                   cam, 48, 48, key,
                                   cfg.replace(dtype="bfloat16")))
    mse = float(np.mean((f32.astype(np.float64) - bf16) ** 2))
    assert -10.0 * np.log10(mse) >= 47.0


def test_host_chunk_zero_is_unsplit_for_every_family():
    """host_chunk_rays=0 renders each frame as one device program for both
    model families; a positive cap splits on ray_chunk multiples."""
    from nerf_rs_tpu.render import _host_group

    for model in ("mlp", "hashgrid"):
        cfg = RenderConfig(model=model, ray_chunk=4096)
        assert _host_group(cfg, 4096, 640000) == 640000
        assert _host_group(cfg.replace(host_chunk_rays=10000), 4096, 640000) == 8192
        assert _host_group(cfg.replace(host_chunk_rays=100), 4096, 640000) == 4096
