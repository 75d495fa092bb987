"""Hash-grid model family (models/hashgrid.py — Instant-NGP encoding).

Property tests, CPU-fast (tiny tables): interpolation exactness at grid
corners, linearity between them, hash-path index validity, encode/forward
contracts shared with the canonical MLP family, gradient flow into the
tables, and end-to-end render/train integration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import HashGridConfig, RenderConfig, TrainConfig
from nerf_rs_tpu.models.hashgrid import (
    hash_encode,
    hashgrid_mlp,
    init_hashgrid_params,
    is_hashgrid_params,
    level_resolutions,
    sh_encoding,
)

TINY = HashGridConfig(levels=4, table_log2=12, res_min=4, res_max=32,
                      width=16, geo_features=7, color_width=16, aabb=(-1.0, 1.0))


def test_level_resolutions_geometric():
    res = level_resolutions(TINY)
    assert res == (4, 8, 16, 32)
    assert level_resolutions(TINY.replace(levels=1)) == (4,)


def test_sh_encoding_shapes_and_constant():
    dirs = jax.random.normal(jax.random.key(0), (5, 3))
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    for deg in (1, 2, 3, 4):
        sh = sh_encoding(dirs, deg)
        assert sh.shape == (5, deg**2)
    # l=0 component is the constant basis function.
    np.testing.assert_allclose(sh_encoding(dirs, 4)[:, 0], 0.28209479, rtol=1e-6)
    with pytest.raises(ValueError):
        sh_encoding(dirs, 5)


def test_interpolation_exact_at_corners():
    """A dense level's encoding at grid corners returns the raw table rows
    (trilinear weights collapse to one corner)."""
    cfg = TINY.replace(levels=1, res_min=4, res_max=4)
    n = 4
    tables = jax.random.normal(jax.random.key(1), (1, 1 << cfg.table_log2, 2))
    ij = np.array([[0, 0, 0], [1, 2, 3], [4, 4, 4], [0, 4, 2]])
    lo, hi = cfg.aabb
    pts = lo + (hi - lo) * ij / n                      # world coords of corners
    enc = hash_encode(tables, jnp.asarray(pts, jnp.float32), cfg)
    want = tables[0][(ij[:, 0] * (n + 1) + ij[:, 1]) * (n + 1) + ij[:, 2]]
    np.testing.assert_allclose(np.asarray(enc), np.asarray(want), atol=1e-5)


def test_interpolation_linear_between_corners():
    """Midpoint along one axis = average of the two adjacent corners."""
    cfg = TINY.replace(levels=1, res_min=4, res_max=4)
    n = 4
    tables = jax.random.normal(jax.random.key(2), (1, 1 << cfg.table_log2, 2))
    lo, hi = cfg.aabb
    cell = (hi - lo) / n
    a = jnp.asarray([[lo + cell, lo + 2 * cell, lo + 3 * cell]])
    b = a.at[0, 0].add(cell)
    mid = (a + b) / 2
    ea, eb, em = (hash_encode(tables, p, cfg) for p in (a, b, mid))
    np.testing.assert_allclose(np.asarray(em), np.asarray((ea + eb) / 2), atol=1e-5)


def test_out_of_aabb_clamps_to_border():
    tables = jax.random.normal(jax.random.key(3), (4, 1 << TINY.table_log2, 2))
    inside_edge = jnp.asarray([[1.0, -1.0, 1.0]])      # aabb corner
    outside = jnp.asarray([[5.0, -9.0, 2.0]])
    np.testing.assert_allclose(
        np.asarray(hash_encode(tables, outside, TINY)),
        np.asarray(hash_encode(tables, inside_edge, TINY)), atol=1e-6)


def test_hash_path_used_and_in_range():
    """Finest TINY level (n=32) exceeds the 2^12 table -> spatial hash.
    The encoding must stay finite and differ across cells (collisions are
    allowed, constants are not)."""
    assert (32 + 1) ** 3 > (1 << TINY.table_log2)      # hash path is active
    tables = jax.random.normal(jax.random.key(4), (4, 1 << TINY.table_log2, 2))
    pts = jax.random.uniform(jax.random.key(5), (256, 3), minval=-1.0, maxval=1.0)
    enc = hash_encode(tables, pts, TINY)
    assert bool(jnp.isfinite(enc).all())
    assert float(jnp.std(enc[:, -2:])) > 0.0


def test_forward_contract_and_sigma_only():
    key = jax.random.key(6)
    params = init_hashgrid_params(key, TINY)
    assert is_hashgrid_params(params)
    pts = jax.random.uniform(key, (3, 7, 3), minval=-1.2, maxval=1.2)
    dirs = jax.random.normal(key, (3, 1, 3))
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb, sigma = hashgrid_mlp(params, pts, dirs, cfg=TINY)
    assert rgb.shape == (3, 7, 3) and sigma.shape == (3, 7)
    assert bool((sigma >= 0).all()) and bool(((rgb >= 0) & (rgb <= 1)).all())
    _, sigma2 = hashgrid_mlp(params, pts, dirs, cfg=TINY, sigma_only=True)
    np.testing.assert_allclose(np.asarray(sigma), np.asarray(sigma2), atol=1e-6)
    # bf16 compute stays finite and close in sigma scale
    rgb16, sigma16 = hashgrid_mlp(params, pts, dirs, cfg=TINY, dtype="bfloat16")
    assert bool(jnp.isfinite(rgb16).all()) and bool(jnp.isfinite(sigma16).all())


def test_gradients_reach_tables():
    key = jax.random.key(7)
    params = init_hashgrid_params(key, TINY)
    pts = jax.random.uniform(key, (32, 3), minval=-0.9, maxval=0.9)
    dirs = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (32, 1))

    def loss(p):
        rgb, sigma = hashgrid_mlp(p, pts, dirs, cfg=TINY)
        return jnp.sum(rgb) + jnp.sum(sigma)

    g = jax.grad(loss)(params)
    assert float(jnp.abs(g["hash_tables"]).max()) > 0.0
    for name in ("sigma0", "sigma1", "color0", "color1", "color2"):
        assert float(jnp.abs(g[name]["kernel"]).max()) > 0.0


def _unit(key, n):
    d = jax.random.normal(key, (n, 3))
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def test_render_rays_hashgrid_model():
    key = jax.random.key(8)
    params = init_hashgrid_params(key, TINY)
    cfg = RenderConfig(n_coarse=8, n_fine=16, model="hashgrid", hash=TINY,
                       ray_chunk=64)
    from nerf_rs_tpu.render import get_mlp_fn, render_rays

    dirs = _unit(key, 16)
    rgb = render_rays(params, params, jnp.zeros(3), dirs, 2.0, 6.0, key, cfg)
    assert rgb.shape == (16, 3) and bool(jnp.isfinite(rgb).all())
    with pytest.raises(ValueError):
        get_mlp_fn(cfg.replace(model="nope"))


def test_render_rays_hashgrid_with_occupancy_grid():
    """The compaction (accel) path serves this family unchanged: an
    everything-occupied grid must reproduce the dense render exactly
    (capacity covers all samples)."""
    from nerf_rs_tpu.accel import OccupancyGrid
    from nerf_rs_tpu.render import render_rays

    key = jax.random.key(9)
    params = init_hashgrid_params(key, TINY)
    cfg = RenderConfig(n_coarse=8, n_fine=16, model="hashgrid", hash=TINY,
                       accel_coarse_capacity=2.0, accel_fine_capacity=2.0,
                       accel_t_threshold=0.0)
    grid = OccupancyGrid(occ=jnp.ones((8, 8, 8), bool),
                         aabb_min=jnp.full((3,), -8.0),
                         aabb_max=jnp.full((3,), 8.0))
    dirs = _unit(key, 8)
    ids = jnp.arange(8, dtype=jnp.int32)
    dense = render_rays(params, params, jnp.zeros(3), dirs, 2.0, 6.0, key, cfg,
                        ray_ids=ids)
    accel = render_rays(params, params, jnp.zeros(3), dirs, 2.0, 6.0, key, cfg,
                        ray_ids=ids, grid=grid)
    np.testing.assert_allclose(np.asarray(accel), np.asarray(dense), atol=1e-5)


def test_training_shared_network_reduces_loss():
    from nerf_rs_tpu import train as T

    key = jax.random.key(10)
    cfg = RenderConfig(n_coarse=8, n_fine=16, model="hashgrid", hash=TINY,
                       ray_chunk=64)
    tc = TrainConfig(render=cfg, adam_eps=1e-15, lr_init=1e-2, lr_final=1e-2,
                     batch_rays=32)
    state = T.create_train_state(key, tc)
    assert set(state.params) == {"shared"}               # one network, both passes
    dirs = _unit(key, 32)
    batch = {"origins": jnp.zeros(3), "dirs": dirs,
             "rgb": jnp.full((32, 3), 0.3), "near": 2.0, "far": 6.0}
    first = last = None
    for i in range(8):
        state, metrics = T.train_step(state, batch, jax.random.fold_in(key, i), tc)
        first = first if first is not None else float(metrics["loss"])
        last = float(metrics["loss"])
    assert last < first


def test_hashgrid_sharded_render_matches_single_device():
    """The hash family composes with shard_map: rays sharded over an
    8-device mesh render BITWISE identically to the single-device path
    (gathers from the replicated tables stay device-local)."""
    from nerf_rs_tpu.ops.rays import Camera
    from nerf_rs_tpu.parallel.mesh import make_mesh
    from nerf_rs_tpu.parallel.render_sharded import render_image_sharded
    from nerf_rs_tpu.render import render_image

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    params = init_hashgrid_params(jax.random.key(11), TINY)
    cfg = RenderConfig(n_coarse=8, n_fine=16, model="hashgrid", hash=TINY,
                       ray_chunk=32)
    cam = Camera(position=jnp.asarray([0.0, -4.0, 0.0]),
                 forward=jnp.asarray([0.0, 1.0, 0.0]),
                 up=jnp.asarray([0.0, 0.0, 1.0]),
                 alpha_width=jnp.float32(0.4), alpha_height=jnp.float32(0.4),
                 near=jnp.float32(2.0), far=jnp.float32(6.0))
    key = jax.random.key(3)
    single = render_image(params, params, cam, 16, 16, key, cfg)
    mesh = make_mesh(jax.devices()[:8])
    sharded = render_image_sharded(params, params, cam, 16, 16, key, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))


def test_hashgrid_numeric_gradients():
    """check_grads on the full forward (encoding + both MLPs): the
    trilinear/hash gather chain must be numerically differentiable."""
    from jax.test_util import check_grads

    key = jax.random.key(12)
    params = init_hashgrid_params(key, TINY)
    # The paper's +-1e-4 table init parks every ReLU preactivation at the
    # kink, where finite differences are meaningless — scale the tables to
    # O(0.3) and bias the hidden layers off zero so the check probes the
    # smooth regions the analytic gradient is defined on.
    params["hash_tables"] = params["hash_tables"] * 3e3
    for name in ("sigma0", "color0", "color1"):
        params[name]["bias"] = params[name]["bias"] + 0.05
    pts = jax.random.uniform(key, (8, 3), minval=-0.8, maxval=0.8)
    dirs = jnp.tile(jnp.asarray([[0.0, 0.6, 0.8]]), (8, 1))

    def f(p):
        rgb, sigma = hashgrid_mlp(p, pts, dirs, cfg=TINY)
        return jnp.sum(rgb) + jnp.sum(jnp.log1p(sigma))

    check_grads(f, (params,), order=1, modes=["rev"], atol=2e-2, rtol=2e-2)


def test_hashgrid_single_pass_render_and_aux():
    """n_fine=0 + hashgrid: the cheapest serving config — aux path too."""
    from nerf_rs_tpu.render import render_rays

    key = jax.random.key(13)
    params = init_hashgrid_params(key, TINY)
    cfg = RenderConfig(n_coarse=16, n_fine=0, model="hashgrid", hash=TINY,
                       ray_chunk=32)
    dirs = _unit(key, 8)
    rgb, aux = render_rays(params, params, jnp.zeros(3), dirs, 2.0, 6.0,
                           key, cfg, return_aux=True)
    assert rgb.shape == (8, 3) and bool(jnp.isfinite(rgb).all())
    assert aux["depth"].shape == (8,) and aux["t_fine"].shape == (8, 16)


def test_sorted_table_gradient_matches_scatter():
    """The sorted segment-sum VJP (grad_impl='sorted') must produce
    the same table gradient as autodiff through jnp.take, to f32 cumsum
    tolerance, including heavy collisions (many points in one cell)."""
    key = jax.random.key(11)
    cfg_sc = TINY.replace(grad_impl="scatter")
    cfg_so = TINY.replace(grad_impl="sorted")
    params = init_hashgrid_params(key, TINY)
    # Cluster points so coarse levels collide heavily.
    pts = jnp.concatenate([
        jax.random.uniform(key, (64, 3), minval=-0.9, maxval=0.9),
        jax.random.uniform(jax.random.fold_in(key, 1), (64, 3),
                           minval=0.01, maxval=0.02),
    ])
    dirs = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (128, 1))

    def loss(p, cfg):
        rgb, sigma = hashgrid_mlp(p, pts, dirs, cfg=cfg)
        return jnp.sum(rgb ** 2) + jnp.sum(jnp.tanh(sigma))

    g_sc = jax.grad(loss)(params, cfg_sc)
    g_so = jax.grad(loss)(params, cfg_so)
    np.testing.assert_allclose(np.asarray(g_so["hash_tables"]),
                               np.asarray(g_sc["hash_tables"]),
                               rtol=2e-4, atol=2e-6)
    # non-table grads identical paths
    np.testing.assert_allclose(np.asarray(g_so["sigma0"]["kernel"]),
                               np.asarray(g_sc["sigma0"]["kernel"]),
                               rtol=1e-6, atol=1e-8)


def test_packed_pair_gather_matches_unpacked():
    """The bf16 F=2 speed path (one u32 gather + bit unpack) returns the
    SAME values as per-feature gathers, and its custom-VJP backward is the
    standard scatter-add (parity vs autodiff of the unpacked form)."""
    key = jax.random.key(3)
    tables = jax.random.normal(key, (TINY.levels, 1 << TINY.table_log2, 2),
                               jnp.float32)
    pts = jax.random.uniform(jax.random.key(4), (257, 3),
                             minval=-1.0, maxval=1.0)
    enc_packed = hash_encode(tables.astype(jnp.bfloat16), pts, TINY)
    # f32 tables force the per-feature path with identical values after a
    # bf16 round-trip of the tables.
    enc_cols = hash_encode(
        tables.astype(jnp.bfloat16).astype(jnp.float32), pts, TINY)
    np.testing.assert_allclose(np.asarray(enc_packed, np.float32),
                               np.asarray(enc_cols, np.float32),
                               atol=1e-2, rtol=1e-2)

    def loss_packed(t):
        return jnp.sum(hash_encode(t.astype(jnp.bfloat16), pts, TINY)
                       .astype(jnp.float32) ** 2)

    def loss_cols(t):
        return jnp.sum(hash_encode(t, pts, TINY).astype(jnp.float32) ** 2)

    g_packed = jax.grad(loss_packed)(tables)
    g_cols = jax.grad(loss_cols)(tables)
    # bf16 forward values + bf16 cotangent storage: compare loosely.
    np.testing.assert_allclose(np.asarray(g_packed), np.asarray(g_cols),
                               atol=0.15, rtol=0.1)
