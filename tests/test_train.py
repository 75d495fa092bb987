"""Training-step tests: loss decreases, grads flow, sharded == single-device."""

import jax
import jax.numpy as jnp
import numpy as np

from nerf_rs_tpu.config import RenderConfig, TrainConfig
from nerf_rs_tpu.parallel.mesh import make_mesh
from nerf_rs_tpu.parallel.train_sharded import (
    create_sharded_train_state,
    shard_batch,
    sharded_train_step,
)
from nerf_rs_tpu.train import create_train_state, nerf_loss, train_step

TINY = TrainConfig(batch_rays=64, render=RenderConfig(n_coarse=8, n_fine=8, ray_chunk=64))


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {
        "origins": jnp.zeros((n, 3), jnp.float32),
        "dirs": jnp.asarray(dirs),
        "rgb": jnp.asarray(rng.uniform(size=(n, 3)).astype(np.float32)),
        "near": jnp.float32(2.0),
        "far": jnp.float32(6.0),
    }


def test_loss_finite_and_grads_nonzero():
    state = create_train_state(jax.random.key(0), TINY)
    batch = _batch(TINY.batch_rays)
    loss, metrics = nerf_loss(state.params, batch, jax.random.key(1), TINY)
    assert np.isfinite(float(loss))
    grads = jax.grad(lambda p: nerf_loss(p, batch, jax.random.key(1), TINY)[0])(state.params)
    norms = [float(jnp.linalg.norm(g)) for g in jax.tree_util.tree_leaves(grads)]
    assert all(np.isfinite(n) for n in norms)
    assert sum(norms) > 0.0


def test_training_reduces_loss():
    state = create_train_state(jax.random.key(0), TINY)
    batch = _batch(TINY.batch_rays)
    first = None
    for i in range(20):
        state, metrics = train_step(state, batch, jax.random.key(42), TINY)
        if first is None:
            first = float(metrics["loss"])
    last = float(metrics["loss"])
    assert last < first, f"loss did not decrease: {first} -> {last}"


def test_sharded_step_matches_single_device():
    """Data-parallel step over the 8-device CPU mesh == single-device step."""
    mesh = make_mesh()
    assert mesh.devices.size == 8, "conftest should force 8 virtual CPU devices"
    batch = _batch(TINY.batch_rays)

    state1 = create_train_state(jax.random.key(0), TINY)
    state1, m1 = train_step(state1, batch, jax.random.key(1), TINY)

    _, state8 = create_sharded_train_state(jax.random.key(0), TINY, mesh)
    state8, m8 = sharded_train_step(mesh, state8, batch, jax.random.key(1), TINY)

    np.testing.assert_allclose(float(m1["loss"]), float(m8["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(state1.params),
                    jax.tree_util.tree_leaves(state8.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_shard_batch_layout():
    mesh = make_mesh()
    batch = shard_batch(mesh, _batch(64))
    assert batch["dirs"].sharding.is_fully_replicated is False
    assert batch["near"].sharding.is_fully_replicated is True


def test_train_step_with_full_grid_matches_dense():
    """An all-occupied grid with capacity 1.0 and termination culling off
    is compaction-as-identity: the accelerated train step must reproduce
    the dense step (values and updated params) to float tolerance."""
    from nerf_rs_tpu.accel import OccupancyGrid

    cfg = TINY.replace(render=TINY.render.replace(
        accel_coarse_capacity=1.0, accel_fine_capacity=1.0,
        accel_t_threshold=0.0))
    grid = OccupancyGrid(
        occ=jnp.ones((8, 8, 8), bool),
        aabb_min=jnp.full((3,), -6.5, jnp.float32),
        aabb_max=jnp.full((3,), 6.5, jnp.float32),
    )
    batch = _batch(TINY.batch_rays)

    s_dense = create_train_state(jax.random.key(0), cfg)
    s_dense, m_dense = train_step(s_dense, batch, jax.random.key(1), cfg)
    s_accel = create_train_state(jax.random.key(0), cfg)
    s_accel, m_accel = train_step(s_accel, batch, jax.random.key(1), cfg,
                                  grid=grid)

    np.testing.assert_allclose(float(m_accel["loss"]), float(m_dense["loss"]),
                               rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(s_accel.params),
                    jax.tree_util.tree_leaves(s_dense.params)):
        # The gather/scatter backward reassociates sums at the ULP level,
        # and for near-zero-gradient elements Adam's ~lr/sqrt(v) step
        # amplifies a ULP into a visible fraction of one step. Bound the
        # bulk tightly and allow a vanishing tail within the step bound.
        diff = np.abs(np.asarray(a) - np.asarray(b))
        assert diff.max() < 2 * cfg.lr_init, diff.max()
        assert (diff > 1e-5).mean() < 1e-3


def test_sharded_step_divisibility_error():
    """The friendly error must fire before shard_batch's device_put (which
    raises its own, less helpful, divisibility error)."""
    import pytest

    mesh = make_mesh()
    _, state = create_sharded_train_state(jax.random.key(0), TINY, mesh)
    with pytest.raises(ValueError, match="does not divide"):
        sharded_train_step(mesh, state, _batch(TINY.batch_rays + 1),
                           jax.random.key(1), TINY)


def test_accel_overflow_indicator():
    """accel_overflow is 1.0 iff a pass overflowed its capacity — the
    pmean-able indicator that survives cross-device dilution."""
    from nerf_rs_tpu.accel import OccupancyGrid

    grid = OccupancyGrid(
        occ=jnp.ones((8, 8, 8), bool),
        aabb_min=jnp.full((3,), -6.5, jnp.float32),
        aabb_max=jnp.full((3,), 6.5, jnp.float32),
    )
    batch = _batch(TINY.batch_rays)
    state = create_train_state(jax.random.key(0), TINY)

    roomy = TINY.replace(render=TINY.render.replace(
        accel_coarse_capacity=1.0, accel_fine_capacity=1.0))
    _, m = nerf_loss(state.params, batch, jax.random.key(1), roomy, grid=grid)
    assert float(m["accel_overflow"]) == 0.0
    assert float(m["live_frac_coarse"]) <= 1.0

    # Capacities round up to 1024 rows, so overflow needs live > 1024:
    # 256 rays x 8 coarse = 2048 live rows vs a 1024-row capacity.
    # Overflow only exists in the compaction modes — mask-only (the
    # round-3 default) evaluates densely and cannot drop samples.
    tight = TINY.replace(render=TINY.render.replace(
        accel_coarse_capacity=0.01, accel_fine_capacity=0.01,
        accel_compact="scatter"))
    _, m = nerf_loss(state.params, _batch(256), jax.random.key(1), tight,
                     grid=grid)
    assert float(m["accel_overflow"]) == 1.0
    assert float(m["live_frac_coarse"]) > 1.0

    # ...and the same tight fractions under mask-only stay overflow-free.
    tight_mask = TINY.replace(render=TINY.render.replace(
        accel_coarse_capacity=0.01, accel_fine_capacity=0.01))
    _, m = nerf_loss(state.params, _batch(256), jax.random.key(1),
                     tight_mask, grid=grid)
    assert float(m["accel_overflow"]) == 0.0
    assert float(m["live_frac_coarse"]) <= 1.0


def test_capacities_from_occupancy():
    from nerf_rs_tpu.accel import capacities_from_occupancy

    rc = RenderConfig(n_coarse=8, n_fine=8)
    # Floored at the config defaults for tiny occupancy.
    cap_c, cap_f = capacities_from_occupancy(0.001, rc)
    assert cap_c == rc.accel_coarse_capacity
    assert cap_f >= rc.accel_fine_capacity
    # Mid occupancy: quantized to 1/8 steps, fine >= blend of coarse.
    cap_c, cap_f = capacities_from_occupancy(0.2, rc)
    assert abs(cap_c * 8 - round(cap_c * 8)) < 1e-9
    assert cap_c >= 2.2 * 0.2 and cap_f >= (cap_c * 8 + 8) / 16
    # Near-full occupancy saturates (cli train then falls back to dense).
    cap_c, _ = capacities_from_occupancy(0.6, rc)
    assert cap_c == 1.0


def test_train_step_with_teacher_grid_learns(lego_params):
    """Occupancy-culled training against the pretrained teacher's grid:
    grads flow and the loss decreases."""
    from nerf_rs_tpu.accel import build_scene_grid
    from nerf_rs_tpu.models.mlp import nerf_mlp

    grid = build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=24, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=24 ** 3, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )
    state = create_train_state(jax.random.key(0), TINY)
    batch = _batch(TINY.batch_rays)
    first = None
    for i in range(10):
        state, metrics = train_step(state, batch, jax.random.key(42), TINY,
                                    grid=grid)
        if first is None:
            first = float(metrics["loss"])
        assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["loss"]) < first, "accelerated training did not learn"


def test_placement_aware_training_grads_flow(lego_params):
    """Single-pass training under serving-preset sample placement
    (accel_sample_aabb + per-ray probe refinement, cli train --accel-aabb
    --accel-probes): samples land in each ray's occupied run, the loss is
    finite, and gradients flow — the single-pass fine-tune recipe."""
    from nerf_rs_tpu.accel import build_scene_grid
    from nerf_rs_tpu.models.mlp import nerf_mlp

    grid = build_scene_grid(
        lego_params["coarse"], lego_params["fine"],
        resolution=24, aabb=(-1.8, 1.8), sigma_threshold=0.1,
        chunk=24 ** 3, mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
    )
    cfg = TINY.replace(render=TINY.render.replace(
        n_fine=0, accel_sample_aabb=True, accel_aabb_probes=16,
        accel_compact="none"))
    state = create_train_state(jax.random.key(0), cfg)
    batch = _batch(cfg.batch_rays)
    loss, metrics = nerf_loss(state.params, batch, jax.random.key(1), cfg,
                              grid=grid)
    assert np.isfinite(float(loss))
    grads = jax.grad(lambda p: nerf_loss(p, batch, jax.random.key(1), cfg,
                                         grid=grid)[0])(state.params)
    norms = [float(jnp.linalg.norm(g))
             for g in jax.tree_util.tree_leaves(grads)]
    assert all(np.isfinite(n) for n in norms) and sum(norms) > 0.0
    # The placement really is range-clamped: a repeat WITHOUT the grid
    # must differ (uniform [near,far] placement integrates differently).
    loss_u, _ = nerf_loss(state.params, batch, jax.random.key(1), cfg)
    assert abs(float(loss) - float(loss_u)) > 0.0
