"""Int8 W8A8 path (models/quant.py): real-vs-fake parity, quality vs the
f32 oracle, QAT gradient flow, and render/train integration."""

import jax
import jax.numpy as jnp
import numpy as np

from nerf_rs_tpu.config import RenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden
from nerf_rs_tpu.models.mlp import nerf_mlp
from nerf_rs_tpu.models.quant import int8_nerf_mlp
from nerf_rs_tpu.render import render_image


def _pts_dirs(n=512, key=0):
    k1, k2 = jax.random.split(jax.random.key(key))
    pts = jax.random.uniform(k1, (n, 3), minval=-1.2, maxval=1.2)
    dirs = jax.random.normal(k2, (n, 3))
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, dirs


def test_real_matches_fake(lego_params):
    """The int8 inference path and the QAT STE emulation compute the SAME
    quantized arithmetic — int32 accumulate vs float multiply of the
    same integers (products < 2^24 are exact in f32)."""
    pts, dirs = _pts_dirs()
    rgb_r, sig_r = int8_nerf_mlp(lego_params["fine"], pts, dirs)
    rgb_f, sig_f = int8_nerf_mlp(lego_params["fine"], pts, dirs, fake=True)
    np.testing.assert_allclose(np.asarray(rgb_r), np.asarray(rgb_f),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(sig_r), np.asarray(sig_f),
                               atol=2e-3, rtol=1e-3)


def test_int8_tracks_oracle(lego_params):
    """W8A8 per-row PTQ on the pretrained teacher stays close to the f32
    oracle (the tools/int8_study.py bound: ~39 dB at image level)."""
    pts, dirs = _pts_dirs()
    rgb_q, sig_q = int8_nerf_mlp(lego_params["fine"], pts, dirs)
    rgb, sig = nerf_mlp(lego_params["fine"], pts, dirs)
    assert float(jnp.mean(jnp.abs(rgb_q - rgb))) < 0.03
    # sigma is unbounded; compare through the compositing-relevant range
    err = jnp.mean(jnp.abs(jnp.tanh(sig_q / 50) - jnp.tanh(sig / 50)))
    assert float(err) < 0.03


def test_qat_gradients_flow(lego_params):
    """STE: d(loss)/d(weights) through the fake-quant forward is finite
    and nonzero for every layer."""
    pts, dirs = _pts_dirs(128)

    def loss(p):
        rgb, sig = int8_nerf_mlp(p, pts, dirs, fake=True)
        return jnp.mean(rgb ** 2) + jnp.mean(jnp.minimum(sig, 10.0) ** 2) * 1e-3

    grads = jax.grad(loss)(lego_params["fine"])
    for name, g in grads.items():
        gk = np.asarray(g["kernel"])
        assert np.isfinite(gk).all(), name
        assert np.abs(gk).max() > 0, name


def test_render_image_int8(lego_params, golden):
    """End-to-end render with impl='int8' stays recognizably the same
    image as the exact path."""
    cam = camera_from_golden(golden)
    key = jax.random.key(0)
    base = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024)
    exact = render_image(lego_params["coarse"], lego_params["fine"], cam,
                         32, 32, key, base.replace(impl="xla"))
    q = render_image(lego_params["coarse"], lego_params["fine"], cam,
                     32, 32, key, base.replace(impl="int8"))
    mse = float(jnp.mean((exact - q) ** 2))
    psnr = -10 * np.log10(max(mse, 1e-12))
    assert psnr > 25.0, psnr


def test_train_step_int8qat():
    """A QAT distill step (impl='int8qat') runs under jit and produces
    finite loss + nonzero grads on a small student."""
    from nerf_rs_tpu.config import ArchConfig, TrainConfig
    from nerf_rs_tpu.parallel.train_sharded import (
        create_sharded_train_state, sharded_train_step)

    cfg = TrainConfig(
        batch_rays=64,
        arch=ArchConfig(width=64, v_width=32, depth=4, skip_at=2),
        render=RenderConfig(n_coarse=8, n_fine=16, ray_chunk=64,
                            impl="int8qat"),
    )
    mesh, state = create_sharded_train_state(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    batch = {
        "origins": jnp.tile(jnp.asarray([[0.0, -4.0, 1.0]], jnp.float32), (64, 1)),
        "dirs": jnp.asarray(dirs),
        "rgb": jnp.asarray(rng.uniform(size=(64, 3)).astype(np.float32)),
        "near": jnp.float32(2.0),
        "far": jnp.float32(6.0),
    }
    # sharded_train_step donates the state, so don't hold aliases across
    # calls — verify movement through the loss trajectory instead.
    state, m1 = sharded_train_step(mesh, state, batch, jax.random.key(1), cfg)
    l1 = float(m1["loss"])
    state, m2 = sharded_train_step(mesh, state, batch, jax.random.key(1), cfg)
    l2 = float(m2["loss"])
    assert np.isfinite(l1) and np.isfinite(l2)
    assert l1 != l2, "params did not move under the QAT forward"
