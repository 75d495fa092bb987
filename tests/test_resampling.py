"""The hierarchical resampling chain (compute_weights -> importance_samples
-> merge_samples) against a NumPy transcription of the reference's
per-ray loops: the weight loop with its T < 1e-4 early-out
(lib.rs:250-283) and the linear CDF scan of the inverse-CDF sampler
(lib.rs:289-350), written here from the spec, one ray at a time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import RenderConfig
from nerf_rs_tpu.ops.sampling import _batched_uniform, importance_samples, merge_samples
from nerf_rs_tpu.ops.volume import compute_weights


def ref_weights(sigma, t, far, threshold):
    n = len(t)
    w = np.zeros(n)
    trans = 1.0
    for i in range(n):
        delta = max((t[i + 1] - t[i]) if i + 1 < n else (far - t[i]), 0.0)
        alpha = 1.0 - np.exp(-sigma[i] * delta)
        w[i] = trans * alpha
        trans *= 1.0 - alpha
        if trans < threshold:
            break
    return w


def ref_resample_ray(t, w, u, pdf_eps, cdf_eps):
    """lib.rs:289-350: bins at midpoints, pdf over the interior weights
    (+eps), CDF with its last entry forced to 1, and for each u the first
    bin j with cdf[j] <= u < cdf[j+1] found by a linear scan (the last bin
    when none matches); then merge with the coarse t's and sort."""
    bins = 0.5 * (t[1:] + t[:-1])
    pdf = np.maximum(w[1:-1], 0.0) + pdf_eps
    pdf = pdf / pdf.sum()
    cdf = np.concatenate([[0.0], np.cumsum(pdf)])
    cdf[-1] = 1.0
    out = []
    for ui in u:
        j = len(cdf) - 2
        for k in range(len(cdf) - 1):
            if cdf[k] <= ui < cdf[k + 1]:
                j = k
                break
        frac = (ui - cdf[j]) / max(cdf[j + 1] - cdf[j], cdf_eps)
        out.append(bins[j] + (bins[j + 1] - bins[j]) * frac)
    return np.sort(np.concatenate([t, out]))


def _inputs(n, nc, seed=0, spiky=False):
    rng = np.random.default_rng(seed)
    t = 2.0 + (np.arange(nc) + rng.uniform(size=(n, nc))) * (4.0 / nc)
    sigma = rng.uniform(0, 30.0 if spiky else 2.0, size=(n, nc))
    if spiky:
        sigma[:, (nc * 5) // 8:] = 100.0   # drives T under 1e-4
    return t.astype(np.float32), sigma.astype(np.float32)


def _chain(t, sigma, far, key, nf, cfg):
    w = compute_weights(jnp.asarray(sigma), jnp.asarray(t), far,
                        t_threshold=cfg.t_threshold)
    extra = importance_samples(key, jnp.asarray(t), w, nf,
                               pdf_eps=cfg.pdf_eps, cdf_eps=cfg.cdf_eps)
    return np.asarray(w), np.asarray(merge_samples(jnp.asarray(t), extra))


def _reference(t, sigma, far, key, nf, cfg):
    far = np.broadcast_to(np.asarray(far, np.float64).reshape(-1), (t.shape[0],))
    u = np.asarray(_batched_uniform(key, t.shape[:-1], nf, jnp.float32), np.float64)
    w = np.stack([ref_weights(sigma[i].astype(np.float64), t[i].astype(np.float64),
                              far[i], cfg.t_threshold) for i in range(t.shape[0])])
    merged = np.stack([ref_resample_ray(t[i].astype(np.float64), w[i], u[i],
                                        cfg.pdf_eps, cfg.cdf_eps)
                       for i in range(t.shape[0])])
    return w, merged


@pytest.mark.parametrize("nc,nf", [(64, 128), (32, 64)])
def test_chain_matches_reference_scan(nc, nf):
    cfg = RenderConfig()
    t, sigma = _inputs(48, nc)
    key = jax.random.key(5)
    w, got = _chain(t, sigma, jnp.float32(6.0), key, nf, cfg)
    w_ref, want = _reference(t, sigma, 6.0, key, nf, cfg)
    assert got.shape == (48, nc + nf)
    np.testing.assert_allclose(w, w_ref, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


def test_chain_spiky_early_out():
    """With the early-out active, f32 vs f64 CDF rounding can move a u
    across a bin boundary: allow a <1% tail of such flips, each within a
    bin width, and require everything else tight."""
    cfg = RenderConfig()
    t, sigma = _inputs(48, 64, seed=1, spiky=True)
    key = jax.random.key(6)
    w, got = _chain(t, sigma, jnp.float32(6.0), key, 128, cfg)
    w_ref, want = _reference(t, sigma, 6.0, key, 128, cfg)
    assert (w_ref[:, (64 * 5) // 8 + 1:] == 0).all()   # the loop broke out
    np.testing.assert_allclose(w, w_ref, atol=1e-5)
    err = np.abs(got - want)
    assert (err > 1e-4).mean() < 0.01
    assert err.max() < 4.0 / 64


def test_chain_per_ray_far():
    """Per-ray far (the AABB-clamped modes cap each ray's integration
    range): a (R, 1) far column matches the reference ray by ray."""
    cfg = RenderConfig()
    t, sigma = _inputs(32, 64, seed=4)
    far = np.random.default_rng(7).uniform(5.0, 6.0, (32, 1)).astype(np.float32)
    key = jax.random.key(8)
    w, got = _chain(t, sigma, jnp.asarray(far), key, 128, cfg)
    w_ref, want = _reference(t, sigma, far, key, 128, cfg)
    np.testing.assert_allclose(w, w_ref, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


def test_chain_empty_batch():
    cfg = RenderConfig()
    t = np.zeros((0, 64), np.float32)
    w, got = _chain(t, t, jnp.float32(6.0), jax.random.key(0), 128, cfg)
    assert w.shape == (0, 64) and got.shape == (0, 192)


def test_chain_sorted_and_in_range():
    cfg = RenderConfig()
    t, sigma = _inputs(64, 64, seed=2)
    _, got = _chain(t, sigma, jnp.float32(6.0), jax.random.key(9), 128, cfg)
    assert (np.diff(got, axis=-1) >= 0).all()
    assert (got >= 2.0 - 1e-5).all() and (got <= 6.0 + 1e-5).all()
