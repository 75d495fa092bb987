"""The XLA MLP (models/mlp.py) on every ArchConfig member, in f32 and bf16.

Each forward is checked against a float64 NumPy transcription of the
reference network (network.rs:197-237) written here from the spec, and the
precision each matmul asks for is read off the jaxpr: f32 layers must ask
for HIGHEST (the GPU may otherwise run f32 matmuls in TF32), bf16 layers
must take bf16 operands with f32 accumulation and keep the positional
encoding in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import ArchConfig, RenderConfig
from nerf_rs_tpu.models.mlp import init_nerf_params, nerf_mlp
from nerf_rs_tpu.render import get_mlp_fn

STUDENT = ArchConfig(width=128, v_width=64)
NO_SKIP = ArchConfig(width=128, v_width=64, depth=4, skip_at=3)
DEEP = ArchConfig(width=64, v_width=32, depth=6, skip_at=2)


def np_encoding(x, n):
    out = [x]
    for i in range(n):
        out += [np.sin(2.0 ** i * x), np.cos(2.0 ** i * x)]
    return np.concatenate(out, axis=-1)


def np_mlp(params, pts, dirs):
    """float64 forward: trunk with the skip concat wherever a layer's input
    is the running width plus the encoding, ReLU sigma, bottleneck ||
    encoded dirs, ReLU view layer, sigmoid rgb."""
    p = {k: {n: np.asarray(v, np.float64) for n, v in layer.items()}
         for k, layer in params.items()}
    h0 = np_encoding(np.asarray(pts, np.float64), 10)
    h = h0
    i = 0
    while f"dense{i}" in p:
        w = p[f"dense{i}"]["kernel"]
        if i > 0 and w.shape[0] == h.shape[-1] + h0.shape[-1]:
            h = np.concatenate([h0, h], axis=-1)
        h = np.maximum(h @ w + p[f"dense{i}"]["bias"], 0.0)
        i += 1
    sigma = np.maximum(h @ p["alpha"]["kernel"] + p["alpha"]["bias"], 0.0)[..., 0]
    b = h @ p["bottleneck"]["kernel"] + p["bottleneck"]["bias"]
    d = np.broadcast_to(np_encoding(np.asarray(dirs, np.float64), 4),
                        (*b.shape[:-1], 27))
    hv = np.maximum(np.concatenate([b, d], -1) @ p["viewdirs"]["kernel"]
                    + p["viewdirs"]["bias"], 0.0)
    rgb = 1.0 / (1.0 + np.exp(-(hv @ p["rgb"]["kernel"] + p["rgb"]["bias"])))
    return rgb, sigma


def _inputs(n=96, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return jnp.asarray(pts), jnp.asarray(dirs)


@pytest.mark.parametrize("arch", [ArchConfig(), STUDENT, NO_SKIP, DEEP],
                         ids=["canonical", "student", "no_skip", "deep"])
def test_f32_matches_numpy_reference(arch):
    params = init_nerf_params(jax.random.key(3), arch=arch)
    pts, dirs = _inputs()
    rgb, sigma = nerf_mlp(params, pts, dirs)
    rgb_r, sigma_r = np_mlp(params, pts, dirs)
    np.testing.assert_allclose(np.asarray(rgb), rgb_r, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sigma), sigma_r, atol=1e-4, rtol=1e-5)


def test_random_archs_match_numpy_reference():
    """Property sweep over random family members (width, view width, depth
    and skip position), f32 and bf16."""
    rng = np.random.default_rng(11)
    pts, dirs = _inputs(64, seed=1)
    for trial in range(4):
        depth = int(rng.integers(2, 9))
        arch = ArchConfig(width=int(rng.choice([32, 96, 128, 256])),
                          v_width=int(rng.choice([16, 64, 128])),
                          depth=depth, skip_at=int(rng.integers(0, depth)))
        params = init_nerf_params(jax.random.key(trial), arch=arch)
        rgb_r, sigma_r = np_mlp(params, pts, dirs)
        rgb, sigma = nerf_mlp(params, pts, dirs)
        np.testing.assert_allclose(np.asarray(rgb), rgb_r, atol=1e-5,
                                   err_msg=str(arch))
        np.testing.assert_allclose(np.asarray(sigma), sigma_r, atol=1e-4,
                                   rtol=1e-5, err_msg=str(arch))
        rgb, sigma = nerf_mlp(params, pts, dirs, dtype="bfloat16")
        np.testing.assert_allclose(np.asarray(rgb), rgb_r, atol=3e-2,
                                   err_msg=str(arch))


def test_bf16_lego_close_to_reference(lego_params):
    """bf16 operands with f32 accumulation on the pretrained lego fine
    network: f32 outputs, within bf16 operand rounding of the reference."""
    pts, dirs = _inputs(256, seed=2)
    rgb, sigma = nerf_mlp(lego_params["fine"], pts, dirs, dtype="bfloat16")
    assert rgb.dtype == jnp.float32 and sigma.dtype == jnp.float32
    rgb_r, sigma_r = np_mlp(lego_params["fine"], pts, dirs)
    np.testing.assert_allclose(np.asarray(rgb), rgb_r, atol=2e-2)
    np.testing.assert_allclose(np.asarray(sigma), sigma_r, atol=0.5, rtol=3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sigma_only_matches_full(dtype):
    params = init_nerf_params(jax.random.key(0))
    pts, dirs = _inputs()
    rgb_s, sig_s = nerf_mlp(params, pts, dirs, sigma_only=True, dtype=dtype)
    _, sig_f = nerf_mlp(params, pts, dirs, dtype=dtype)
    np.testing.assert_array_equal(np.asarray(sig_s), np.asarray(sig_f))
    np.testing.assert_array_equal(np.asarray(rgb_s), 0.0)
    assert rgb_s.shape == (pts.shape[0], 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_shapes_broadcast_viewdirs(dtype):
    """Arbitrary leading shapes, one view direction per ray broadcast over
    its samples — equal to the flat evaluation."""
    params = init_nerf_params(jax.random.key(1))
    pts, dirs = _inputs(60)
    pts3 = pts.reshape(5, 12, 3)
    dirs3 = dirs.reshape(5, 12, 3)[:, :1, :]
    rgb_b, sig_b = nerf_mlp(params, pts3, dirs3, dtype=dtype)
    assert rgb_b.shape == (5, 12, 3) and sig_b.shape == (5, 12)
    rgb_f, sig_f = nerf_mlp(params, pts, jnp.repeat(dirs3, 12, 1).reshape(60, 3),
                            dtype=dtype)
    np.testing.assert_allclose(np.asarray(rgb_b).reshape(60, 3),
                               np.asarray(rgb_f), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sig_b).reshape(60),
                               np.asarray(sig_f), atol=1e-5, rtol=1e-6)


def test_bf16_grads_close_to_f32(lego_params):
    """Gradients through the bf16 forward track the f32 ones (the bf16
    train path). bf16 operand rounding flips some ReLU gates, so trunk
    leaves differ by ~10-15% in L2; the update DIRECTION must agree:
    cosine similarity >= 0.97 for every leaf."""
    pts, dirs = _inputs(128, seed=4)

    def loss(dtype):
        def f(p):
            r, s = nerf_mlp(p, pts, dirs, dtype=dtype)
            return jnp.sum(r ** 2) + jnp.sum(jnp.log1p(s))
        return f

    g32 = jax.grad(loss("float32"))(lego_params["fine"])
    g16 = jax.grad(loss("bfloat16"))(lego_params["fine"])
    for path, a in jax.tree_util.tree_leaves_with_path(g32):
        b = g16
        for k in path:
            b = b[k.key]
        assert b.dtype == jnp.float32
        cos = float(jnp.vdot(a, b) / (jnp.linalg.norm(a) * jnp.linalg.norm(b)))
        assert cos >= 0.97, (jax.tree_util.keystr(path), cos)


def _eqns(fn, *args):
    return jax.make_jaxpr(fn)(*args).jaxpr.eqns


def test_f32_matmuls_ask_for_highest_precision():
    params = init_nerf_params(jax.random.key(0), arch=STUDENT)
    pts, dirs = _inputs(8)
    dots = [e for e in _eqns(lambda x: nerf_mlp(params, x, dirs), pts)
            if e.primitive.name == "dot_general"]
    assert len(dots) == 12
    for e in dots:
        assert all(p == jax.lax.Precision.HIGHEST for p in e.params["precision"])
        assert all(v.aval.dtype == jnp.float32 for v in e.invars)


def test_bf16_operands_f32_accumulation_f32_encoding():
    params = init_nerf_params(jax.random.key(0), arch=STUDENT)
    pts, dirs = _inputs(8)
    eqns = _eqns(lambda x: nerf_mlp(params, x, dirs, dtype="bfloat16"), pts)
    dots = [e for e in eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 12
    for e in dots:
        assert all(v.aval.dtype == jnp.bfloat16 for v in e.invars)
        assert e.params["preferred_element_type"] == jnp.float32
        assert e.outvars[0].aval.dtype == jnp.float32
    trig = [e for e in eqns if e.primitive.name in ("sin", "cos")]
    assert trig and all(e.invars[0].aval.dtype == jnp.float32 for e in trig)


def test_get_mlp_fn_resolves_impls():
    fn = get_mlp_fn(RenderConfig(dtype="bfloat16"))
    params = init_nerf_params(jax.random.key(0))
    pts, dirs = _inputs(16)
    rgb, sigma = fn(params, pts, dirs)
    want = nerf_mlp(params, pts, dirs, dtype="bfloat16")
    np.testing.assert_array_equal(np.asarray(rgb), np.asarray(want[0]))
    for impl in ("pallas", "fused"):
        with pytest.raises(ValueError, match="unknown MLP impl"):
            get_mlp_fn(RenderConfig(impl=impl))


def test_hashgrid_dense_layers_ask_for_highest_in_f32():
    """The hash-grid family's f32 dense layers ask for HIGHEST (TF32 guard;
    the card-side check is tests/test_gpu.py), bf16 ones for DEFAULT."""
    from nerf_rs_tpu.config import HashGridConfig
    from nerf_rs_tpu.models.hashgrid import hashgrid_mlp, init_hashgrid_params

    cfg = HashGridConfig(levels=2, table_log2=8, res_max=16)
    params = init_hashgrid_params(jax.random.key(0), cfg)
    pts = jnp.zeros((4, 3))
    for dtype, want in (("float32", jax.lax.Precision.HIGHEST),
                        ("bfloat16", jax.lax.Precision.DEFAULT)):
        dots = [e for e in _eqns(lambda x: hashgrid_mlp(params, x, pts, cfg=cfg,
                                                        dtype=dtype), pts)
                if e.primitive.name == "dot_general"]
        assert len(dots) == 5
        assert all(p == want for e in dots for p in e.params["precision"])


def test_orbit_rotation_asks_for_highest():
    """orbit_camera's three f32 rotations ask for HIGHEST (TF32 guard)."""
    from nerf_rs_tpu.ops.rays import Camera, orbit_camera

    cam = Camera(position=jnp.asarray([4.0, 0.0, 0.5]),
                 forward=jnp.asarray([-1.0, 0.0, 0.0]),
                 up=jnp.asarray([0.0, 0.0, 1.0]),
                 alpha_width=jnp.float32(0.6), alpha_height=jnp.float32(0.6),
                 near=jnp.float32(2.0), far=jnp.float32(6.0))
    dots = [e for e in _eqns(lambda a: orbit_camera(cam, a), 0.3)
            if e.primitive.name == "dot_general"]
    assert len(dots) == 3
    assert all(p == jax.lax.Precision.HIGHEST
               for e in dots for p in e.params["precision"])
