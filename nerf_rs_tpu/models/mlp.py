"""The classic NeRF density+RGB MLP, pure-JAX reference forward.

In float32 this is the framework's numerical oracle (HIGHEST-precision
matmuls); in bfloat16 it is the fast serving path. Architecture mirrors
Network::forward_batch
(/root/reference/src/network.rs:197-237):

    h0 = gamma_10(points)                        (63)
    dense0..4 + ReLU                             (63->256, 256->256 x4)
    skip: h = concat(h0, h4)                     (319)   network.rs:210-211
    dense5..7 + ReLU                             (319->256, 256->256 x2)
    sigma  = ReLU(alpha(h8))                     (1)     network.rs:216  <- ReLU, not softplus
    b      = bottleneck(h8), no activation       (256)   network.rs:218
    q      = concat(b, gamma_4(viewdirs))        (283)   network.rs:219-220
    hv     = ReLU(viewdirs_layer(q))             (128)
    rgb    = Sigmoid(rgb_layer(hv))              (3)     network.rs:222-223

Layout difference from the reference: activations are batch-major
``(..., features)`` and layers compute ``x @ kernel + bias`` —
mathematically identical to the reference's transposed GEMM over
``(features, batch)`` columns.

Reduced-precision numerics (``dtype="bfloat16"``): points and view
directions stay float32 through the positional encoding (the 2^9-frequency
band would lose its phase in bf16), only the matmul OPERANDS are cast to
the compute dtype, products accumulate in float32, and bias + activation
run in float32 before the next layer's cast. Rounding each layer's output
to bf16 instead costs ~5-8 dB of image PSNR against the f32 render
(tests/test_render.py::test_bf16_render_psnr_vs_f32).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nerf_rs_tpu.io.weights import CANONICAL_SHAPES, LAYER_NAMES
from nerf_rs_tpu.models.encoding import positional_encoding


def _dense(params, name: str, x: jnp.ndarray, dtype) -> jnp.ndarray:
    """float32 ``x @ kernel + bias`` with operands in the compute ``dtype``.

    float32 asks for HIGHEST precision: the GPU's default may run f32
    matmuls in TF32 (~3 decimal digits), which misses the 1e-2 golden
    tolerance. Reduced dtypes accumulate in float32 instead."""
    p = params[name]
    if dtype == jnp.float32:
        y = jnp.dot(x.astype(jnp.float32), p["kernel"].astype(jnp.float32),
                    precision=jax.lax.Precision.HIGHEST)
    else:
        y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype),
                    preferred_element_type=jnp.float32)
    return y + p["bias"].astype(jnp.float32)


def nerf_mlp(
    params: Dict[str, Dict[str, jnp.ndarray]],
    points: jnp.ndarray,
    viewdirs: jnp.ndarray,
    *,
    x_freqs: int = 10,
    d_freqs: int = 4,
    sigma_only: bool = False,
    dtype="float32",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate the MLP at ``points`` (..., 3) with view dirs (..., 3).

    ``viewdirs`` broadcasts against points' batch shape. Returns float32
    ``(rgb (..., 3), sigma (...,))``. With ``sigma_only`` the color branch
    is skipped and rgb is zeros (coarse pass discards colors, lib.rs:404).
    ``dtype`` is the matmul operand dtype (module docstring).
    """
    dtype = jnp.dtype(dtype)
    h0 = positional_encoding(points.astype(jnp.float32), x_freqs)
    h = h0
    # Depth and skip placement derive from the params themselves (number of
    # dense{i} entries; a layer whose input dim exceeds the running width by
    # exactly enc_dim consumes the skip concat) — one forward serves the
    # whole ArchConfig family, canonical lego included (5 + skip + 3).
    n_dense = sum(1 for k in params if k.startswith("dense"))
    enc_dim = h0.shape[-1]
    for i in range(n_dense):
        d_in = params[f"dense{i}"]["kernel"].shape[0]
        if i > 0 and d_in == h.shape[-1] + enc_dim:
            # skip: encoded input FIRST (network.rs:210-211)
            h = jnp.concatenate([h0, h], axis=-1)
        h = jax.nn.relu(_dense(params, f"dense{i}", h, dtype))

    sigma = jax.nn.relu(_dense(params, "alpha", h, dtype))[..., 0]
    if sigma_only:
        return jnp.zeros((*sigma.shape, 3), sigma.dtype), sigma

    bottleneck = _dense(params, "bottleneck", h, dtype)
    dirs_enc = positional_encoding(viewdirs.astype(jnp.float32), d_freqs)
    dirs_enc = jnp.broadcast_to(dirs_enc, (*bottleneck.shape[:-1], dirs_enc.shape[-1]))
    q = jnp.concatenate([bottleneck, dirs_enc], axis=-1)  # bottleneck FIRST (network.rs:219-220)
    hv = jax.nn.relu(_dense(params, "viewdirs", q, dtype))
    rgb = jax.nn.sigmoid(_dense(params, "rgb", hv, dtype))
    return rgb, sigma


def arch_shapes(arch=None, x_freqs: int = 10, d_freqs: int = 4) -> Dict[str, Tuple[int, int]]:
    """Layer name -> (d_in, d_out) for an :class:`ArchConfig` family member.

    The canonical default reproduces CANONICAL_SHAPES exactly
    (lego_rust/*/shapes.txt)."""
    from nerf_rs_tpu.config import ArchConfig

    arch = arch or ArchConfig()
    enc_x = 3 + 6 * x_freqs
    enc_d = 3 + 6 * d_freqs
    shapes: Dict[str, Tuple[int, int]] = {}
    d_in = enc_x
    for i in range(arch.depth):
        if i == arch.skip_at + 1:
            d_in += enc_x          # skip concat feeds this layer
        shapes[f"dense{i}"] = (d_in, arch.width)
        d_in = arch.width
    shapes["bottleneck"] = (arch.width, arch.width)
    shapes["viewdirs"] = (arch.width + enc_d, arch.v_width)
    shapes["rgb"] = (arch.v_width, 3)
    shapes["alpha"] = (arch.width, 1)
    return shapes


def init_nerf_params(key: jax.Array, dtype=jnp.float32,
                     arch=None) -> Dict[str, Dict[str, jnp.ndarray]]:
    """Random init for training from scratch (capability the reference
    lacks). Glorot-uniform kernels + zero biases, matching the original TF
    NeRF's tf.keras.layers.Dense defaults. ``arch`` picks the family
    member (default: canonical lego)."""
    shapes = arch_shapes(arch)
    params = {}
    keys = jax.random.split(key, len(shapes))
    for k, (layer, (d_in, d_out)) in zip(keys, shapes.items()):
        limit = np.sqrt(6.0 / (d_in + d_out))
        kernel = jax.random.uniform(k, (d_in, d_out), dtype, minval=-limit, maxval=limit)
        params[layer] = {"kernel": kernel, "bias": jnp.zeros((d_out,), dtype)}
    return params


def count_params(params) -> int:
    return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))
