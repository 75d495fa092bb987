"""Int8 quantization for the MLP family: W8A8 inference + QAT fake-quant.

Int8 tensor-core matmuls run at twice the bf16 rate on the H100, which
makes an int8 student a multiplicative lever on top of the ArchConfig
work-reduction axis. Measured groundwork (tools/int8_study.py, CPU
numerics, 64px 32+64 vs the f32 teacher): naive post-training W8A8 sits
AT the 40 dB contract (per-tensor activations 35.8 dB, per-row 39.4 dB) —
so the production path is quantization-aware distillation (QAT): train
the student THROUGH the quantizer with straight-through-estimator
gradients, then serve real int8.

Scheme (both modes share the same arithmetic, so QAT optimizes exactly
the numbers inference runs):

- Weights: symmetric per-OUTPUT-channel int8; scale = absmax/127 per
  column. Biases stay f32 (they add after the int32 accumulator).
- Activations: symmetric per-ROW (per-sample) dynamic int8 — the absmax
  reduce is one cheap elementwise pass per layer; per-row beats per-tensor by
  +3.6 dB in the PTQ study and needs no calibration data.
- Accumulation: int32 (``preferred_element_type``), dequantized by the
  rank-1 outer product of row and column scales.

Two RenderConfig.impl values plug this into every render/train path via
render.get_mlp_fn:

- ``impl="int8"``   — REAL W8A8 inference: int8 tensors into
  ``lax.dot_general`` (XLA lowers to an int8 GEMM). Weights are quantized
  inside the jit from the ordinary f32 param pytree — loop-invariant
  code motion hoists the (in, out)-sized quantize out of the ray-chunk
  scan, and every checkpoint/serving path keeps working unchanged.
- ``impl="int8qat"`` — QAT training forward: identical quantized VALUES
  computed in float with STE (x + stop_grad(q(x) - x)), so gradients
  flow to the underlying f32 weights. ``cli train --impl int8qat``
  distills a student that serves losslessly under ``--impl int8``.

The reference has no quantization story (f32 GEMMs only,
/root/reference/src/network.rs:89-122); this module exists for the
throughput headroom, not reference parity.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from nerf_rs_tpu.models.encoding import positional_encoding


def _ste(x: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Straight-through estimator: forward value q, identity gradient."""
    return x + jax.lax.stop_gradient(q - x)


def _weight_scale(w: jnp.ndarray) -> jnp.ndarray:
    """(1, out) symmetric per-output-channel scale."""
    return jnp.maximum(jnp.max(jnp.abs(w), axis=0, keepdims=True) / 127.0,
                       1e-12)


def _row_scale(x: jnp.ndarray) -> jnp.ndarray:
    """(..., 1) symmetric per-row (per-sample) dynamic scale."""
    return jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0,
                       1e-12)


def _qdense_real(params, name: str, x: jnp.ndarray) -> jnp.ndarray:
    """Real W8A8 dense: int8 operands -> int32 accumulate -> f32
    dequant * rank-1 scales + bias."""
    w = params[name]["kernel"].astype(jnp.float32)
    b = params[name]["bias"].astype(jnp.float32)
    sw = _weight_scale(w)                                   # (1, out)
    wq = jnp.round(w / sw).clip(-127, 127).astype(jnp.int8)
    sx = _row_scale(x)                                      # (..., 1)
    xq = jnp.round(x / sx).clip(-127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        xq, wq, (((xq.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    return acc.astype(jnp.float32) * sx * sw + b


def _qdense_fake(params, name: str, x: jnp.ndarray) -> jnp.ndarray:
    """QAT dense: the SAME quantized values in f32 math, STE gradients to
    the underlying weights/activations."""
    w = params[name]["kernel"].astype(jnp.float32)
    b = params[name]["bias"].astype(jnp.float32)
    sw = jax.lax.stop_gradient(_weight_scale(w))
    wf = _ste(w, jnp.round(w / sw).clip(-127, 127) * sw)
    sx = jax.lax.stop_gradient(_row_scale(x))
    xf = _ste(x, jnp.round(x / sx).clip(-127, 127) * sx)
    return jnp.dot(xf, wf, precision=jax.lax.Precision.HIGHEST) + b


def int8_nerf_mlp(
    params: Dict[str, Dict[str, jnp.ndarray]],
    points: jnp.ndarray,
    viewdirs: jnp.ndarray,
    *,
    x_freqs: int = 10,
    d_freqs: int = 4,
    sigma_only: bool = False,
    fake: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """models.mlp.nerf_mlp with every dense layer W8A8-quantized —
    ``fake=False`` runs real int8 matmuls (inference), ``fake=True``
    runs the float STE emulation (QAT training forward). Same contract
    and arch-inference rules as the oracle (docstring there)."""
    dense = _qdense_fake if fake else _qdense_real
    h0 = positional_encoding(points.astype(jnp.float32), x_freqs)
    h = h0
    n_dense = sum(1 for k in params if k.startswith("dense"))
    enc_dim = h0.shape[-1]
    for i in range(n_dense):
        d_in = params[f"dense{i}"]["kernel"].shape[0]
        if i > 0 and d_in == h.shape[-1] + enc_dim:
            h = jnp.concatenate([h0, h], axis=-1)
        h = jax.nn.relu(dense(params, f"dense{i}", h))

    sigma = jax.nn.relu(dense(params, "alpha", h))[..., 0]
    if sigma_only:
        return jnp.zeros((*sigma.shape, 3), sigma.dtype), sigma

    bottleneck = dense(params, "bottleneck", h)
    dirs_enc = positional_encoding(viewdirs.astype(jnp.float32), d_freqs)
    dirs_enc = jnp.broadcast_to(
        dirs_enc, (*bottleneck.shape[:-1], dirs_enc.shape[-1]))
    q = jnp.concatenate([bottleneck, dirs_enc], axis=-1)
    hv = jax.nn.relu(dense(params, "viewdirs", q))
    rgb = jax.nn.sigmoid(dense(params, "rgb", hv))
    return rgb, sigma
