"""Int8 quantization quality study (CPU-runnable).

Does int8 fake-quantization hold the >=40 dB accel-contract bar on the
lego teacher? This script renders the same frame with (a) f32 weights,
(b) per-channel weight-only int8, (c) weight+activation int8 (dynamic
per-tensor absmax — what a real W8A8 int8 kernel would do), and reports
PSNR vs (a). A crater here kills the idea before any speed measurement;
a pass bounds the expected quality of the real kernel.

Usage: python tools/int8_study.py [--size 64] [--samples 32,64] [--cpu]
"""

from __future__ import annotations

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax


def quantize_weights_int8(params):
    """Per-output-channel symmetric int8 fake-quant of every kernel
    (biases stay f32 — they ride the int32 accumulator in a real kernel)."""
    import jax.numpy as jnp

    def q(leaf_path, w):
        scale = jnp.max(jnp.abs(w), axis=0, keepdims=True) / 127.0
        scale = jnp.maximum(scale, 1e-12)
        return jnp.round(w / scale).clip(-127, 127) * scale

    return {
        layer: {"kernel": q(layer, p["kernel"]), "bias": p["bias"]}
        for layer, p in params.items()
    }


def fake_quant_act(x, per_row: bool = False):
    """Dynamic absmax int8 fake-quant of activations: per-tensor (the
    pessimistic bound) or per-row/sample (what a real kernel's per-tile
    scales approach)."""
    import jax.numpy as jnp

    if per_row:
        scale = jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0
    else:
        scale = jnp.max(jnp.abs(x)) / 127.0
    scale = jnp.maximum(scale, 1e-12)
    return jnp.round(x / scale).clip(-127, 127) * scale


def int8_nerf_mlp(params, points, viewdirs, *, x_freqs=10, d_freqs=4,
                  sigma_only: bool = False, per_row: bool = False):
    """The oracle forward (models/mlp.py) with int8 fake-quant on every
    matmul input AND weight — emulates a real W8A8 kernel's numerics
    (int32 accumulation is exact, so fake-quant of the operands is the
    full error model)."""
    import jax.numpy as jnp

    from nerf_rs_tpu.models.encoding import positional_encoding

    def dense(name, x):
        p = params[name]
        return fake_quant_act(x, per_row) @ p["kernel"] + p["bias"]

    h0 = positional_encoding(points, x_freqs)
    h = h0
    n_dense = sum(1 for k in params if k.startswith("dense"))
    enc = h0.shape[-1]
    for i in range(n_dense):
        d_in = params[f"dense{i}"]["kernel"].shape[0]
        if i > 0 and d_in == h.shape[-1] + enc:
            h = jnp.concatenate([h0, h], axis=-1)
        h = jax.nn.relu(dense(f"dense{i}", h))
    sigma = jax.nn.relu(dense("alpha", h))[..., 0]
    if sigma_only:
        return jnp.zeros((*sigma.shape, 3), sigma.dtype), sigma
    b = dense("bottleneck", h)
    de = positional_encoding(viewdirs, d_freqs)
    de = jnp.broadcast_to(de, (*b.shape[:-1], de.shape[-1]))
    q = jnp.concatenate([b, de], axis=-1)
    hv = jax.nn.relu(dense("viewdirs", q))
    return jax.nn.sigmoid(dense("rgb", hv)), sigma


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--samples", default="32,64")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.render import render_image

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found")
    pc = load_nerf_params(assets / "coarse")
    pf = load_nerf_params(assets / "fine")
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    nc, nf = (int(v) for v in args.samples.split(","))
    cfg = RenderConfig(n_coarse=nc, n_fine=nf, ray_chunk=args.size * args.size)
    key = jax.random.key(0)
    s = args.size

    ref = np.asarray(render_image(pc, pf, camera, s, s, key, cfg))

    def psnr(img):
        mse = float(np.mean((np.asarray(img) - ref) ** 2))
        return -10.0 * np.log10(max(mse, 1e-12))

    # (b) weight-only int8
    qc, qf = quantize_weights_int8(pc), quantize_weights_int8(pf)
    w8 = render_image(qc, qf, camera, s, s, key, cfg)
    print(f"weight-only int8 (per-out-channel): {psnr(w8):.1f} dB vs f32 "
          f"@{s}px {nc}+{nf}")

    # (c) W8A8: swap the oracle for the fake-quant forward via a cfg the
    # renderer accepts — monkey-patch get_mlp_fn's oracle for this study
    # (a study script, not a product path).
    import nerf_rs_tpu.render as R

    orig = R.get_mlp_fn

    def patched_fn(per_row):
        def patched(cfg_):
            def fn(params, pts, dirs, sigma_only=False):
                rgb, sig = int8_nerf_mlp(params, pts, dirs,
                                         x_freqs=cfg_.x_freqs,
                                         d_freqs=cfg_.d_freqs,
                                         sigma_only=sigma_only,
                                         per_row=per_row)
                return rgb.astype(np.float32), sig.astype(np.float32)
            return fn
        return patched

    for label, per_row, chunk_div in (("per-tensor acts", False, 2),
                                      ("per-row acts", True, 4)):
        R.get_mlp_fn = patched_fn(per_row)
        try:
            # A different (render-invariant) ray_chunk forces a fresh
            # trace — the same cfg would silently reuse the program
            # compiled with the UNPATCHED oracle (renders are bitwise
            # chunk-invariant, so the comparison stays valid).
            w8a8 = render_image(
                qc, qf, camera, s, s, key,
                cfg.replace(ray_chunk=max(cfg.ray_chunk // chunk_div, 1)))
        finally:
            R.get_mlp_fn = orig
        print(f"W8A8 int8 ({label}): {psnr(w8a8):.1f} dB vs f32 "
              f"@{s}px {nc}+{nf}")
    print("contract bar: 40 dB (the accel-mode PSNR contract)")


if __name__ == "__main__":
    main()
