"""Occupancy-grid tightness study: sigma_threshold vs culling power vs PSNR.

Motivation: the default conservative grid (sigma_threshold=0.01 +
dilation) marks ~44% of the lego volume occupied, so the occupied-AABB
slab test passes for ~93% of the bench camera's rays and ray packing
culls little. The grid's tightness, not the packing machinery, is the
knob. This study measures, per threshold, on CPU (hardware-independent
numerics):

- occupied volume fraction and the per-ray culling power it buys
  (AABB-hit fraction, probe-hit fraction, mean probe span), and
- image PSNR of the packed accel_compact="off" render vs the exact one
  (the bench's accel_psnr_db guard) at the golden camera.

Speed needs a run on the GPU (bench.py with NERF_BENCH_ACCEL_THRESH);
this decides which thresholds are even quality-eligible.

Usage: JAX_PLATFORMS=cpu python tools/grid_threshold_study.py [--size 64]
"""

from __future__ import annotations

import argparse
import math
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--samples", default="16,32")
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--thresholds", default="0.01,0.5,2,5,10,20,50")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")

    from nerf_rs_tpu.accel import (
        build_scene_grid,
        ray_aabb_range,
        ray_occupied_range,
    )
    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.models.mlp import nerf_mlp
    from nerf_rs_tpu.ops.rays import camera_rays
    from nerf_rs_tpu.render import render_image

    assets = find_lego_assets()
    pc = load_nerf_params(assets / "coarse")
    pf = load_nerf_params(assets / "fine")
    cam = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    nc, nf = (int(v) for v in args.samples.split(","))
    cfg = RenderConfig(n_coarse=nc, n_fine=nf, ray_chunk=4096,
                       accel_compact="off", accel_cull_rays=True)
    key = jax.random.key(0)
    S = args.size
    exact = np.asarray(render_image(pc, pf, cam, S, S, key, cfg))

    _, dirs = camera_rays(cam, 200, 200)
    d = dirs.reshape(-1, 3)
    o = jnp.asarray(cam.position)

    print(f"| thresh | occ% | aabb-hit% | probe-hit% | probe-span% "
          f"| psnr (off) | psnr (off+aabb+probe) |")
    print("|---|---|---|---|---|---|---|")
    for thr in (float(t) for t in args.thresholds.split(",")):
        grid = build_scene_grid(
            pc, pf, resolution=args.resolution, aabb=(-1.8, 1.8),
            sigma_threshold=thr, chunk=args.resolution ** 3,
            mlp_fn=lambda p, x, dd: nerf_mlp(p, x, dd),
        )
        occ = float(jnp.mean(grid.occ.astype(jnp.float32)))
        t0, t1 = ray_aabb_range(grid, o, d, cam.near, cam.far)
        hit_box = float(jnp.mean((t1 > t0).astype(jnp.float32)))
        p0, p1 = ray_occupied_range(grid, o, d, cam.near, cam.far, probes=128)
        hits = (p1 > p0)
        hit_pr = float(jnp.mean(hits.astype(jnp.float32)))
        span = float(jnp.sum(jnp.where(hits, (p1 - p0), 0.0))
                     / (jnp.sum(hits) * (cam.far - cam.near)))

        def psnr(c):
            img = np.asarray(render_image(pc, pf, cam, S, S, key, c,
                                          grid=grid))
            mse = float(np.mean((exact - img) ** 2))
            return -10.0 * math.log10(max(mse, 1e-12))

        db_off = psnr(cfg)
        db_aabb = psnr(cfg.replace(accel_sample_aabb=True,
                                   accel_aabb_probes=128))
        print(f"| {thr:g} | {100*occ:.1f} | {100*hit_box:.1f} | "
              f"{100*hit_pr:.1f} | {100*span:.1f} | {db_off:.1f} | "
              f"{db_aabb:.1f} |", flush=True)


if __name__ == "__main__":
    main()
