"""Occupancy-grid empty-space skipping (NerfAcc-style acceleration).

Bakes a conservative max-sigma voxel grid from the pretrained network
(one-time cost), then renders with empty coarse samples skipped and fine
samples past the transmittance-termination point culled. Opt-in: pass the
grid to render_*; the exact path stays the default. Reports PSNR of the
accelerated render vs the exact one.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import jax


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--resolution", type=int, default=64, help="grid voxels/axis")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from nerf_rs_tpu.accel import build_scene_grid, suggest_capacities
    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.render import render_image

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    pc = load_nerf_params(assets / "coarse")
    pf = load_nerf_params(assets / "fine")
    cfg = RenderConfig(n_coarse=32, n_fine=64, ray_chunk=2048)
    key = jax.random.key(0)

    t0 = time.perf_counter()
    # A slightly tight AABB and higher threshold keep the grid selective
    # while dilation keeps it conservative (tests/test_accel.py config).
    grid = build_scene_grid(pc, pf, resolution=args.resolution,
                            aabb=(-1.8, 1.8), sigma_threshold=0.1)
    occ = float(np.asarray(grid.occ).mean())
    print(f"grid: {args.resolution}^3 in {time.perf_counter() - t0:.1f}s, "
          f"{occ:.1%} occupied")

    exact = np.asarray(render_image(pc, pf, camera, args.size, args.size, key, cfg))

    # Default accel mode: mask-only culling — dense evaluation with
    # occupancy-zeroed sigma.
    fast = np.asarray(render_image(pc, pf, camera, args.size, args.size, key, cfg,
                                   grid=grid))
    mse = float(np.mean((exact - fast) ** 2))
    psnr = -10 * np.log10(max(mse, 1e-12))
    print(f"accelerated vs exact: {psnr:.1f} dB PSNR "
          f"(>40 dB means visually identical)")

    # Ray-level packing: background rays (about half the lego frame) are
    # composited without rendering — bitwise identical to the render above.
    packed = np.asarray(render_image(pc, pf, camera, args.size, args.size, key,
                                     cfg.replace(accel_cull_rays=True),
                                     grid=grid))
    print(f"ray-culled render bitwise equal: {bool((packed == fast).all())}")

    # The retired compaction mode, for comparison (needs capacities sized
    # to this camera so overflow cannot silently zero real samples).
    ccfg = suggest_capacities(grid, camera, args.size, args.size,
                              cfg.replace(accel_compact="scatter"))
    print(f"compaction A/B capacities: coarse {ccfg.accel_coarse_capacity:.2f}, "
          f"fine {ccfg.accel_fine_capacity:.2f}")
    compact = np.asarray(render_image(pc, pf, camera, args.size, args.size, key,
                                      ccfg, grid=grid))
    mse = float(np.mean((exact - compact) ** 2))
    print(f"compaction vs exact: {-10 * np.log10(max(mse, 1e-12)):.1f} dB PSNR")


if __name__ == "__main__":
    main()
