"""Single-pass serving: the fastest preset of the vendored artifacts.

The reference renders every frame hierarchically — a coarse pass, an
importance resample, and a fine pass over the merged samples
(lib.rs:353-472). This framework additionally serves a SINGLE-PASS
preset: a student fine-tuned so that 64 probe-placed samples integrate
the scene in one MLP sweep (no resample, no second network pass):

  1. an occupancy grid built from the student's own field,
  2. per-ray sample ranges refined to each ray's occupied run
     (stride-subsampled probes, conservatively pooled),
  3. background rays culled before any MLP work,
  4. one bf16 MLP pass over 64 samples/ray.

The vendored artifact is assets/trained/student128_sp29 — fine-tuned with
the placement-aware recipe (cli train --teacher-samples 64,128
--accel-aabb --accel-probes 128 --accel-pad 4). Its speed and quality on
the H100 are in PERF.md (chip_smoke.py measures both).

Equivalent CLI:
  python -m nerf_rs_tpu render --weights assets/trained/student128_sp29 \
      --coarse-samples 64 --fine-samples 0 \
      --accel --accel-aabb --accel-probes 128 --accel-cull-rays
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--accel-res", type=int, default=64)
    ap.add_argument("-o", "--output", default="single_pass.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from nerf_rs_tpu.accel import build_scene_grid
    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.image import save_png
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.render import render_image

    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    student = _os.path.join(repo, "assets", "trained", "student128_sp29")
    if not _os.path.isdir(student):
        print(f"vendored single-pass student not found at {student}")
        return
    pc = load_nerf_params(_os.path.join(student, "coarse"))
    pf = load_nerf_params(_os.path.join(student, "fine"))
    camera = camera_from_golden(
        load_golden(find_lego_assets() / "tf_reference_samples.json"))

    # The grid comes from the student's own field — serving needs no
    # access to the teacher at all.
    grid = build_scene_grid(pc, pf, resolution=args.accel_res)
    occ = float(np.asarray(grid.occ).mean())
    print(f"occupancy grid {args.accel_res}^3: {occ:.1%} occupied")

    cfg = RenderConfig(
        n_coarse=args.samples, n_fine=0,            # single pass
        dtype="bfloat16" if not args.cpu else "float32",
        ray_chunk=min(16384, args.size * args.size),
        accel_compact="off",                        # placement/cull only
        accel_sample_aabb=True, accel_aabb_probes=128,
        accel_range_stride=4, accel_cull_rays=True,
    )
    key = jax.random.key(0)
    img = render_image(pc, pf, camera, args.size, args.size, key, cfg,
                       grid=grid)
    jax.block_until_ready(img)   # compile + first frame
    t0 = time.perf_counter()
    img = jax.block_until_ready(render_image(
        pc, pf, camera, args.size, args.size, jax.random.fold_in(key, 1), cfg,
        grid=grid))
    dt = time.perf_counter() - t0
    arr = np.asarray(img)
    rays = args.size * args.size
    print(f"{args.size}x{args.size} single-pass {args.samples} samples: "
          f"{dt * 1e3:.0f} ms -> {rays / dt / 1e3:.0f} K rays/s")
    save_png(args.output, arr, args.size, args.size)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
