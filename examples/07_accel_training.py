"""Occupancy-culled (NerfAcc-style) training.

Distills from the pretrained teacher with the occupancy grid culling MLP
evaluations inside the differentiable render: culled samples scatter back
with zero weight and zero gradient, so each step evaluates only the
samples near geometry. In a real run the grid is rebuilt from the student
as it trains (`python -m nerf_rs_tpu train --accel-every N`); here we use
the teacher's grid to show the step-level API and the throughput delta.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import jax


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-rays", type=int, default=256)
    ap.add_argument("--resolution", type=int, default=48)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from nerf_rs_tpu.accel import build_scene_grid
    from nerf_rs_tpu.config import RenderConfig, TrainConfig
    from nerf_rs_tpu.data import DistillationDataset
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.train import create_train_state, train_step

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    teacher = {"coarse": load_nerf_params(assets / "coarse"),
               "fine": load_nerf_params(assets / "fine")}

    grid = build_scene_grid(teacher["coarse"], teacher["fine"],
                            resolution=args.resolution,
                            aabb=(-1.8, 1.8), sigma_threshold=0.1)
    occ = float(np.asarray(grid.occ).mean())
    print(f"teacher grid: {args.resolution}^3, {occ:.1%} occupied")

    small = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=args.batch_rays)
    cfg = TrainConfig(batch_rays=args.batch_rays, render=small)
    data = DistillationDataset(teacher, cfg=small)

    def run(steps, grid):
        # train_step donates its state buffers — each run needs its own.
        s, t0 = create_train_state(jax.random.key(0), cfg), None
        for step, batch in zip(range(steps), data.batches(cfg.batch_rays)):
            s, m = train_step(s, batch, jax.random.key(step), cfg, grid=grid)
            float(m["loss"])                      # force completion
            if step == 0:
                t0 = time.perf_counter()          # skip compile
        dt = time.perf_counter() - t0
        return m, (steps - 1) * cfg.batch_rays / dt

    m, dense_rps = run(args.steps, None)
    print(f"dense: {dense_rps:,.0f} rays/s fwd+bwd, "
          f"loss {float(m['loss']):.4f}")
    m, accel_rps = run(args.steps, grid)
    print(f"accel: {accel_rps:,.0f} rays/s fwd+bwd, "
          f"loss {float(m['loss']):.4f}, compaction load "
          f"{float(m['live_frac_coarse']):.2f}/{float(m['live_frac_fine']):.2f}")
    print(f"speedup: {accel_rps / dense_rps:.2f}x")


if __name__ == "__main__":
    main()
