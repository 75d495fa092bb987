"""Student-architecture distillation (the ArchConfig model family).

The reference ships exactly one MLP (network.rs:172-237). This framework
spans a parametric family: smaller *student* networks distilled from the
pretrained teacher cut MLP FLOPs roughly quadratically in width — the
second work-reduction axis after occupancy culling. This
example trains a small student for a few steps, evaluates its PSNR vs the
teacher on a held-out view, and shows the throughput delta of the smaller
forward.

Equivalent CLI: python -m nerf_rs_tpu train --width 128 --v-width 64
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import jax


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-rays", type=int, default=256)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--v-width", type=int, default=64)
    ap.add_argument("--eval-size", type=int, default=32)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from nerf_rs_tpu.config import ArchConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu.data import DistillationDataset
    from nerf_rs_tpu.io.golden import camera_from_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_scene_assets
    from nerf_rs_tpu.models.mlp import count_params
    from nerf_rs_tpu.render import render_image
    from nerf_rs_tpu.train import create_train_state, train_step

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    teacher, golden = load_scene_assets(assets)
    camera = camera_from_golden(golden)

    arch = ArchConfig(width=args.width, v_width=args.v_width)
    small = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=args.batch_rays,
                         impl="xla")
    cfg = TrainConfig(batch_rays=args.batch_rays, render=small, arch=arch)
    state = create_train_state(jax.random.key(0), cfg)
    print(f"student {arch}: {count_params(state.params):,} params "
          f"(teacher: {count_params(teacher):,})")

    data = DistillationDataset(teacher, cfg=small)
    t0 = None
    for step, batch in zip(range(args.steps), data.batches(cfg.batch_rays)):
        state, m = train_step(state, batch, jax.random.key(step), cfg)
        loss = float(m["loss"])
        if step == 0:
            t0 = time.perf_counter()   # skip compile
        if step % 5 == 0:
            print(f"step {step}: loss {loss:.4f} psnr {float(m['psnr']):.2f}")
    if args.steps > 1:
        rps = (args.steps - 1) * cfg.batch_rays / (time.perf_counter() - t0)
        print(f"student train throughput: {rps:,.0f} rays/s fwd+bwd")

    # Held-out view: PSNR vs the teacher's render (the golden camera is
    # never a training view — DistillationDataset samples random
    # hemisphere poses).
    key = jax.random.key(7)
    s = args.eval_size
    ref = np.asarray(render_image(teacher["coarse"], teacher["fine"],
                                  camera, s, s, key, small))
    img = np.asarray(render_image(state.params["coarse"],
                                  state.params["fine"],
                                  camera, s, s, key, small))
    mse = float(np.mean((img - ref) ** 2))
    print(f"student PSNR vs teacher @{s}px after {args.steps} steps: "
          f"{-10.0 * np.log10(max(mse, 1e-12)):.2f} dB "
          "(a real run trains tens of thousands of steps — "
          "see assets/trained/README.md)")


if __name__ == "__main__":
    main()
