"""Int8 W8A8 quantization: PTQ serving + QAT distillation (models/quant.py).

The H100's tensor cores run int8 at twice the bf16 rate; whether the XLA
int8 render path (per-layer dynamic requantize + activation round-trips
through device memory) wins end to end is not measured yet (PERF.md, Open
questions). Its value today is capability: 4x smaller serving weights and
a quantization-aware training story.

This example:
  1. renders a frame with the f32/bf16 exact path and with
     ``impl="int8"`` (post-training quantization) and reports the PSNR
     between them — the PTQ quality cost;
  2. runs a few QAT steps (``impl="int8qat"``: straight-through-estimator
     gradients through the quantizer) and shows the loss is finite and
     moving — the training loop a real int8 distill runs.

Equivalent CLI:
    python -m nerf_rs_tpu render --impl int8 -o int8.png
    python -m nerf_rs_tpu train --impl int8qat --width 128 --v-width 64
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import jax


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch-rays", type=int, default=128)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from nerf_rs_tpu.config import ArchConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.render import render_image

    assets = find_lego_assets()
    params_c = load_nerf_params(assets / "coarse")
    params_f = load_nerf_params(assets / "fine")
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    key = jax.random.key(0)
    s = args.size

    base = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024)
    exact = np.asarray(render_image(params_c, params_f, camera, s, s, key,
                                    base.replace(impl="xla")))
    quant = np.asarray(render_image(params_c, params_f, camera, s, s, key,
                                    base.replace(impl="int8")))
    mse = float(np.mean((exact - quant) ** 2))
    print(f"PTQ int8 vs f32 exact at {s}x{s}: "
          f"{-10 * np.log10(max(mse, 1e-12)):.1f} dB PSNR")

    # --- QAT: a few STE steps on a small student -------------------------
    from nerf_rs_tpu.data import DistillationDataset
    from nerf_rs_tpu.train import create_train_state, train_step

    cfg = TrainConfig(
        batch_rays=args.batch_rays, n_steps=args.steps,
        arch=ArchConfig(width=64, v_width=32, depth=4, skip_at=2),
        render=RenderConfig(n_coarse=8, n_fine=16,
                            ray_chunk=args.batch_rays, impl="int8qat"),
    )
    state = create_train_state(jax.random.key(0), cfg)
    teacher = {"coarse": params_c, "fine": params_f}
    small = RenderConfig(n_coarse=8, n_fine=16, ray_chunk=args.batch_rays)
    ds = DistillationDataset(teacher, cfg=small)
    for i, batch in zip(range(args.steps), ds.batches(cfg.batch_rays)):
        state, metrics = train_step(state, batch,
                                    jax.random.fold_in(key, i), cfg)
        print(f"QAT step {i}: loss {float(metrics['loss']):.5f} "
              f"psnr {float(metrics['psnr']):.2f}")
    print("QAT forward trains through the quantizer; a full distill "
          "serves losslessly under --impl int8.")


if __name__ == "__main__":
    main()
