"""Turntable sweep: render N novel views orbiting the lego scene.

The compiled render is reused across frames (same shapes, only camera
tensors change — zero recompiles after the first frame), which is exactly
how a device-resident interactive viewer serves a moving camera. Frames are
written as frame_000.png... ; stitch them with any tool, e.g.
`ffmpeg -i frame_%03d.png turntable.gif`.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import jax


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--outdir", default="turntable")
    ap.add_argument("--impl", default="xla", choices=["xla", "int8"])
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.image import save_png
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.ops.rays import orbit_camera
    from nerf_rs_tpu.render import render_image

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    params = {"coarse": load_nerf_params(assets / "coarse"),
              "fine": load_nerf_params(assets / "fine")}
    base = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    cfg = RenderConfig(n_coarse=32, n_fine=64, ray_chunk=args.size ** 2,
                       impl=args.impl)

    _os.makedirs(args.outdir, exist_ok=True)
    t0 = None
    for i in range(args.frames):
        cam = orbit_camera(base, 2.0 * np.pi * i / args.frames)
        img = np.asarray(render_image(params["coarse"], params["fine"], cam,
                                      args.size, args.size,
                                      jax.random.key(0), cfg))
        path = _os.path.join(args.outdir, f"frame_{i:03d}.png")
        save_png(path, img, args.size, args.size)
        if i == 0:
            t0 = time.perf_counter()  # frame 0 includes the compile
            print(f"{path} (compiled)")
        else:
            print(f"{path}")
    if args.frames > 1:
        per = (time.perf_counter() - t0) / (args.frames - 1)
        print(f"{per * 1e3:,.0f} ms/frame steady-state "
              f"({args.size}x{args.size}, {cfg.n_coarse}+{cfg.n_fine} samples)")


if __name__ == "__main__":
    main()
