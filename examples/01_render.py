"""Render the pretrained lego scene to a PNG (and optionally PPM).

The minimal end-to-end path: weights -> camera -> render_image -> file.
Equivalent of the reference's native CLI run (lib.rs:647-677), with
`--dtype bfloat16` selecting bf16 matmul operands (f32 accumulation).
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import jax


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default="lego.png")
    ap.add_argument("--ppm", default=None, help="also write a PPM here")
    ap.add_argument("--impl", default="xla", choices=["xla", "int8"])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.image import save_png, save_ppm
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.render import render_image

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    cfg = RenderConfig(impl=args.impl, dtype=args.dtype, ray_chunk=8192)

    img = render_image(
        load_nerf_params(assets / "coarse"), load_nerf_params(assets / "fine"),
        camera, args.size, args.size, jax.random.key(0), cfg,
    )
    img = np.asarray(img)
    save_png(args.out, img, args.size, args.size)
    print(f"wrote {args.out} ({args.size}x{args.size}, impl={args.impl})")
    if args.ppm:
        save_ppm(args.ppm, img, args.size, args.size)
        print(f"wrote {args.ppm}")


if __name__ == "__main__":
    main()
