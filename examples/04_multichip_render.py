"""Sharded render over a device mesh == single-device render, bitwise.

The reference scales with rayon threads on one host (lib.rs:474-565); here
rays are data-parallel over a `jax.sharding.Mesh` via `shard_map`, and the
per-ray counter-based RNG makes the result bitwise identical no matter how
rays are sharded. On CPU this runs with 8 virtual devices; on a multi-GPU
host the same code spans the cards.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os

# Must be set before jax initializes to get virtual CPU devices.
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import argparse

import jax


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.parallel.mesh import make_mesh
    from nerf_rs_tpu.parallel.render_sharded import render_image_sharded
    from nerf_rs_tpu.render import render_image

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    pc = load_nerf_params(assets / "coarse")
    pf = load_nerf_params(assets / "fine")
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024)
    key = jax.random.key(0)

    mesh = make_mesh()
    print(f"mesh: {mesh.devices.size} x {mesh.devices[0].platform}")
    sharded = np.asarray(render_image_sharded(
        pc, pf, camera, args.size, args.size, key, cfg, mesh=mesh))
    single = np.asarray(render_image(
        pc, pf, camera, args.size, args.size, key, cfg))
    same = np.array_equal(sharded, single)
    print(f"sharded == single-device, bitwise: {same}")
    assert same


if __name__ == "__main__":
    main()
