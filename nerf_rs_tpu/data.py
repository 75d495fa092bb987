"""Training data: NeRF-synthetic (blender) scenes and a weight-distillation
fallback.

The reference ships no dataset (inference-only); training needs one. Two
sources:

* ``BlenderDataset`` — the standard nerf_synthetic layout
  (transforms_{split}.json + PNGs), the format the lego weights were trained
  on (bmild/nerf). Camera convention: transform_matrix is camera-to-world
  with -z forward, y up; hwf from camera_angle_x.
* ``DistillationDataset`` — when no images exist (as in this environment),
  generate ground truth by rendering random viewpoints with the pretrained
  networks; lets the full training loop run end-to-end against real targets.

Both emit ray batches {origins, dirs, rgb, near, far} for train.train_step.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nerf_rs_tpu.config import RenderConfig
from nerf_rs_tpu.ops.rays import Camera, camera_rays


class BlenderDataset:
    """nerf_synthetic scene: images + per-frame cameras -> ray batches."""

    def __init__(self, root, split: str = "train", white_background: bool = True,
                 near: float = 2.0, far: float = 6.0):
        from nerf_rs_tpu.io.image import read_png

        root = Path(root)
        meta = json.loads((root / f"transforms_{split}.json").read_text())
        self.images = []
        self.cameras = []
        angle_x = float(meta["camera_angle_x"])
        for frame in meta["frames"]:
            img_path = root / (frame["file_path"] + ".png")
            if not img_path.exists():
                img_path = root / frame["file_path"]
            rgba = read_png(img_path).astype(np.float32) / 255.0
            if rgba.shape[-1] == 4:
                rgb, a = rgba[..., :3], rgba[..., 3:]
                rgb = rgb * a + (1.0 - a) if white_background else rgb * a
            else:
                rgb = rgba[..., :3]
            m = np.asarray(frame["transform_matrix"], np.float32)
            h, w = rgb.shape[:2]
            focal = 0.5 * w / np.tan(0.5 * angle_x)
            cam = Camera(
                position=m[:3, 3],
                forward=(-m[:3, 2]).astype(np.float32),   # -z is forward
                up=m[:3, 1].astype(np.float32),
                alpha_width=np.float32(np.arctan(0.5 * w / focal)),
                alpha_height=np.float32(np.arctan(0.5 * h / focal)),
                near=np.float32(near),
                far=np.float32(far),
            )
            self.images.append(rgb)
            self.cameras.append(cam)
        self.height, self.width = self.images[0].shape[:2]
        # Precompute all rays + targets as flat arrays for uniform sampling.
        # Ray directions are pure host math — pin to the CPU backend so
        # each frame's rays are not a device round-trip.
        # A pinhole camera has ONE origin per frame: store (F, 3) origins +
        # a per-ray frame index (4 B/ray) instead of a dense (N, 3) copy.
        cpu = jax.devices("cpu")[0]
        dirs, rgbs = [], []
        self.frame_origins = np.stack(
            [np.asarray(c.position, np.float32) for c in self.cameras])
        for img, cam in zip(self.images, self.cameras):
            with jax.default_device(cpu):
                _, d = camera_rays(cam, self.height, self.width)
            dirs.append(np.asarray(d).reshape(-1, 3))
            rgbs.append(img.reshape(-1, 3))
        self.dirs = np.concatenate(dirs)
        self.rgb = np.concatenate(rgbs)
        rays_per_frame = self.height * self.width
        self.frame_idx = np.repeat(
            np.arange(len(self.cameras), dtype=np.int32), rays_per_frame)
        self.images.clear()  # flattened into self.rgb; drop the extra copy
        self.near = float(near)
        self.far = float(far)

    def __len__(self):
        return self.rgb.shape[0]

    def batches(self, batch_rays: int, seed: int = 0) -> Iterator[Dict]:
        rng = np.random.default_rng(seed)
        n = len(self)
        while True:
            idx = rng.integers(0, n, size=batch_rays)
            yield {
                "origins": jnp.asarray(self.frame_origins[self.frame_idx[idx]]),
                "dirs": jnp.asarray(self.dirs[idx]),
                "rgb": jnp.asarray(self.rgb[idx]),
                "near": jnp.float32(self.near),
                "far": jnp.float32(self.far),
            }


class DistillationDataset:
    """Ray batches whose targets come from rendering the pretrained teacher
    networks at random viewpoints on a sphere around the scene — a fully
    self-contained training workload when no image dataset is present."""

    def __init__(self, teacher_params, *, radius: float = 4.03, near: float = 2.0,
                 far: float = 6.0, cfg: Optional[RenderConfig] = None, seed: int = 0):
        self.params = teacher_params
        self.radius = radius
        self.near, self.far = near, far
        self.cfg = cfg or RenderConfig(n_coarse=64, n_fine=128)
        self.seed = seed

    def batches(self, batch_rays: int, seed: int = 0) -> Iterator[Dict]:
        key = jax.random.key(self.seed + seed)
        step = 0
        near, far = jnp.float32(self.near), jnp.float32(self.far)
        while True:
            origins, dirs, rgb = _distill_batch(
                self.params, jax.random.fold_in(key, step),
                jnp.float32(self.radius), near, far, batch_rays, self.cfg,
            )
            yield {
                "origins": origins,
                "dirs": dirs,
                "rgb": jax.lax.stop_gradient(rgb),
                "near": near,
                "far": far,
            }
            step += 1


@functools.partial(jax.jit, static_argnames=("batch", "cfg"))
def _distill_batch(params, key, radius, near, far, batch: int, cfg):
    """One jitted program per batch: viewpoint sampling + the full teacher
    render. Un-jitted, every jnp primitive here would dispatch separately.

    Viewpoints: random upper-hemisphere positions looking at the origin,
    ray directions jittered within the camera FOV."""
    from nerf_rs_tpu.render import render_rays

    ko, kr = jax.random.split(key)
    k1, k2 = jax.random.split(ko)
    v = jax.random.normal(k1, (batch, 3))
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    origins = v.at[:, 2].set(jnp.abs(v[:, 2])) * radius
    to_center = -origins / jnp.linalg.norm(origins, axis=-1, keepdims=True)
    jitter = jax.random.normal(k2, (batch, 3)) * 0.18
    dirs = to_center + jitter
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb = render_rays(params["coarse"], params["fine"], origins, dirs,
                      near, far, kr, cfg)
    return origins, dirs, rgb
