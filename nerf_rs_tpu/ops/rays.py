"""Pinhole camera and vectorized ray generation.

The reference computes one ray at a time (Camera::get_ray_dir,
/root/reference/src/lib.rs:214-230) with scalar Vec3 math; here the whole
pixel grid is generated as one array program:

    f = normalize(dir); r = normalize(f x up); u = normalize(r x f)
    x = ((j + 0.5)/nx)*2 - 1;  y = 1 - ((i + 0.5)/ny)*2      (NDC, y-up)
    d = r*(x*tan(alpha_w)) + u*(y*tan(alpha_h)) + f

Directions are normalized by the renderer (lib.rs:371), matching the
reference where points and view dirs both use the normalized dir
(lib.rs:371,396-400).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Camera(NamedTuple):
    """Pinhole camera (reference struct at lib.rs:197-211, minus the render
    params that live in RenderConfig here)."""

    position: jnp.ndarray      # (3,)
    forward: jnp.ndarray       # (3,) need not be unit; normalized on use
    up: jnp.ndarray            # (3,)
    alpha_width: jnp.ndarray   # () FOV half-angle, atan(0.5*w/focal)
    alpha_height: jnp.ndarray  # ()
    near: jnp.ndarray          # ()
    far: jnp.ndarray           # ()


def _normalize(v: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


def camera_basis(cam: Camera) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Orthonormal (forward, right, true-up) basis (lib.rs:216-218)."""
    f = _normalize(cam.forward)
    r = _normalize(jnp.cross(f, cam.up))
    u = _normalize(jnp.cross(r, f))
    return f, r, u


def ray_directions(cam: Camera, height: int, width: int) -> jnp.ndarray:
    """Unnormalized ray directions for every pixel center -> (H, W, 3).

    Row i is image row (top to bottom), column j left to right — the same
    (i * nx + j) pixel order the reference scatters into (lib.rs:368-371).
    """
    f, r, u = camera_basis(cam)
    j = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0   # (W,)
    i = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0  # (H,)
    sx = jnp.tan(cam.alpha_width)
    sy = jnp.tan(cam.alpha_height)
    x = j[None, :, None] * sx  # (1, W, 1)
    y = i[:, None, None] * sy  # (H, 1, 1)
    return x * r + y * u + f  # (H, W, 3)


@functools.partial(jax.jit, static_argnums=(1, 2))
def camera_rays(cam: Camera, height: int, width: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(origins (H, W, 3), unit directions (H, W, 3)) for the full image.

    Jitted (h/w static) so a full frame's ray generation is ONE device
    program — and so every caller (single-device, sharded,
    multihost, accel calibration) sees bitwise-identical directions: an
    eager copy can fuse/round differently from a jitted one, which would
    break the bitwise chunk/shard-invariance contracts."""
    dirs = _normalize(ray_directions(cam, height, width))
    origins = jnp.broadcast_to(cam.position, dirs.shape)
    return origins, dirs


def orbit_camera(cam: Camera, angle, target=(0.0, 0.0, 0.0)) -> Camera:
    """Rigidly rotate the camera by ``angle`` radians about the world
    z-axis through ``target`` (default: the scene origin, the lego
    bundle's center) — the turntable/novel-view sweep the reference has
    no tooling for. angle=0 returns the camera unchanged (exactly:
    R is the identity)."""
    a = jnp.asarray(angle, jnp.float32)
    c, s = jnp.cos(a), jnp.sin(a)
    rot = jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                    jnp.float32)
    t = jnp.asarray(target, jnp.float32)

    def rotate(v):
        # HIGHEST: an f32 matmul may otherwise run in TF32 on the GPU.
        return jnp.dot(rot, jnp.asarray(v, jnp.float32),
                       precision=jax.lax.Precision.HIGHEST)

    return cam._replace(
        position=rotate(jnp.asarray(cam.position, jnp.float32) - t) + t,
        forward=rotate(cam.forward),
        up=rotate(cam.up),
    )
