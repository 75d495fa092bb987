"""nerf_rs_tpu — a differentiable NeRF framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
``elisabeth96/nerf-rs`` reference (a CPU/WASM Rust NeRF inference renderer):
hierarchical coarse/fine stratified ray sampling, sinusoidal positional
encoding, the classic 8-layer density+RGB MLP with skip connection and
view-direction conditioning, alpha-composited volumetric integration, and
PPM/PNG/RGBA image output — plus everything the reference lacks: full
differentiable training, a bf16 serving path, occupancy-grid acceleration,
and multi-device sharding via ``jax.sharding.Mesh``.

Numerical contracts (encoding scheme without a pi factor, ReLU sigma head,
``far - t`` final delta, interior-weight PDF, white-background compositing,
merge-and-sort hierarchical pass) follow the reference implementation; see
docstrings for file:line citations into /root/reference.
"""

from nerf_rs_tpu.config import ArchConfig, HashGridConfig, RenderConfig, TrainConfig
from nerf_rs_tpu.models.mlp import nerf_mlp, init_nerf_params
from nerf_rs_tpu.models.hashgrid import hashgrid_mlp, init_hashgrid_params
from nerf_rs_tpu.models.encoding import positional_encoding
from nerf_rs_tpu.io.weights import load_nerf_params, save_nerf_params
from nerf_rs_tpu.render import render_rays, render_image, render_image_aux
from nerf_rs_tpu.accel import OccupancyGrid, build_scene_grid
from nerf_rs_tpu.extract import extract_scene_mesh, save_ply

__version__ = "0.1.0"

__all__ = [
    "ArchConfig",
    "HashGridConfig",
    "RenderConfig",
    "TrainConfig",
    "nerf_mlp",
    "init_nerf_params",
    "hashgrid_mlp",
    "init_hashgrid_params",
    "positional_encoding",
    "load_nerf_params",
    "save_nerf_params",
    "render_rays",
    "render_image",
    "OccupancyGrid",
    "build_scene_grid",
    "__version__",
]
