"""Embedder-facing API mirroring the reference's wasm surface.

The reference exposes ``init_renderer()`` + ``render_image_rgba(width,
height)`` to JavaScript with networks cached in OnceCell statics
(/root/reference/src/lib.rs:679-726). This module is the equivalent for
Python embedders (and the HTTP viewer in serve.py): cached
networks, validated dimensions, flat RGBA u8 output with A=255.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from nerf_rs_tpu.config import RenderConfig

_lock = threading.Lock()
# Serializes device dispatch across concurrent embedder/viewer requests:
# one render in flight at a time, so concurrent frames do not contend for
# device memory (serve.py uses ThreadingHTTPServer).
_render_lock = threading.Lock()
_state: dict = {}


# "keep the current checkpoint" default for init_renderer — None must stay
# distinct (it explicitly restores the pretrained weights), or every bare
# init_renderer() from render_image_rgba would reset a checkpoint-serving
# renderer.
_KEEP = object()


def init_renderer(assets_dir: Optional[str] = None,
                  cfg: Optional[RenderConfig] = None,
                  accel: Optional[bool] = None,
                  accel_res: int = 128,
                  checkpoint=_KEEP) -> None:
    """Load and cache the coarse/fine networks and camera (idempotent).

    ``accel=True`` additionally bakes an occupancy grid
    (accel.build_scene_grid, one-time cost) and serves every frame through
    the empty-space-skipping path; capacities are calibrated per requested
    image size on first use (accel.calibrate_capacities) and cached.
    ``accel=None`` (the default) keeps the current mode on an
    already-initialized renderer; ``accel=False`` explicitly disables it.

    ``checkpoint`` serves a cli-train checkpoint (any model family) instead
    of the pretrained weights — the camera still comes from the scene
    assets. Hashgrid checkpoints resolve their hyper-parameters from the
    model.json sidecar written by train. Left unset it keeps the current
    one (like ``accel=None``); an explicit ``checkpoint=None`` restores
    the pretrained weights.
    """
    from nerf_rs_tpu.io.golden import camera_from_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_scene_assets

    with _lock:
        if checkpoint is _KEEP:
            checkpoint = _state.get("checkpoint")
        if (_state.get("ready") and assets_dir is None and cfg is None
                and checkpoint == _state.get("checkpoint")
                and (accel is None
                     or (accel == (_state.get("grid") is not None)
                         and (not accel
                              or accel_res == _state.get("accel_res"))))):
            return
        if accel is None:
            # Docstring contract: accel=None keeps the current mode — a
            # cfg-only re-init must not silently drop a baked grid.
            accel = _state.get("grid") is not None
            accel_res = _state.get("accel_res", accel_res)
        assets = assets_dir or find_lego_assets()
        if assets is None:
            raise FileNotFoundError(
                "no weight assets found; pass assets_dir or set $NERF_RS_TPU_ASSETS"
            )
        from pathlib import Path

        assets = Path(assets)
        # The grid is a pure function of (weights, resolution) — rebake
        # only when any of them changed.
        reuse_grid = (_state.get("grid") is not None
                      and _state.get("accel_res") == accel_res
                      and _state.get("assets") == assets
                      and _state.get("checkpoint") == checkpoint)
        # EVERYTHING fallible happens on locals first; _state is committed
        # in one block at the end. A failed init (bad checkpoint path,
        # missing sidecar, grid bake error) must leave the previous
        # renderer fully intact — a half-written _state would make the
        # early-return above claim the new config is being served.
        # Directory bundle or single-file .npz (cli pack) — the latter is
        # the reference's wasm weight-embedding analogue (weights.rs:1-100).
        # When a checkpoint supplies the weights, the teacher params are
        # never used — skip their device upload and keep only the camera.
        params, golden = load_scene_assets(assets,
                                           device_put=checkpoint is None)
        camera = camera_from_golden(golden)
        # Reference wasm used reduced sample counts (32, 64) for interactive
        # latency (lib.rs:604-607); here the default is the full 64+128.
        # Re-inits that only flip the accel mode keep the configured cfg.
        # The accel default is mask-only culling + ray packing; an
        # explicit cfg overrides.
        new_cfg = cfg or _state.get("cfg") or RenderConfig(
            ray_chunk=16384, accel_cull_rays=True)
        new_cfg = new_cfg.replace(model="mlp")
        if checkpoint is not None:
            import jax

            from nerf_rs_tpu.io.checkpoint import (
                hashgrid_render_config, load_model_config, restore_params,
            )

            loaded, _step = restore_params(checkpoint)
            loaded = jax.device_put(loaded)
            if "shared" in loaded:
                info = load_model_config(Path(checkpoint))
                if info is None or info.get("model") != "hashgrid":
                    raise FileNotFoundError(
                        f"{checkpoint} is a shared-network checkpoint with "
                        "no model.json sidecar next to it")
                new_cfg = hashgrid_render_config(info, new_cfg)
                params = {"coarse": loaded["shared"], "fine": loaded["shared"]}
            else:
                params = loaded
        if accel:
            if reuse_grid:
                grid = _state["grid"]
            else:
                from nerf_rs_tpu.accel import build_scene_grid, hashgrid_grid_kwargs

                grid_kw = (hashgrid_grid_kwargs(new_cfg)
                           if new_cfg.model == "hashgrid" else {})
                grid = build_scene_grid(
                    params["coarse"], params["fine"],
                    resolution=accel_res, **grid_kw,
                )
        else:
            grid = None

        # ---- commit (nothing below can fail) ----
        _state["assets"] = assets
        _state["checkpoint"] = checkpoint
        _state["params"] = params
        _state["camera"] = camera
        _state["cfg"] = new_cfg
        _state["grid"] = grid
        if accel:
            _state["accel_res"] = accel_res
        else:
            _state.pop("accel_res", None)
        _state["size_cfgs"] = {}
        _state["ready"] = True


def render_image_rgba(width: int, height: int, seed: int = 0) -> np.ndarray:
    """Render and return a flat (H*W*4,) u8 RGBA buffer (A=255), matching the
    reference's JS-facing contract (lib.rs:702-726)."""
    import jax

    from nerf_rs_tpu.io.image import pixels_to_rgba
    from nerf_rs_tpu.render import render_image

    if width <= 0 or height <= 0:
        raise ValueError("width and height must be greater than zero")
    init_renderer()
    # Snapshot the whole renderer state in ONE critical section so a
    # concurrent init_renderer (e.g. flipping accel mode) cannot pair a
    # stale grid with a new cfg/size_cfgs. size_cfgs is keyed per (state
    # generation implicit in the dict object identity): a re-init replaces
    # the dict, so calibrations never leak across grids.
    with _lock:
        base_cfg = cfg = _state["cfg"]
        grid = _state["grid"]
        params = _state["params"]
        camera = _state["camera"]
        size_cfgs = _state["size_cfgs"]
    if grid is not None and base_cfg.accel_compact not in ("none", "off"):
        # Compaction modes need per-size capacity calibration; mask-only
        # (the default) has no capacities — serve base_cfg directly.
        with _lock:
            cfg = size_cfgs.get((width, height))
        if cfg is None:
            from nerf_rs_tpu.accel import calibrate_capacities

            with _render_lock:
                cfg = calibrate_capacities(
                    params["coarse"], params["fine"],
                    grid, camera, height, width,
                    jax.random.key(0), base_cfg,
                )
            with _lock:
                size_cfgs[(width, height)] = cfg
    with _render_lock:
        img = render_image(
            params["coarse"], params["fine"], camera,
            height, width, jax.random.key(seed), cfg, grid=grid,
        )
        out = np.asarray(img)
    return pixels_to_rgba(out)
