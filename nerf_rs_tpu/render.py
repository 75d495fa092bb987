"""End-to-end hierarchical NeRF rendering.

The reference's per-8x8-block hot loop (render_block,
/root/reference/src/lib.rs:353-472) is redesigned as one batched array
program over a [num_rays, num_samples] grid:

    coarse stratified samples -> coarse MLP (sigmas only)
    -> transmittance weights -> inverse-CDF importance resampling
    -> merge + sort (fixed width Nc + Nf) -> fine MLP
    -> transmittance-weighted compositing onto a white background.

Everything is jit-compiled with static shapes; image rendering streams rays
through `lax.map` in fixed-size chunks to bound memory. Randomness uses
counter-based keys folded per chunk — bitwise reproducible, unlike the
reference's thread_rng.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nerf_rs_tpu.config import RenderConfig
from nerf_rs_tpu.models.mlp import nerf_mlp
from nerf_rs_tpu.ops.rays import Camera, camera_rays
from nerf_rs_tpu.ops.sampling import importance_samples, merge_samples, stratified_samples
from nerf_rs_tpu.ops.volume import composite, compute_weights


def get_mlp_fn(cfg: RenderConfig):
    """Resolve the field-network implementation: the XLA MLP
    (models/mlp.py — the f32 oracle, or bf16 operands with f32
    accumulation), its W8A8 quantized forms, or the hash-grid family
    (cfg.model == 'hashgrid'; cfg.impl only selects within the mlp
    family)."""
    if cfg.model == "hashgrid":
        from nerf_rs_tpu.models.hashgrid import hashgrid_mlp

        return functools.partial(hashgrid_mlp, cfg=cfg.hash, dtype=cfg.dtype)
    if cfg.model != "mlp":
        raise ValueError(f"unknown model {cfg.model!r} (expected 'mlp' or 'hashgrid')")
    if cfg.impl in ("int8", "int8qat"):
        # W8A8 quantized family (models/quant.py): "int8" = real int8
        # inference, "int8qat" = the float STE emulation the QAT distill
        # trains through. Weights quantize from the ordinary f32 pytree
        # inside the jit, so params/checkpoints are impl-agnostic.
        from nerf_rs_tpu.models.quant import int8_nerf_mlp

        return functools.partial(
            int8_nerf_mlp, x_freqs=cfg.x_freqs, d_freqs=cfg.d_freqs,
            fake=cfg.impl == "int8qat")
    if cfg.impl != "xla":
        raise ValueError(f"unknown MLP impl {cfg.impl!r} "
                         "(expected 'xla', 'int8', or 'int8qat')")
    return functools.partial(nerf_mlp, x_freqs=cfg.x_freqs,
                             d_freqs=cfg.d_freqs, dtype=cfg.dtype)


from nerf_rs_tpu.utils import round_up as _round_up


def _mlp_culled(mlp, params, pts, dirs_b, mask, capacity: int, sigma_only: bool,
                impl: str = "none"):
    """Evaluate the MLP at only the masked sample rows.

    impl == "none" (the default): mask-only culling — evaluate the MLP
    densely and zero sigma (and rgb) where culled. Saves no per-sample
    FLOPs and needs no capacity; the accel mode's work reduction comes
    from ray culling + AABB placement + reduced sample counts, with the
    occupancy mask supplying the exact-background semantics those rely
    on. Whether per-sample compaction pays on the GPU is not measured
    yet (PERF.md, Open questions). Culled rows contribute
    sigma = 0 — exactly what the reference's early-out assigns them — and
    zero gradient, identically to the compaction forms (minus their
    overflow loss: mask-only cannot overflow).

    impl == "scatter" | "gather": fixed-capacity compaction
    (accel.compact_apply); culled/overflowed rows get sigma = 0.
    """
    if impl == "none":
        rgb, sigma = mlp(params, pts, dirs_b, sigma_only=sigma_only)
        sigma = jnp.where(mask, sigma, 0.0)
        if rgb.ndim == mask.ndim + 1:  # sigma-only paths may return dummy rgb
            rgb = jnp.where(mask[..., None], rgb, 0.0)
        return rgb, sigma, jnp.sum(mask.astype(jnp.int32))
    from nerf_rs_tpu.accel import compact_apply

    batch = pts.shape[:-1]
    n = int(np.prod(batch))
    rows = jnp.concatenate(
        [pts.reshape(n, 3), jnp.broadcast_to(dirs_b, pts.shape).reshape(n, 3)],
        axis=-1,
    )

    def fn(buf):
        rgb, sigma = mlp(params, buf[:, :3], buf[:, 3:6], sigma_only=sigma_only)
        return rgb, sigma[:, None]

    rgb, sigma, n_live = compact_apply(fn, rows, mask.reshape(n), capacity,
                                       (jnp.float32(0), jnp.float32(0)),
                                       impl=impl)
    return rgb.reshape(*batch, 3), sigma.reshape(batch), n_live


def render_rays(
    params_coarse,
    params_fine,
    origin: jnp.ndarray,
    dirs: jnp.ndarray,
    near,
    far,
    key: jax.Array,
    cfg: RenderConfig,
    *,
    ray_ids: Optional[jnp.ndarray] = None,
    grid=None,
    return_aux: bool = False,
    return_live: bool = False,
    ray_ranges: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
):
    """Render a batch of rays.

    origin: (3,) shared camera origin (or (..., 3) per-ray origins);
    dirs: (..., 3) *unit* directions. Returns fine RGB (..., 3); with
    ``return_aux`` also a dict holding the coarse image, weights, and
    t-values (used by training and tests).

    ``ray_ids`` (flat (B,) int32, dirs must then be (B, 3)): derive one RNG
    stream per ray by folding the global ray index into ``key`` — the render
    becomes bitwise invariant to chunking and to device sharding (the
    reference's thread_rng has no such property, lib.rs:375,407).

    ``grid`` (accel.OccupancyGrid): skip MLP evaluations for samples in
    empty space and past the coarse-estimated ray termination — the
    opt-in fast mode (accel.py). Works in the differentiable path too:
    culled rows scatter back with zero weight and zero gradient
    (occupancy-culled training, train.nerf_loss / cli train
    --accel-every).

    ``return_live`` (accel only): also return (coarse_live, fine_live) —
    the TRUE number of occupied sample rows per pass for THIS batch,
    regardless of capacity. Used by accel.calibrate_capacities to measure
    what capacity the scene actually needs.
    """
    mlp = get_mlp_fn(cfg)
    batch_shape = dirs.shape[:-1]
    n_rays = int(np.prod(batch_shape)) if batch_shape else 1
    k_coarse, k_fine = jax.random.split(key)
    if ray_ids is not None:
        if dirs.ndim != 2:
            raise ValueError("ray_ids requires flat (B, 3) dirs")
        k_coarse = jax.vmap(lambda i: jax.random.fold_in(k_coarse, i))(ray_ids)
        k_fine = jax.vmap(lambda i: jax.random.fold_in(k_fine, i))(ray_ids)
    accel = grid is not None
    if return_live and grid is None:
        raise ValueError("return_live requires an occupancy grid")
    if return_live and return_aux:
        raise ValueError("return_live is incompatible with return_aux — "
                         "calibrate capacities through the inference path")

    # --- coarse pass (reference lib.rs:375-404) ---
    t_lo, t_hi = near, far
    if accel and cfg.accel_sample_aabb:
        # Clamp each ray's sample range to its occupied-AABB intersection:
        # same sample count, ~2x the sample density where matter actually
        # is (accel.ray_aabb_range). Placement-changing, so accel-gated.
        # accel_aabb_probes > 0 tightens further to the ray's own occupied
        # run (grid lookups only). ``ray_ranges`` supplies the (t_lo, t_hi)
        # precomputed at the image level instead (render_image's culled
        # path — also how strided probe ranges reach the sampler,
        # accel.strided_ray_ranges).
        from nerf_rs_tpu.accel import ray_aabb_range, ray_occupied_range

        if ray_ranges is not None:
            t_lo, t_hi = ray_ranges
        elif cfg.accel_aabb_probes > 0:
            t_lo, t_hi = ray_occupied_range(grid, origin, dirs, near, far,
                                            probes=cfg.accel_aabb_probes,
                                            pad_probes=cfg.accel_pad_probes)
        else:
            t_lo, t_hi = ray_aabb_range(grid, origin, dirs, near, far)
        # Placement is geometry (grid occupancy x ray), not a learnable
        # quantity: the grid is a CONSTANT input rebuilt outside the step,
        # so no parameter gradient flows through these ranges — but
        # without the stop, placement-aware TRAINING (--accel-aabb)
        # drags the whole probe/slab chain into the backward graph
        # (vjps of clip/min/max/gather over P probes per ray) for grads
        # that are identically zero.
        t_lo = jax.lax.stop_gradient(t_lo)
        t_hi = jax.lax.stop_gradient(t_hi)
        # Cap the integrator's far at one bin past the clamped range: the
        # reference's last delta (far - t_last) would otherwise hand the
        # tail sample a huge interval and overweight its alpha. [t_hi, far]
        # holds no occupied cell (conservative grid), so the cap is exact
        # under the same guarantee the rest of the accel mode relies on.
        # Degenerate rays (t_hi == t_lo) get all-zero deltas -> background.
        far_w = jnp.minimum(far, t_hi + (t_hi - t_lo) / cfg.n_coarse)
    else:
        far_w = far
    t_c = stratified_samples(k_coarse, t_lo, t_hi, cfg.n_coarse, batch_shape)
    pts_c = origin[..., None, :] + dirs[..., None, :] * t_c[..., :, None]
    # The reference discards coarse colors (lib.rs:404) — skip the color
    # branch unless the caller needs the coarse image (training/aux) or
    # the single-pass mode composites it directly.
    single_pass = cfg.n_fine == 0
    coarse_sigma_only = not return_aux and not single_pass
    # accel_compact == "off": the grid steers ray packing
    # (accel_cull_rays) and sample placement (accel_sample_aabb) only —
    # no per-sample occupancy masking at all. The mask's occupancy
    # gathers change the image only in empty space where sigma is already
    # ~0; without them, rendered rays are bitwise-exact and the PSNR guard
    # still bounds the background deviation of packed-away rays.
    mask_samples = accel and cfg.accel_compact != "off"
    with jax.named_scope("coarse_mlp"):
        if mask_samples:
            from nerf_rs_tpu.accel import query_occupancy

            occ_c = query_occupancy(grid, pts_c)
            # Mask-only culling has no capacity (it cannot overflow); the dense
            # total keeps aux["live_frac_coarse"] meaningful as the true
            # occupied fraction.
            cap_c = _round_up(
                max(1, int(n_rays * cfg.n_coarse * cfg.accel_coarse_capacity)), 1024
            ) if cfg.accel_compact != "none" else max(1, n_rays * cfg.n_coarse)
            # Culled/overflowed rows scatter back as rgb = 0, sigma = 0; their
            # compositing weight is exactly 0, so the zero color is inert and
            # gradients flow only through the evaluated rows (training uses
            # this path too — NerfAcc-style accelerated training).
            rgb_c, sigma_c, live_c = _mlp_culled(
                mlp, params_coarse, pts_c, dirs[..., None, :], occ_c, cap_c,
                sigma_only=coarse_sigma_only, impl=cfg.accel_compact,
            )
        else:
            rgb_c, sigma_c = mlp(
                params_coarse, pts_c, dirs[..., None, :], sigma_only=coarse_sigma_only
            )
            if return_live:  # accel "off": every sample is live by definition
                live_c = jnp.int32(n_rays * cfg.n_coarse)

    if single_pass:
        # Single-pass mode (n_fine == 0): no hierarchical resampling — the
        # coarse field is integrated directly, exactly the Instant-NGP
        # regime where empty-space skipping replaces the coarse/fine
        # hierarchy (the reference is always two-pass, lib.rs:406-445;
        # this is the reduced-work extension of its own reduced-sample
        # wasm preset, lib.rs:603-612). Halves the field evaluations per
        # sample budget; quality rides full_psnr_db like the other
        # reduced presets.
        w_c = compute_weights(sigma_c, t_c, far_w, t_threshold=cfg.t_threshold)
        rgb = composite(rgb_c, w_c, white_background=cfg.white_background)
        if return_live:
            return rgb, (live_c, jnp.zeros_like(live_c))
        if not return_aux:
            return rgb
        aux = {
            "rgb_coarse": rgb,
            "acc": jnp.sum(w_c, axis=-1),
            "weights_coarse": w_c,
            "weights_fine": w_c,
            "t_coarse": t_c,
            "t_fine": t_c,
            "depth": jnp.sum(w_c * t_c, axis=-1),
        }
        if mask_samples:
            aux["live_frac_coarse"] = live_c.astype(jnp.float32) / cap_c
            aux["live_frac_fine"] = jnp.zeros_like(aux["live_frac_coarse"])
        elif accel:  # "off": nothing is ever culled
            aux["live_frac_coarse"] = jnp.float32(1.0)
            aux["live_frac_fine"] = jnp.float32(0.0)
        return rgb, aux

    # --- hierarchical resampling (lib.rs:406-421) ---
    with jax.named_scope("resample"):
        w_c = compute_weights(sigma_c, t_c, far_w, t_threshold=cfg.t_threshold)
        t_extra = importance_samples(
            k_fine, t_c, w_c, cfg.n_fine, pdf_eps=cfg.pdf_eps, cdf_eps=cfg.cdf_eps
        )
        t_f = merge_samples(t_c, jax.lax.stop_gradient(t_extra))

    # --- fine pass (lib.rs:423-459) ---
    pts_f = origin[..., None, :] + dirs[..., None, :] * t_f[..., :, None]
    with jax.named_scope("fine_mlp"):
        if mask_samples:
            from nerf_rs_tpu.accel import query_occupancy
            from nerf_rs_tpu.ops.volume import exclusive_transmittance

            # Termination culling: past the coarse-estimated point where T
            # drops below accel_t_threshold (under the render's 1e-4 early-out,
            # lib.rs:276), fine samples cannot contribute. Coarse T collapses
            # within ~one sample at hard surfaces while the fine surface can sit
            # slightly later, so the cut is padded by accel_t_slack_bins coarse
            # bins of *distance* (a smaller T threshold alone does not help).
            mask_f = query_occupancy(grid, pts_f)
            if cfg.accel_t_threshold > 0.0:
                t_excl = exclusive_transmittance(sigma_c, t_c, far_w)
                live = t_excl >= cfg.accel_t_threshold
                slack = cfg.accel_t_slack_bins * (far - near) / cfg.n_coarse
                t_term = jnp.max(jnp.where(live, t_c, near), axis=-1, keepdims=True)
                mask_f = mask_f & (t_f <= t_term + slack)
            cap_f = _round_up(
                max(1, int(n_rays * (cfg.n_coarse + cfg.n_fine)
                           * cfg.accel_fine_capacity)), 1024
            ) if cfg.accel_compact != "none" else max(
                1, n_rays * (cfg.n_coarse + cfg.n_fine))
            rgb_f, sigma_f, live_f = _mlp_culled(
                mlp, params_fine, pts_f, dirs[..., None, :], mask_f, cap_f,
                sigma_only=False, impl=cfg.accel_compact,
            )
        else:
            rgb_f, sigma_f = mlp(params_fine, pts_f, dirs[..., None, :])
            if return_live:  # accel "off": every sample is live by definition
                live_f = jnp.int32(n_rays * (cfg.n_coarse + cfg.n_fine))
    w_f = compute_weights(sigma_f, t_f, far_w, t_threshold=cfg.t_threshold)
    rgb = composite(rgb_f, w_f, white_background=cfg.white_background)

    if return_live:
        return rgb, (live_c, live_f)
    if not return_aux:
        return rgb
    aux = {
        "rgb_coarse": composite(rgb_c, w_c, white_background=cfg.white_background),
        "acc": jnp.sum(w_f, axis=-1),
        "weights_coarse": w_c,
        "weights_fine": w_f,
        "t_coarse": t_c,
        "t_fine": t_f,
        "depth": jnp.sum(w_f * t_f, axis=-1),
    }
    if mask_samples:
        # Compaction health: fraction of capacity used, per pass. > 1.0
        # means real samples overflowed to sigma = 0 and their gradients
        # were dropped — raise accel_*_capacity (training logs warn).
        aux["live_frac_coarse"] = live_c.astype(jnp.float32) / cap_c
        aux["live_frac_fine"] = live_f.astype(jnp.float32) / cap_f
    elif accel:  # "off": nothing is ever culled
        aux["live_frac_coarse"] = jnp.float32(1.0)
        aux["live_frac_fine"] = jnp.float32(1.0)
    return rgb, aux


@functools.partial(jax.jit,
                   static_argnames=("n_rays_padded", "cfg", "return_live",
                                    "chunk"))
def _render_flat(params_coarse, params_fine, origin, dirs_flat, near, far, key,
                 n_rays_padded: int, cfg: RenderConfig, ray_id_base: jnp.ndarray = 0,
                 grid=None, return_live: bool = False,
                 chunk: Optional[int] = None,
                 ray_ids_flat: Optional[jnp.ndarray] = None,
                 ray_ranges_flat: Optional[jnp.ndarray] = None):
    """Chunked render of (N_padded, 3) unit dirs via lax.map. Per-ray RNG
    streams are derived from the GLOBAL ray index (ray_id_base + position),
    so the result is independent of the chunk size and of how rays were
    sharded across devices. With ``return_live`` (accel calibration) also
    returns the worst-chunk (coarse, fine) live sample counts.

    ``chunk`` overrides the default min(cfg.ray_chunk, n_rays_padded)
    partition — the sharded render passes the per-device chunk its
    padding was computed with (the default need not divide a padded
    per-device shard, e.g. ray_chunk=12288 with an 8192-aligned shard
    rounded up to 16384).

    ``ray_ids_flat`` ((N_padded,) int32) supplies EXPLICIT per-ray RNG ids
    instead of ray_id_base + position — the ray-culled render passes each
    packed ray's original image index, keeping the packed image bitwise
    equal (per surviving ray) to the unpacked one. ``ray_ranges_flat``
    ((N_padded, 2) f32, requires ray_ids_flat) supplies precomputed
    per-ray (t_lo, t_hi) sample ranges (image-level / strided probe
    ranges, accel.strided_ray_ranges)."""
    chunk = chunk or min(cfg.ray_chunk, n_rays_padded)
    n_chunks = n_rays_padded // chunk
    dirs_chunks = dirs_flat.reshape(n_chunks, chunk, 3)

    def render_chunk(d, ids, ranges=None):
        return render_rays(
            params_coarse, params_fine, origin, d, near, far,
            key, cfg, ray_ids=ids, grid=grid, return_live=return_live,
            ray_ranges=ranges,
        )

    if ray_ids_flat is None:
        def body(args):
            idx, d = args
            ids = ray_id_base + idx * chunk + jnp.arange(chunk, dtype=jnp.int32)
            return render_chunk(d, ids)

        out = jax.lax.map(body, (jnp.arange(n_chunks), dirs_chunks))
    elif ray_ranges_flat is None:
        out = jax.lax.map(
            lambda args: render_chunk(*args),
            (dirs_chunks, ray_ids_flat.reshape(n_chunks, chunk)),
        )
    else:
        def body(args):
            d, ids, rr = args
            return render_chunk(d, ids, (rr[:, 0:1], rr[:, 1:2]))

        out = jax.lax.map(
            body,
            (dirs_chunks, ray_ids_flat.reshape(n_chunks, chunk),
             ray_ranges_flat.reshape(n_chunks, chunk, 2)),
        )
    if return_live:
        out, (live_c, live_f) = out
        return out.reshape(n_rays_padded, 3), (jnp.max(live_c), jnp.max(live_f))
    return out.reshape(n_rays_padded, 3)


@functools.partial(jax.jit, static_argnames=("n_rays_padded", "cfg", "chunk"))
def _render_flat_aux(params_coarse, params_fine, origin, dirs_flat, near, far,
                     key, n_rays_padded: int, cfg: RenderConfig,
                     grid=None, chunk: Optional[int] = None,
                     ray_id_base: jnp.ndarray = 0):
    """Chunked render returning per-ray (rgb, depth, acc) — the aux scalars
    a renderer's depth/alpha outputs need (aux arrays like per-sample
    weights are reduced inside the chunk body, so memory stays bounded).
    ``ray_id_base`` offsets the RNG ray ids for sharded callers."""
    chunk = chunk or min(cfg.ray_chunk, n_rays_padded)
    n_chunks = n_rays_padded // chunk
    dirs_chunks = dirs_flat.reshape(n_chunks, chunk, 3)

    def body(args):
        idx, d = args
        ids = ray_id_base + idx * chunk + jnp.arange(chunk, dtype=jnp.int32)
        rgb, aux = render_rays(
            params_coarse, params_fine, origin, d, near, far,
            key, cfg, ray_ids=ids, grid=grid, return_aux=True,
        )
        return rgb, aux["depth"], aux["acc"]

    rgb, depth, acc = jax.lax.map(body, (jnp.arange(n_chunks), dirs_chunks))
    return (rgb.reshape(n_rays_padded, 3), depth.reshape(n_rays_padded),
            acc.reshape(n_rays_padded))


def render_image_aux(
    params_coarse, params_fine, camera: Camera, height: int, width: int,
    key: jax.Array, cfg: Optional[RenderConfig] = None, grid=None,
):
    """Full-frame render that also returns the depth map (expected-t under
    the fine weights) and the accumulated opacity — the auxiliary outputs
    renderer users expect alongside RGB (the reference only emits RGB,
    lib.rs:474-565; depth/acc fall out of the same weights for free).
    Returns (rgb (H,W,3), depth (H,W), acc (H,W))."""
    cfg = cfg or RenderConfig()
    _, dirs = camera_rays(camera, height, width)
    n = height * width
    chunk = min(cfg.ray_chunk, max(n, 1))
    pad = (-n) % chunk
    dirs_flat = dirs.reshape(n, 3)
    if pad:
        dirs_flat = jnp.concatenate(
            [dirs_flat, jnp.ones((pad, 3), dirs.dtype)], axis=0)
    group = _host_group(cfg, chunk, n + pad)
    parts = []
    for s in range(0, n + pad, group):
        g = min(group, n + pad - s)
        parts.append(_render_flat_aux(
            params_coarse, params_fine, jnp.asarray(camera.position),
            jax.lax.dynamic_slice_in_dim(dirs_flat, s, g),
            jnp.asarray(camera.near), jnp.asarray(camera.far), key, g, cfg,
            grid=grid, chunk=chunk, ray_id_base=s,
        ))
    rgb, depth, acc = (jnp.concatenate([p[i] for p in parts], axis=0)
                       for i in range(3))
    return (rgb[:n].reshape(height, width, 3),
            depth[:n].reshape(height, width),
            acc[:n].reshape(height, width))


def _host_group(cfg: RenderConfig, chunk: int, n_total: int) -> int:
    """Rays per device-program execution (cfg.host_chunk_rays, <= 0 =
    unsplit). Rounded down to a ray_chunk multiple so _render_flat's
    chunking divides evenly — a program can never run FEWER than one
    ray_chunk, so a cap below ray_chunk yields exactly one chunk per
    program."""
    hc = cfg.host_chunk_rays
    if hc <= 0:
        return n_total
    return min(max(chunk, (hc // chunk) * chunk), n_total)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _image_ray_ranges(grid, origin, dirs_img, near, far, cfg: RenderConfig):
    """Per-ray occupied ranges for a full (H, W, 3) frame, plus the
    hit-rays-first permutation and hit count for ray packing.

    A ray "hits" when its occupied sample range is non-degenerate — the
    same range the sampler would use (probe-refined when the config
    samples that way, else the occupied-AABB chord), so culled rays are
    exactly those the accel render composites to pure background anyway
    (every sample lands outside occupancy -> sigma = 0).

    In accel_compact == "off" mode, probe culling (accel_aabb_probes > 0)
    applies even WITHOUT aabb sample placement: a ray with no occupied
    probe passes only through (conservative-grid) empty space, so its
    exact render is background to within the PSNR guard. This matters
    because the occupied-cell bounding BOX is a weak cull on real scenes —
    one stray occupied cell inflates it to the whole frame (measured: box
    keeps 93% of the bench camera's rays, probes keep 67%,
    tools/grid_threshold_study.py).

    cfg.accel_range_stride > 1 probes a subsampled ray grid and expands
    conservatively (accel.strided_ray_ranges), cutting the probe gathers
    by stride^2."""
    from nerf_rs_tpu.accel import ray_aabb_range, strided_ray_ranges

    use_probes = cfg.accel_aabb_probes > 0 and (
        cfg.accel_sample_aabb or cfg.accel_compact == "off")
    if use_probes:
        t0, t1 = strided_ray_ranges(grid, origin, dirs_img, near, far,
                                    stride=cfg.accel_range_stride,
                                    probes=cfg.accel_aabb_probes)
    else:
        t0, t1 = ray_aabb_range(grid, origin, dirs_img.reshape(-1, 3),
                                near, far)
    hit = (t1 > t0).reshape(-1)
    # stable ascending sort of (not hit): hits first, image order preserved
    order = jnp.argsort(~hit).astype(jnp.int32)
    return (t0, t1), order, jnp.sum(hit.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("n_render", "want_ranges"))
def _pack_rays(t0, t1, order, dirs_flat, n_render: int, want_ranges: bool):
    """Jitted pack prologue: one device program instead of 3-4 eager
    dispatches (order wrap-pad + two gathers)."""
    n = order.shape[0]
    if n_render > n:
        # wrap-pad with leading (hit) rays: duplicates render to identical
        # values (same ray id -> same RNG stream), so the scatter below is
        # deterministic.
        order_r = jnp.concatenate([order, order[: n_render - n]])
    else:
        order_r = order[:n_render]
    # The ranges gather is real work (~n_render rows) and a jit OUTPUT
    # cannot be dead-code-eliminated — skip it statically when the config
    # does not place samples by the image-level ranges (the headline
    # probecull path).
    ranges = (jnp.take(jnp.concatenate([t0, t1], axis=-1), order_r, axis=0)
              if want_ranges else None)
    dirs_packed = jnp.take(dirs_flat, order_r, axis=0)
    return order_r, dirs_packed, ranges


@functools.partial(jax.jit, static_argnames=("n", "white"))
def _scatter_packed(rgb, order_r, n: int, white: bool):
    """Jitted scatter epilogue over a background-filled frame."""
    bg = 1.0 if white else 0.0
    return jnp.full((n, 3), bg, jnp.float32).at[order_r].set(rgb)


def _render_image_culled(params_c, params_f, camera, height, width, key, cfg,
                         grid):
    """Ray-culled full-frame render: pack the rays whose occupied range is
    non-degenerate to the front (device-side stable sort; only the hit
    COUNT crosses to the host), render only ceil(hits/chunk) chunks, and
    scatter results back over a background-filled frame. On object-on-
    background scenes (lego: ~half the pixels never touch occupancy) this
    halves the rendered rays outright — work reduction at RAY granularity,
    where one permutation amortizes over ~10^8 FLOPs/ray, unlike the
    per-sample compaction that measured 7x slower than dense (accel.py).

    Per-ray RNG ids are the ORIGINAL image indices, so surviving rays are
    bitwise identical to the unpacked accel render; culled rays match it
    by the occupancy argument above. The rendered chunk count is rounded
    up to 4-chunk multiples so nearby cameras reuse one compiled program.
    """
    _, dirs = camera_rays(camera, height, width)
    n = height * width
    chunk = min(cfg.ray_chunk, max(n, 1))
    dirs_flat = dirs.reshape(n, 3)
    origin = jnp.asarray(camera.position)
    near, far = jnp.asarray(camera.near), jnp.asarray(camera.far)
    (t0, t1), order, n_hit = _image_ray_ranges(
        grid, origin, dirs.reshape(height, width, 3), near, far, cfg)
    n_hit = max(int(n_hit), 1)                     # the one host sync point
    n_chunks = _round_up(-(-n_hit // chunk), 4)
    n_render = min(n_chunks * chunk, _round_up(n, chunk))
    # Jitted pack prologue (one program): wrap-pad + both gathers. The
    # image-level ranges are computed once here, not per chunk, whenever
    # the config places samples by them.
    order_r, dirs_packed, ranges_flat = _pack_rays(
        t0, t1, order, dirs_flat, n_render,
        bool(cfg.accel_sample_aabb))
    group = _host_group(cfg, chunk, n_render)
    if group < n_render:
        # Same host-side program splitting as render_image (per-ray RNG is
        # keyed by the packed ray's ORIGINAL image index, so splitting is
        # bitwise invariant here too).
        parts = []
        for s in range(0, n_render, group):
            g = min(group, n_render - s)
            parts.append(_render_flat(
                params_c, params_f, origin,
                jax.lax.dynamic_slice_in_dim(dirs_packed, s, g),
                near, far, key, g, cfg, grid=grid, chunk=chunk,
                ray_ids_flat=jax.lax.dynamic_slice_in_dim(order_r, s, g),
                ray_ranges_flat=(
                    jax.lax.dynamic_slice_in_dim(ranges_flat, s, g)
                    if ranges_flat is not None else None),
            ))
        rgb = jnp.concatenate(parts, axis=0)
    else:
        rgb = _render_flat(
            params_c, params_f, origin, dirs_packed,
            near, far, key, n_render, cfg, grid=grid, chunk=chunk,
            ray_ids_flat=order_r, ray_ranges_flat=ranges_flat,
        )
    img = _scatter_packed(rgb, order_r, n, bool(cfg.white_background))
    return img.reshape(height, width, 3)


def render_image(
    params_coarse,
    params_fine,
    camera: Camera,
    height: int,
    width: int,
    key: jax.Array,
    cfg: Optional[RenderConfig] = None,
    grid=None,
    return_live: bool = False,
) -> jnp.ndarray:
    """Render a full (height, width, 3) image on the current device(s).
    Pass an accel.OccupancyGrid as ``grid`` for empty-space skipping;
    ``return_live`` (accel only) also returns the worst-chunk (coarse,
    fine) live sample counts for capacity calibration. With
    cfg.accel_cull_rays (and a grid), background rays are culled at the
    image level before rendering (_render_image_culled)."""
    cfg = cfg or RenderConfig()
    if grid is not None and cfg.accel_cull_rays and not return_live:
        return _render_image_culled(params_coarse, params_fine, camera,
                                    height, width, key, cfg, grid)
    _, dirs = camera_rays(camera, height, width)
    n = height * width
    chunk = min(cfg.ray_chunk, max(n, 1))
    pad = (-n) % chunk
    dirs_flat = dirs.reshape(n, 3)
    if pad:
        dirs_flat = jnp.concatenate([dirs_flat, jnp.ones((pad, 3), dirs.dtype)], axis=0)
    group = _host_group(cfg, chunk, n + pad)
    if group < n + pad:
        # Host-side program splitting (cfg.host_chunk_rays): per-ray RNG
        # streams are global-index keyed, so rendering the flat ray set in
        # several jit calls is bitwise identical to one call.
        outs = []
        lives = []
        for s in range(0, n + pad, group):
            g = min(group, n + pad - s)
            o = _render_flat(
                params_coarse, params_fine, jnp.asarray(camera.position),
                jax.lax.dynamic_slice_in_dim(dirs_flat, s, g),
                jnp.asarray(camera.near), jnp.asarray(camera.far), key, g,
                cfg, ray_id_base=s, grid=grid, return_live=return_live,
                chunk=chunk,
            )
            if return_live:
                o, live = o
                lives.append(live)
            outs.append(o)
        out = jnp.concatenate(outs, axis=0)
        if return_live:
            live = (jnp.max(jnp.stack([lc for lc, _ in lives])),
                    jnp.max(jnp.stack([lf for _, lf in lives])))
            return out[:n].reshape(height, width, 3), live
        return out[:n].reshape(height, width, 3)
    out = _render_flat(
        params_coarse, params_fine, jnp.asarray(camera.position), dirs_flat,
        jnp.asarray(camera.near), jnp.asarray(camera.far), key, n + pad, cfg,
        grid=grid, return_live=return_live,
    )
    if return_live:
        rgb, live = out
        return rgb[:n].reshape(height, width, 3), live
    return out[:n].reshape(height, width, 3)
