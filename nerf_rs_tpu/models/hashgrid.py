"""Multiresolution hash-grid NeRF (Instant-NGP family) in plain JAX.

A second model family beyond the reference's single fixed MLP
(/root/reference/src/network.rs:172-237): the multiresolution hash
encoding of Mueller et al. 2022 ("Instant Neural Graphics Primitives with
a Multiresolution Hash Encoding", PAPERS.md) replaces the 60-odd
sinusoidal features + 8x256 trunk with L small feature tables gathered and
trilinearly interpolated at each sample point, followed by a *tiny* MLP.
Per-sample work drops from ~590 K MACs (canonical MLP) to ~10 K MACs +
L*8 table gathers — the second big work-reduction axis (after occupancy
culling) toward the 10 M rays/s north-star (BASELINE.md).

Design decisions (vs the paper's CUDA kernels):

- **Layout-first encode: every intermediate is (L, N).** Levels lead,
  flattened points trail; per-axis component math replaces any tensor
  with a small trailing xyz(3)/corner(8)/feature(2) dim, which XLA tiles
  with heavy padding (an (..., L, 3) index temp alone is over 1 GB at
  4096-ray chunks). All L levels live in one stacked ``(L*T, F)`` table
  (per-level indices offset by ``level*T``); one gather per trilinear
  corner, accumulated in place. On the bf16 F=2 speed path BOTH features
  come from a single u32 element gather (``_packed_pair_gather``:
  bitcast-packed pair, elementwise bit unpack, custom-VJP scatter-add
  backward).
- **Uniform table size.** Levels whose dense grid fits (``(N+1)^3 <= T``)
  index directly (no collisions — matches the paper Sec. 4); coarser
  levels simply waste table tail entries. A ragged per-level layout would
  force dynamic shapes.
- **Fixed shapes / no data-dependent control flow**: resolutions,
  level count, and table sizes are static Python (compiled into the jit
  program); everything else is pure array math.
- **bf16 tables, f32 positions**: positions need f32 (a 1024^3 grid eats
  ~10 bits of mantissa); the gathered features tolerate bf16 (halves the
  device-memory bytes of the dominant op). Controlled by the caller's
  ``dtype``.

Interfaces mirror models/mlp.py exactly — ``hashgrid_mlp(params, points,
viewdirs, sigma_only=...)`` returns ``(rgb, sigma)`` — so render_rays,
the occupancy-culled path, training, and the sharded drivers all serve
this family unchanged (render.get_mlp_fn dispatches on
RenderConfig.model).

Numerics notes vs the reference renderer contracts (SURVEY.md §7): the
volume-integration chain (stratified/importance sampling, transmittance
weights, white background) is shared and unchanged; only the
field-evaluation network differs. Sigma uses the paper's truncated-exp
activation (not the reference MLP's ReLU) — appropriate for a family
trained from scratch here, and irrelevant to reference parity since the
reference has no such model.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Spatial-hash primes from the paper (Sec. 3, eq. 4; pi_1 = 1 keeps
# gradient coherence along x).
_PRIMES = (1, 2654435761, 805459861)

# Real spherical-harmonics basis constants (degree <= 4), the standard set
# shared by Plenoxels / torch-ngp style view encoders.
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh_encoding(dirs: jnp.ndarray, degree: int = 4) -> jnp.ndarray:
    """Real SH basis of unit ``dirs`` (..., 3) -> (..., degree**2).

    Replaces the sinusoidal view-dir encoding of the canonical family
    (network.rs:294-330) for the hash family, per the paper's pipeline.
    """
    if not 1 <= degree <= 4:
        raise ValueError(f"sh_degree must be in [1, 4], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [jnp.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
                _C2[3] * xz, _C2[4] * (xx - yy)]
    if degree > 3:
        out += [_C3[0] * y * (3.0 * xx - yy), _C3[1] * xy * z,
                _C3[2] * y * (4.0 * zz - xx - yy),
                _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                _C3[4] * x * (4.0 * zz - xx - yy),
                _C3[5] * z * (xx - yy), _C3[6] * x * (xx - 3.0 * yy)]
    return jnp.stack(out, axis=-1)


def level_resolutions(cfg) -> Tuple[int, ...]:
    """Per-level grid resolutions N_l ~= N_min * b**l with the paper's
    geometric growth factor b (eq. 2-3). round(), not the paper's floor():
    floor turns float noise in b**l into off-by-one resolutions (the
    default 16->1024 over 16 levels lands the last level at 1023), and the
    config's res_min/res_max contract should hold exactly at both ends."""
    if cfg.levels == 1:
        return (cfg.res_min,)
    b = math.exp((math.log(cfg.res_max) - math.log(cfg.res_min))
                 / (cfg.levels - 1))
    return tuple(int(round(cfg.res_min * b ** l)) for l in range(cfg.levels))


# The 8 trilinear corner offsets, (8, 3) — static.
_CORNERS = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                    axis=-1).reshape(8, 3)


@jax.custom_vjp
def _table_gather_sorted(flat_tables: jnp.ndarray,
                         idx: jnp.ndarray) -> jnp.ndarray:
    """jnp.take whose BACKWARD avoids XLA's colliding-index scatter-add.

    The table gradient is a (batch*L*8, F)-row scatter-add into the
    (L*T, F) table with heavy index collisions (every sample touches 8
    corners per level; coarse levels have very few distinct cells), and
    a scatter serializes on colliding indices. Here the backward instead:

      sort rows by table index (one lax.sort_key_val)
      -> f32 cumulative sum over the sorted gradient rows
      -> per-segment totals as cumsum differences at segment ends/starts
      -> TWO unique-index scatters (one row per touched table entry each),
         which vectorize fine — collisions were the problem, not scatter.

    Precision: segment totals come from differences of a 25M-row running
    sum; with ~1e-3-magnitude row gradients the absolute error is ~1e-3
    relative to per-segment sums — noise far below the minibatch variance
    SGD already tolerates (and the A/B quality run guards it end to end).
    """
    return jnp.asarray(flat_tables).at[idx].get(mode="promise_in_bounds")


def _table_gather_sorted_fwd(flat_tables, idx):
    # flat_tables rides along as a residual only for its (static) shape
    # and dtype — it is alive as a parameter anyway.
    return jnp.asarray(flat_tables).at[idx].get(mode="promise_in_bounds"), (idx, flat_tables)


def _table_gather_sorted_bwd(res, g):
    idx, flat_tables = res
    n_rows, dtype = flat_tables.shape[0], flat_tables.dtype
    f = g.shape[-1]
    flat_idx = idx.reshape(-1).astype(jnp.int32)
    flat_g = g.reshape(-1, f).astype(jnp.float32)
    si, *sg_cols = jax.lax.sort(
        (flat_idx, *(flat_g[:, i] for i in range(f))), num_keys=1)
    sg = jnp.stack(sg_cols, axis=-1)
    csum = jnp.cumsum(sg, axis=0)
    m = si.shape[0]
    is_end = jnp.concatenate([si[1:] != si[:-1],
                              jnp.ones((1,), bool)])
    is_start = jnp.concatenate([jnp.ones((1,), bool), si[1:] != si[:-1]])
    # Exclusive cumsum at each row (the value just BEFORE the segment).
    csum_excl = csum - sg
    trash = jnp.int32(n_rows)
    end_rows = jnp.where(is_end, si, trash)
    start_rows = jnp.where(is_start, si, trash)
    zeros = jnp.zeros((n_rows, f), jnp.float32)
    # One row per touched table entry in each scatter -> unique indices.
    totals = (zeros.at[end_rows].set(csum, mode="drop",
                                     unique_indices=True)
              - zeros.at[start_rows].set(csum_excl, mode="drop",
                                         unique_indices=True))
    return totals.astype(dtype), None


_table_gather_sorted.defvjp(_table_gather_sorted_fwd, _table_gather_sorted_bwd)


@jax.custom_vjp
def _packed_pair_gather(flat2: jnp.ndarray, idx: jnp.ndarray):
    """Gather both bf16 features of a (M, 2) table with ONE u32 element
    gather, returning a (f0, f1) pair of idx-shaped bf16 arrays.

    Layout trick: the pair is bitcast to a (M,) uint32 column, so the
    gather's OUTPUT has the same shape as ``idx`` — no trailing F=2 axis
    (which XLA would tile with heavy padding) and one 4-byte row read.
    The halves unpack with elementwise bit ops (a bf16's f32 bits are its
    own bits << 16). The custom VJP restores differentiability (bitcasts
    have no gradient): the backward is the standard scatter-add, which
    only runs in training."""
    return _packed_pair_gather_fwd(flat2, idx)[0]


def _packed_pair_gather_fwd(flat2, idx):
    packed = jax.lax.bitcast_convert_type(flat2, jnp.uint32)   # (M,)
    u = packed.at[idx].get(mode="promise_in_bounds")           # idx-shaped
    lo = jax.lax.bitcast_convert_type(u << 16, jnp.float32)
    hi = jax.lax.bitcast_convert_type(u & np.uint32(0xFFFF0000),
                                      jnp.float32)
    return ((lo.astype(jnp.bfloat16), hi.astype(jnp.bfloat16)),
            (idx, flat2.shape[0]))


def _packed_pair_gather_bwd(res, g):
    idx, m = res
    g0, g1 = (v.astype(jnp.float32) for v in g)
    dtab = jnp.zeros((m, 2), jnp.float32)
    dtab = dtab.at[idx.reshape(-1)].add(
        jnp.stack([g0.reshape(-1), g1.reshape(-1)], axis=-1))
    return dtab.astype(jnp.bfloat16), None


_packed_pair_gather.defvjp(_packed_pair_gather_fwd, _packed_pair_gather_bwd)


def hash_encode(tables: jnp.ndarray, points: jnp.ndarray, cfg) -> jnp.ndarray:
    """Multiresolution hash encoding: (..., 3) world points -> (..., L*F).

    ``tables``: (L, T, F) feature tables. Points are normalized into the
    scene AABB (out-of-box points clamp to the border cell — their
    features are whatever the border learned; the renderer's occupancy /
    background handling keeps them inert, same stance as accel.py's
    out-of-AABB = unoccupied rule).

    LAYOUT-FIRST internals: every intermediate is a (L, N) array —
    levels first, flattened points last. Any array with a small trailing
    xyz (3) or feature (2) axis is tiled with heavy padding; per-axis
    component math + the packed-pair gather keep the largest temp at the
    unpadded (L, N) size.
    """
    tables = jnp.asarray(tables)
    L, T, F = tables.shape
    resolutions = level_resolutions(cfg)
    if L != len(resolutions):
        raise ValueError(f"tables have {L} levels, config implies {len(resolutions)}")
    lo, hi = cfg.aabb
    batch_shape = points.shape[:-1]
    xs = (points.astype(jnp.float32).reshape(-1, 3) - lo) / (hi - lo)
    # nan_to_num BEFORE clip: every gather below promises in-bounds
    # indices, and clip(NaN) = NaN would reach floor->int32 as an
    # implementation-defined value. Non-finite points (degenerate rays)
    # land in the border cell like any other out-of-box point.
    xs = jnp.clip(jnp.nan_to_num(xs), 0.0, 1.0)       # (N, 3)

    ns = jnp.asarray(resolutions, jnp.float32)        # (L,) static values
    np1 = np.asarray(resolutions, np.int64) + 1
    # Which levels index directly vs hash is STATIC (resolutions and T
    # are config), so the select lowers to a constant (L, 1) mask.
    direct_mask = jnp.asarray((np1 ** 3) <= T)[:, None]
    np1_j = jnp.asarray(np1.astype(np.int32))[:, None]
    level_off = (jnp.arange(L, dtype=jnp.int32) * T)[:, None]

    # Per-AXIS (L, N) lattice coords: three separate component arrays
    # instead of one (..., 3)-trailing tensor.
    comp = []
    for a in range(3):
        pos = ns[:, None] * xs[:, a][None, :]         # (L, N)
        i0 = jnp.clip(jnp.floor(pos), 0.0,
                      ns[:, None] - 1.0).astype(jnp.int32)
        comp.append((i0, pos - i0))
    (ix, fx), (iy, fy), (iz, fz) = comp

    # Gather impls (all promise_in_bounds — indices are in [0, L*T) by
    # construction, and XLA's OOB-clamp masks measured 384 MB of padded
    # pred temps per chunk before):
    #   - bf16 F=2 (the paper default / speed path): ONE u32 packed
    #     gather per corner; outputs stay (L, N).
    #   - otherwise: one F-wide ROW gather per corner — XLA row-gather
    #     throughput is width-independent (~125 M rows/s for F=2..128,
    #     tools/gather_study.py), which is exactly the wide-F preset's
    #     lever; the (L, N, F) output pads on its minor F dim but is the
    #     only such temp (one per corner, sequentially accumulated).
    #   - grad_impl == "sorted": the segment-sum custom VJP on the same
    #     row gather. Measured SLOWER than the scatter default (335 vs
    #     556 rays/s) — kept as the A/B knob.
    sorted_impl = getattr(cfg, "grad_impl", "scatter") == "sorted"
    packed = F == 2 and tables.dtype == jnp.bfloat16 and not sorted_impl
    flat = tables.reshape(L * T, F)
    if not packed:
        if sorted_impl:
            gather2d = _table_gather_sorted
        else:
            gather2d = lambda t, i: t.at[i].get(  # noqa: E731
                mode="promise_in_bounds")

    acc_pair = [None, None]
    acc_lnf = None
    for bx, by, bz in _CORNERS:
        icx, icy, icz = ix + int(bx), iy + int(by), iz + int(bz)
        d_idx = (icx * np1_j + icy) * np1_j + icz     # direct; < 2^31
        h = ((icx.astype(jnp.uint32) * np.uint32(_PRIMES[0]))
             ^ (icy.astype(jnp.uint32) * np.uint32(_PRIMES[1]))
             ^ (icz.astype(jnp.uint32) * np.uint32(_PRIMES[2])))
        idx = jnp.where(direct_mask, d_idx,
                        (h & np.uint32(T - 1)).astype(jnp.int32)) + level_off
        # Trilinear weight: per axis, frac when the corner bit is set,
        # (1 - frac) otherwise — three (L, N) multiplies.
        w = ((fx if bx else 1.0 - fx)
             * (fy if by else 1.0 - fy)
             * (fz if bz else 1.0 - fz))
        if packed:
            feats = _packed_pair_gather(flat, idx)    # 2 x (L, N)
            for f in range(2):
                term = feats[f] * w.astype(feats[f].dtype)
                acc_pair[f] = (term if acc_pair[f] is None
                               else acc_pair[f] + term)
        else:
            feats = gather2d(flat, idx)               # (L, N, F)
            term = feats * w[..., None].astype(feats.dtype)
            acc_lnf = term if acc_lnf is None else acc_lnf + term

    # -> (N, L, F) -> (*batch, L*F): ONE materialized feature buffer at
    # the end; everything upstream stayed (L, N)(, F).
    enc = jnp.stack(acc_pair, axis=-1) if packed else acc_lnf  # (L, N, F)
    enc = jnp.moveaxis(enc, 1, 0)                     # (N, L, F)
    return enc.reshape(*batch_shape, L * F)


def _trunc_exp(x: jnp.ndarray) -> jnp.ndarray:
    """exp with a clipped input — the paper's density activation. The clip
    zeroes gradients outside [-15, 15], preventing fp blow-ups early in
    training."""
    return jnp.exp(jnp.clip(x, -15.0, 15.0))


def _dense(params, name: str, x: jnp.ndarray) -> jnp.ndarray:
    p = params[name]
    # f32 asks for HIGHEST precision explicitly: the GPU may otherwise run
    # f32 matmuls in TF32 (~3 decimal digits).
    prec = (jax.lax.Precision.HIGHEST if x.dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    return (jnp.dot(x, p["kernel"].astype(x.dtype), precision=prec)
            + p["bias"].astype(x.dtype))


def hashgrid_mlp(
    params: Dict,
    points: jnp.ndarray,
    viewdirs: jnp.ndarray,
    *,
    cfg,
    dtype="float32",
    sigma_only: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate the hash-grid field at ``points`` (..., 3) with unit view
    dirs (..., 3) broadcastable against the points' batch shape. Returns
    ``(rgb (..., 3), sigma (...,))`` — the same contract as
    models.mlp.nerf_mlp, so every render/train/accel path serves it.

    Pipeline (paper Sec. 5.4): hash features (L*F) -> density MLP (1
    hidden layer) -> sigma = trunc_exp(out[0]), geometry features =
    the full output vector -> color MLP (2 hidden layers) on
    concat(geometry, SH(viewdirs)) -> sigmoid RGB.
    """
    dt = jnp.dtype(dtype)
    enc = hash_encode(params["hash_tables"].astype(dt), points, cfg).astype(dt)
    h = jax.nn.relu(_dense(params, "sigma0", enc))
    geo = _dense(params, "sigma1", h)                 # (..., 1 + geo_features)
    sigma = _trunc_exp(geo[..., 0].astype(jnp.float32))
    if sigma_only:
        return jnp.zeros((*sigma.shape, 3), jnp.float32), sigma

    sh = sh_encoding(viewdirs, cfg.sh_degree).astype(dt)
    sh = jnp.broadcast_to(sh, (*geo.shape[:-1], sh.shape[-1]))
    hc = jnp.concatenate([geo, sh], axis=-1)
    hc = jax.nn.relu(_dense(params, "color0", hc))
    hc = jax.nn.relu(_dense(params, "color1", hc))
    rgb = jax.nn.sigmoid(_dense(params, "color2", hc).astype(jnp.float32))
    return rgb, sigma


def init_hashgrid_params(key: jax.Array, cfg, dtype=jnp.float32) -> Dict:
    """Random init: tables U(-1e-4, 1e-4) (paper Sec. 4), Glorot-uniform
    MLP kernels + zero biases (consistent with models.mlp.init_nerf_params).
    """
    T = 1 << cfg.table_log2
    kt, *ks = jax.random.split(key, 6)
    params: Dict = {
        "hash_tables": jax.random.uniform(
            kt, (cfg.levels, T, cfg.features), dtype, minval=-1e-4, maxval=1e-4)
    }
    enc_dim = cfg.levels * cfg.features
    geo = 1 + cfg.geo_features
    shapes = {
        "sigma0": (enc_dim, cfg.width),
        "sigma1": (cfg.width, geo),
        "color0": (geo + cfg.sh_degree ** 2, cfg.color_width),
        "color1": (cfg.color_width, cfg.color_width),
        "color2": (cfg.color_width, 3),
    }
    for k, (name, (d_in, d_out)) in zip(ks, shapes.items()):
        limit = math.sqrt(6.0 / (d_in + d_out))
        params[name] = {
            "kernel": jax.random.uniform(k, (d_in, d_out), dtype,
                                         minval=-limit, maxval=limit),
            "bias": jnp.zeros((d_out,), dtype),
        }
    return params


def is_hashgrid_params(params) -> bool:
    """True when a checkpoint/param pytree belongs to this family (used by
    the CLI to infer the model from a loaded checkpoint, the same way
    ArchConfig is inferred from dense-layer shapes)."""
    return isinstance(params, dict) and "hash_tables" in params
