"""Ray sampling: stratified bins and hierarchical inverse-CDF resampling.

Redesign of the reference's per-ray scalar loops into fixed-shape
batched array programs with counter-based `jax.random` keys (deterministic,
device-resident — unlike the reference's OS-seeded per-thread `thread_rng`,
lib.rs:375,407).

Numerical contracts from the reference:
- stratified_samples (/root/reference/src/lib.rs:233-248): [near, far] split
  into `count` equal bins, one uniform jittered sample per bin.
- sample_importance (lib.rs:285-351): PDF from the *interior* coarse weights
  weights[1..n-1], bins are midpoints of the coarse t-values, weights clamped
  >= 0 plus 1e-5 then normalized, CDF's final entry forced to 1.0, bin lookup
  is "first j with cdf[j] <= u < cdf[j+1]", linear interpolation inside the
  bin with the denominator clamped to 1e-6. Fine samples are merged with the
  coarse ones and sorted by the caller (lib.rs:416-419).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _batched_uniform(key: jax.Array, batch_shape, count: int, dtype) -> jnp.ndarray:
    """(*batch_shape, count) uniforms. ``key`` may be a single key (one
    stream for the whole batch) or a (B,) batch of per-ray keys — per-ray
    keys make renders bitwise invariant to chunking and device sharding."""
    if jnp.ndim(key) == 1:
        if batch_shape != key.shape:
            raise ValueError(f"per-ray keys {key.shape} != batch {batch_shape}")
        return jax.vmap(lambda k: jax.random.uniform(k, (count,), dtype=dtype))(key)
    return jax.random.uniform(key, (*batch_shape, count), dtype=dtype)


def stratified_samples(
    key: jax.Array,
    near,
    far,
    count: int,
    batch_shape: tuple = (),
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Jittered equal-bin samples of [near, far] -> (*batch_shape, count)."""
    u = _batched_uniform(key, batch_shape, count, dtype)
    interval = (far - near) / count
    lower = near + jnp.arange(count, dtype=dtype) * interval
    return lower + interval * u


def importance_samples(
    key: jax.Array,
    ts: jnp.ndarray,
    weights: jnp.ndarray,
    count: int,
    *,
    pdf_eps: float = 1e-5,
    cdf_eps: float = 1e-6,
) -> jnp.ndarray:
    """Inverse-CDF resampling of ``count`` new t's per ray.

    ts: (..., Nc) sorted sample positions; weights: (..., Nc) transmittance
    weights. Requires Nc >= 3 (the reference returns empty below that,
    lib.rs:295; with fixed shapes we assert instead). Returns (..., count),
    NOT sorted (sorting happens at merge, like the reference).

    The zero-PDF-mass guard (lib.rs:311) is unreachable: the +pdf_eps floor
    makes every bin strictly positive.
    """
    n_c = ts.shape[-1]
    if n_c < 3:
        raise ValueError(f"importance sampling requires >= 3 coarse samples, got {n_c}")

    bins = 0.5 * (ts[..., 1:] + ts[..., :-1])          # (..., Nc-1) midpoints
    pdf_w = jnp.maximum(weights[..., 1:-1], 0.0) + pdf_eps  # (..., Nc-2) interior
    pdf = pdf_w / jnp.sum(pdf_w, axis=-1, keepdims=True)
    cdf = jnp.cumsum(pdf, axis=-1)
    cdf = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf[..., :-1],
                           jnp.ones_like(cdf[..., :1])], axis=-1)  # (..., Nc-1), last forced to 1

    u = _batched_uniform(key, ts.shape[:-1], count, ts.dtype)

    # Bin lookup: cdf is strictly increasing (pdf >= pdf_eps/sum), so
    # "first j with cdf[j] <= u < cdf[j+1]" (the reference's linear scan)
    # selects exactly one bin. Build that one-hot (..., count, n_bins) and
    # contract it against the per-bin [cdf_lo, cdf_hi, bin_lo, bin_hi]
    # table (a batched matmul, HIGHEST so the selection stays exact in
    # f32) in place of a per-sample gather.
    one_hot = (
        (u[..., :, None] >= cdf[..., None, :-1])
        & (u[..., :, None] < cdf[..., None, 1:])
    ).astype(ts.dtype)  # (..., count, n_c - 2)
    table = jnp.stack(
        [cdf[..., :-1], cdf[..., 1:], bins[..., :-1], bins[..., 1:]], axis=-1
    )  # (..., n_c - 2, 4)
    sel = jax.lax.dot_general(
        one_hot, table,
        dimension_numbers=(((one_hot.ndim - 1,), (table.ndim - 2,)),
                           (tuple(range(one_hot.ndim - 2)), tuple(range(table.ndim - 2)))),
        precision=jax.lax.Precision.HIGHEST,
    )  # (..., count, 4)
    cdf_lo, cdf_hi, bin_lo, bin_hi = (sel[..., i] for i in range(4))
    frac = (u - cdf_lo) / jnp.maximum(cdf_hi - cdf_lo, cdf_eps)
    return bin_lo + (bin_hi - bin_lo) * frac


def merge_samples(t_coarse: jnp.ndarray, t_fine: jnp.ndarray) -> jnp.ndarray:
    """Merge coarse + fine t's and sort ascending (lib.rs:416-419). Fixed
    output width Nc + Nf — per-ray variable Vecs become one static shape."""
    return jnp.sort(jnp.concatenate([t_coarse, t_fine], axis=-1), axis=-1)
