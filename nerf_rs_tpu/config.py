"""Static configuration dataclasses.

The reference hardcodes every constant (image 256x256 at lib.rs:657-658,
sample counts lib.rs:603-612, block size 8 lib.rs:491, encoding orders 10/4
network.rs:204,219, early-out threshold 1e-4 lib.rs:276, PDF epsilon 1e-5
lib.rs:309, CDF denom clamp 1e-6 lib.rs:343). Here they live in frozen
(hashable -> jit-static) dataclasses.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Multiresolution hash-encoding family (models/hashgrid.py; Mueller
    et al. 2022, PAPERS.md). Frozen -> hashable -> jit-static, like every
    other config here. Defaults follow the paper's quality/speed sweet
    spot scaled to single-object scenes (lego): T=2^17 instead of 2^19
    keeps the stacked table at 16 MiB f32 / 8 MiB bf16."""

    levels: int = 16        # L resolution levels (paper Table 1)
    table_log2: int = 17    # log2 hash-table entries per level (T)
    features: int = 2       # feature channels per entry (F)
    res_min: int = 16       # coarsest grid resolution (N_min)
    res_max: int = 1024     # finest grid resolution (N_max)
    width: int = 64         # density-MLP hidden width (1 hidden layer)
    geo_features: int = 15  # geometry features fed to the color MLP
    #                         (density output dim = 1 + geo_features)
    color_width: int = 64   # color-MLP hidden width (2 hidden layers)
    sh_degree: int = 4      # spherical-harmonics view encoding degree
    aabb: tuple = (-2.0, 2.0)  # scene bounds per axis — the same
    #                            convention as accel.build_occupancy_grid
    grad_impl: str = "scatter"  # table-gradient path: "scatter" (XLA
    #                            autodiff scatter-add) or "sorted" (custom
    #                            VJP: sort-by-index + cumsum-difference
    #                            segment sums + two unique-index
    #                            scatters). Not yet compared on the GPU.

    def replace(self, **kw) -> "HashGridConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static knobs for the render pipeline.

    Defaults replicate the reference native CLI config
    (/root/reference/src/lib.rs:603-612,656-658).
    """

    n_coarse: int = 64          # coarse stratified samples per ray
    n_fine: int = 128           # fine importance samples per ray
    x_freqs: int = 10           # positional encoding bands for points (network.rs:204)
    d_freqs: int = 4            # positional encoding bands for view dirs (network.rs:219)
    white_background: bool = True   # lib.rs:194
    t_threshold: float = 1e-4   # transmittance early-out (lib.rs:276); 0 disables
    pdf_eps: float = 1e-5       # importance-PDF floor (lib.rs:309)
    cdf_eps: float = 1e-6       # CDF denom clamp (lib.rs:343)
    ray_chunk: int = 8192       # rays per lax.map chunk when rendering images
    impl: str = "xla"           # MLP implementation: "xla" | "int8" |
    #                             "int8qat" (models/quant.py)
    model: str = "mlp"          # field network family: "mlp" (the canonical
    #                             reference MLP / ArchConfig students) |
    #                             "hashgrid" (models/hashgrid.py; ``impl``
    #                             applies to the mlp family only)
    hash: HashGridConfig = dataclasses.field(default_factory=HashGridConfig)
    dtype: str = "float32"      # MLP matmul operand dtype: "float32" |
    #                             "bfloat16" (f32 accumulation; models/mlp.py)
    # Occupancy-grid empty-space skipping (accel.py; active when a grid is
    # passed to render_*). Capacities are fractions of the dense sample
    # count kept after compaction; overflow falls back to sigma = 0.
    accel_coarse_capacity: float = 0.25
    accel_fine_capacity: float = 0.625
    accel_t_threshold: float = 1e-5  # termination culling: cull fine samples
    #                                  past the coarse-T<thr point; 0 disables
    accel_t_slack_bins: float = 2.0  # ...extended by this many coarse bins
    #                                  (coarse T collapses within ~1 sample at
    #                                  surfaces; the fine surface can sit a
    #                                  fraction of a bin later)
    accel_sample_aabb: bool = False  # clamp each ray's sample range to its
    #                                  intersection with the occupied-cell
    #                                  AABB (accel.ray_aabb_range): the same
    #                                  sample count concentrates where matter
    #                                  is — the quality-per-sample lever for
    #                                  reduced-sample presets. Changes sample
    #                                  PLACEMENT vs the reference semantics,
    #                                  so opt-in and PSNR-guarded like the
    #                                  rest of the accel mode.
    accel_aabb_probes: int = 0       # >0 (with accel_sample_aabb): refine
    #                                  each ray's range to its first..last
    #                                  occupied probe along the box span
    #                                  (accel.ray_occupied_range) — tighter
    #                                  than the box chord for grazing rays;
    #                                  this many grid lookups per ray.
    accel_pad_probes: float = 1.0    # pad each probe-refined range by this
    #                                  many probe intervals per side. Serving
    #                                  image renders use stride-pooled ranges
    #                                  (up to a block wider than the per-ray
    #                                  run); placement-aware TRAINING batches
    #                                  probe per ray (no image grid to pool),
    #                                  so a larger pad here emulates the
    #                                  pooling slack and keeps the training
    #                                  sample distribution matched to
    #                                  serving (train --accel-pad).
    accel_range_stride: int = 1      # >1 (with accel_aabb_probes): probe the
    #                                  occupied ranges on a stride-subsampled
    #                                  ray grid and conservatively expand
    #                                  (3x3 union-pool) back to full res —
    #                                  cuts the probe gathers by stride^2
    #                                  (accel.strided_ray_ranges). Applies
    #                                  to the image-level render paths.
    host_chunk_rays: int = 0         # max rays per DEVICE PROGRAM execution:
    #                                  image renders split into host-side
    #                                  groups of this many rays (rounded to
    #                                  ray_chunk), each its own jit call.
    #                                  <= 0 = unsplit (one program per
    #                                  frame). Per-ray RNG is keyed by GLOBAL
    #                                  ray index, so the split is bitwise
    #                                  invariant (tests/test_render.py).
    accel_compact: str = "none"      # how culled sample rows skip the MLP:
    #                                  "off"     — no per-sample culling AT
    #                                              ALL: the grid steers ray
    #                                              packing + AABB placement
    #                                              only; the occupancy-mask
    #                                              gathers would only zero
    #                                              sigma where it is already
    #                                              ~0, and rendered rays stay
    #                                              bitwise exact without them.
    #                                  "none"    — mask-only: evaluate densely,
    #                                              zero sigma where culled. No
    #                                              FLOPs saved per sample, but
    #                                              zero compaction overhead and
    #                                              no overflow (capacities
    #                                              unused).
    #                                  "scatter" — cumsum+scatter compaction to
    #                                              a fixed-capacity buffer
    #                                  "gather"  — cumsum+searchsorted variant
    accel_cull_rays: bool = False    # render_image only: pack rays whose
    #                                  occupied range is non-degenerate and
    #                                  render ONLY those; rays that miss the
    #                                  occupied box composite to the background
    #                                  directly (exactly what the accel path
    #                                  evaluates them to). Host-side packing
    #                                  per camera; per-ray RNG streams keep
    #                                  the image bitwise-invariant to the
    #                                  packing order (render_rays ray_ids).

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """NeRF MLP architecture family.

    The reference has exactly ONE architecture (canonical lego: 8x256
    trunk, skip after layer 4, 128-wide view branch — network.rs:172-237).
    Here the family is parametric: smaller *student* networks trained by
    distillation (cli train --width ...) cut MLP FLOPs quadratically in
    width. Every member runs through models/mlp.py.
    """

    width: int = 256      # trunk width (canonical 256)
    v_width: int = 128    # view-branch width (canonical 128)
    depth: int = 8        # dense trunk layers (canonical 8)
    skip_at: int = 4      # encoded input re-concatenated BEFORE dense{skip_at+1}
    #                       (reference: h = concat(h0, h4) feeds dense5,
    #                        network.rs:210-211)

    @property
    def is_canonical(self) -> bool:
        return self == ArchConfig()

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


CANONICAL_ARCH = ArchConfig()


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (the reference has no training; these follow
    the original NeRF recipe: Adam 5e-4 with exponential decay to 5e-6)."""

    batch_rays: int = 4096
    lr_init: float = 5e-4
    lr_final: float = 5e-6
    lr_decay_steps: int = 250_000
    n_steps: int = 200_000
    coarse_loss_weight: float = 1.0
    adam_eps: float = 1e-8       # hash-grid training wants 1e-15 (Instant-NGP
    #                              recipe: tiny table gradients would vanish
    #                              under the default eps); cli train --model
    #                              hashgrid sets it
    checkpoint_every: int = 10_000
    seed: int = 0
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    arch: ArchConfig = dataclasses.field(default_factory=ArchConfig)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


# Reference sample-count presets (lib.rs:603-612).
NATIVE_SAMPLES = (64, 128)
WASM_SAMPLES = (32, 64)
