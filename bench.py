"""Benchmark: forward render throughput (rays/s) on the lego scene.

Headline config is the BASELINE.json north-star workload: 800x800 image,
64 coarse + 128 fine samples/ray, hierarchical coarse/fine pipeline on
however many devices are visible. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
   "device": {"platform", "kind", "count"}, "power_limit": "..."}
vs_baseline: value / (chips x 10M rays/s) in render mode — the north-star
forward target — and value / (chips x 1M rays/s) in train mode (a full
fwd+bwd+opt step is ~3x the forward FLOPs plus optimizer + collective
work; see BASELINE.md targets — the reference itself publishes no
numbers and cannot train at all).

Env knobs: NERF_BENCH_SIZE (default 800), NERF_BENCH_IMPL (xla|int8|int8qat),
NERF_BENCH_DTYPE (float32|bfloat16), NERF_BENCH_REPEATS (default 3),
NERF_BENCH_ACCEL (auto|0|1: occupancy-grid
empty-space skipping — PSNR-validated fast mode, tests/test_accel.py;
"auto", the default, keeps the fast number only if it beats the 40 dB
contract and otherwise reports a measured exact-path run),
NERF_BENCH_MODE (render|train: train measures full fwd+bwd+psum optimizer
steps in rays/s with the same 64+128 sample config),
NERF_BENCH_DEADLINE (seconds, default 2400; 0 disables — the wall-clock
budget of the frontier presets run before the headline).
Frontier knobs (rays/s-vs-PSNR curve):
NERF_BENCH_SAMPLES ("Nc,Nf", default "64,128" — "32,64" is the reference's
own reduced wasm preset, src/lib.rs:603-612), NERF_BENCH_MODEL
(mlp|hashgrid: field-network family — hashgrid is the Instant-NGP
encoding, random-init unless NERF_BENCH_CHECKPOINT), NERF_BENCH_CHECKPOINT
(a cli-train checkpoint of any family to bench instead of the pretrained
weights), NERF_BENCH_ACCEL_RES
(occupancy grid resolution, default 128), NERF_BENCH_ACCEL_T
(termination-culling T threshold override), NERF_BENCH_ACCEL_SLACK
(termination slack in coarse bins). Accel runs always report
accel_psnr_db vs the exact path at the SAME sample counts; reduced-sample
runs additionally report full_psnr_db vs the 64+128 exact render — the
quality axis of the frontier.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time


def _bench_train(cfg, repeats: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nerf_rs_tpu.config import TrainConfig
    from nerf_rs_tpu.parallel.train_sharded import (
        create_sharded_train_state,
        sharded_train_step,
    )

    batch_rays = int(os.environ.get("NERF_BENCH_TRAIN_RAYS", "16384"))
    arch_env = os.environ.get("NERF_BENCH_ARCH")
    arch = None
    if arch_env:
        # Student-family train throughput (e.g. NERF_BENCH_ARCH=128,64):
        # the work-reduction axis of the 1M-rays/s train target.
        from nerf_rs_tpu.config import ArchConfig

        dims = [int(v) for v in arch_env.split(",")]
        dims += [256, 128, 8, 4][len(dims):]
        arch = ArchConfig(width=dims[0], v_width=dims[1],
                          depth=dims[2], skip_at=dims[3])

    def make_batch(batch_rays):
        kw = {"arch": arch} if arch is not None else {}
        tcfg = TrainConfig(batch_rays=batch_rays,
                           render=cfg.replace(ray_chunk=batch_rays), **kw)
        rng = np.random.default_rng(0)
        dirs = rng.normal(size=(batch_rays, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        batch = {
            "origins": jnp.tile(jnp.asarray([[0.0, -4.0, 1.0]], jnp.float32),
                                (batch_rays, 1)),
            "dirs": jnp.asarray(dirs),
            "rgb": jnp.asarray(rng.uniform(size=(batch_rays, 3)).astype(np.float32)),
            "near": jnp.float32(2.0),
            "far": jnp.float32(6.0),
        }
        return tcfg, batch

    tcfg, batch = make_batch(batch_rays)
    mesh, state = create_sharded_train_state(jax.random.key(0), tcfg)
    grid = None
    # Train mode has no PSNR guard, so "auto" does NOT enable accel here —
    # only an explicit NERF_BENCH_ACCEL=1 does.
    if os.environ.get("NERF_BENCH_ACCEL", "0") not in ("0", "", "false", "auto"):
        # Occupancy-culled training throughput: bake the grid from the
        # pretrained teacher (in a real run cli train --accel-every
        # rebuilds it from the student; the culling cost is identical).
        from nerf_rs_tpu.accel import build_scene_grid
        from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params

        assets = find_lego_assets()
        if assets is not None:
            grid = build_scene_grid(load_nerf_params(assets / "coarse"),
                                    load_nerf_params(assets / "fine"),
                                    resolution=128)

    key = jax.random.key(1)
    state, metrics = sharded_train_step(mesh, state, batch, key, tcfg,
                                        grid=grid)  # compile
    jax.block_until_ready(metrics["loss"])
    # Chain several steps per timed repeat with ONE sync at the end:
    # steady-state chained steps are exactly what training wall-clock sees.
    chain = int(os.environ.get("NERF_BENCH_TRAIN_CHAIN", "4"))
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        for j in range(chain):
            state, metrics = sharded_train_step(
                mesh, state, batch, jax.random.fold_in(key, i * chain + j),
                tcfg, grid=grid)
        jax.block_until_ready(metrics["loss"])
        times.append((time.perf_counter() - t0) / chain)
    rays_per_s = batch_rays / min(times)
    n_chips = jax.device_count()
    # chain != 1 runs are tagged into their own metric series AND carry the
    # chain length as a field — differently-measured runs must not alias.
    chain_tag = f"+chain{chain}" if chain != 1 else ""
    rec = {
        "metric": f"{_metric_name(impl=cfg.impl, dtype=cfg.dtype, accel=grid is not None)}{chain_tag}, {n_chips} chip(s)",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        # Train target: 1M rays/s/chip (fwd+bwd+opt; see module docstring).
        "vs_baseline": round(rays_per_s / (n_chips * 1_000_000.0), 4),
    }
    if chain != 1:
        rec["chain"] = chain
    rec.update(_device_fields())
    print(json.dumps(rec))


def _samples() -> tuple:
    s = os.environ.get("NERF_BENCH_SAMPLES", "64,128")
    nc, nf = (int(v) for v in s.split(","))
    return nc, nf


def _accel_res() -> int:
    return int(os.environ.get("NERF_BENCH_ACCEL_RES", "128"))


def _metric_name(impl=None, dtype=None, accel=None) -> str:
    """One metric string shared by the success and error records, so
    metric-keyed joins of bench history see the same benchmark across
    healthy and failed rows. Error paths use the env-derived defaults;
    success paths pass the values that actually ran. (Success records
    append ', N chip(s)'.)"""
    mode = os.environ.get("NERF_BENCH_MODE", "render")
    size = os.environ.get("NERF_BENCH_SIZE", "800")
    if impl is None:
        impl = os.environ.get("NERF_BENCH_IMPL", "xla")
    if dtype is None:
        dtype = os.environ.get("NERF_BENCH_DTYPE", "bfloat16")
    if accel is None:
        # "auto" (the default) intends the accel path in render mode (error
        # records during an outage are named for the config that would have
        # run) but means OFF in train mode (no PSNR guard) and in student
        # (NERF_BENCH_ARCH) runs (random weights — main forces accel off),
        # so error records join the same metric series as success records.
        env = os.environ.get("NERF_BENCH_ACCEL", "auto")
        off = ("0", "", "false", "auto") if mode == "train" else ("0", "", "false")
        accel = env not in off and not os.environ.get("NERF_BENCH_ARCH")
    nc, nf = _samples()
    accel_tag = ""
    if accel:
        res = _accel_res()
        accel_tag = "+accel" if res == 128 else f"+accel{res}"
        # Every accel tuning knob lands in the name: differently-configured
        # runs must not alias one metric series (this string is the join key
        # for bench history).
        if os.environ.get("NERF_BENCH_ACCEL_T"):
            accel_tag += f"+t{os.environ['NERF_BENCH_ACCEL_T']}"
        if os.environ.get("NERF_BENCH_ACCEL_THRESH"):
            accel_tag += f"+thr{os.environ['NERF_BENCH_ACCEL_THRESH']}"
        if os.environ.get("NERF_BENCH_ACCEL_SLACK"):
            accel_tag += f"+slack{os.environ['NERF_BENCH_ACCEL_SLACK']}"
        probes = os.environ.get("NERF_BENCH_AABB_PROBES", "32")
        if os.environ.get("NERF_BENCH_ACCEL_AABB", "0") not in ("0", "", "false"):
            accel_tag += "+aabb"
            if probes not in ("0", ""):
                accel_tag += f"+probes{probes}"
        elif probes not in ("0", ""):
            # Probe-based ray culling WITHOUT placement change
            # (accel_compact=off): placement-exact, packing-only.
            accel_tag += f"+probecull{probes}"
        if os.environ.get("NERF_BENCH_RANGE_STRIDE", "4") != "1":
            accel_tag += f"+stride{os.environ.get('NERF_BENCH_RANGE_STRIDE', '4')}"
        # accel semantics changed 2026-08-18: the default is now mask-only
        # culling + ray-level packing (no per-sample compaction). Tag any
        # non-default combination so metric series don't alias ("off" =
        # no per-sample culling at all, packing/placement only).
        if os.environ.get("NERF_ACCEL_COMPACT", "off") != "none":
            accel_tag += f"+c{os.environ.get('NERF_ACCEL_COMPACT', 'off')}"
        if os.environ.get("NERF_BENCH_CULL_RAYS", "1") in ("0", "false"):
            accel_tag += "+noraycull"
    suffix = f"{impl}/{dtype}" + accel_tag
    if os.environ.get("NERF_BENCH_ARCH"):
        suffix += f"+arch{os.environ['NERF_BENCH_ARCH']}"
    if os.environ.get("NERF_BENCH_WEIGHTS"):
        suffix += "+customweights"
    if os.environ.get("NERF_BENCH_MODEL", "mlp") != "mlp":
        suffix += f"+{os.environ.get('NERF_BENCH_MODEL')}"
        if os.environ.get("NERF_HASH_GRAD", "scatter") != "scatter":
            suffix += f"+g{os.environ['NERF_HASH_GRAD']}"
    if os.environ.get("NERF_BENCH_CHECKPOINT"):
        suffix += "+checkpoint"
    if os.environ.get("NERF_BENCH_CHUNK", "16384") != "16384":
        suffix += f"+chunk{os.environ['NERF_BENCH_CHUNK']}"
    if mode == "train":
        return f"train rays/s (fwd+bwd+opt), {nc}+{nf} samples, {suffix}"
    return f"fwd render rays/s, lego {size}x{size} {nc}+{nf} samples, {suffix}"


def _psnr_db(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return round(-10.0 * math.log10(max(mse, 1e-12)), 1)


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them (a card
    set below its maximum runs slower under load, so every record carries
    it); "" where nvidia-smi is absent or fails (CPU hosts)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def _device_fields() -> dict:
    """Device identity for a record: JAX's platform, device_kind and
    device count, plus the nvidia-smi name/power-limit line."""
    import jax

    d = jax.devices()[0]
    return {"device": {"platform": d.platform, "kind": d.device_kind,
                       "count": jax.device_count()},
            "power_limit": _power_limit()}


def _print_error_record(msg: str) -> None:
    print(json.dumps({
        "metric": _metric_name(), "value": 0.0, "unit": "rays/s",
        "vs_baseline": 0.0, "error": msg, **_device_fields(),
    }), flush=True)


# --- frontier presets -----------------------------------------------------
# The bare invocation also emits the rays/s-vs-quality frontier (vendored
# weights) as EXTRA JSON lines BEFORE the lossless headline: consumers read
# the LAST line, so the headline series is unchanged.
_FRONTIER_PRESETS = (
    # The quality flagship: the vendored single-pass fine-tuned TEACHER,
    # 64+0 samples with probe-refined placement, judged against the full
    # 64+128 teacher render.
    ("tsp_s64x0_probe", {
        "NERF_BENCH_WEIGHTS": "assets/trained/teacher_sp30",
        "NERF_BENCH_SAMPLES": "64,0",
        "NERF_BENCH_ACCEL": "1",
        "NERF_BENCH_ACCEL_AABB": "1",
        # Sub-second single-pass frames: min-of-8.
        "NERF_BENCH_REPEATS": "8",
    }),
    # The speed flagship: the single-pass fine-tuned 128-wide student.
    ("sp29_s64x0_probe", {
        "NERF_BENCH_WEIGHTS": "assets/trained/student128_sp29",
        "NERF_BENCH_SAMPLES": "64,0",
        "NERF_BENCH_ACCEL": "1",
        "NERF_BENCH_ACCEL_AABB": "1",
        "NERF_BENCH_REPEATS": "8",
    }),
    # Train throughput at the production single-pass distill config (the
    # BASELINE.md >=1 M rays/s/chip training target).
    ("train_student_s64x0_b65536", {
        "NERF_BENCH_MODE": "train",
        "NERF_BENCH_ARCH": "128,64",
        "NERF_BENCH_SAMPLES": "64,0",
        "NERF_BENCH_TRAIN_RAYS": "65536",
        "NERF_BENCH_REPEATS": "5",
    }),
    # Distilled student at the FULL 64+128 headline sampling + lossless
    # probe culling.
    ("student30_800q", {
        "NERF_BENCH_WEIGHTS": "assets/trained/student128_30db",
    }),
)


def _frontier_presets_due() -> bool:
    """Presets run only on the bare headline invocation (`python bench.py`):
    on the GPU, render mode, no env overrides that make this some other
    sweep leg. NERF_BENCH_EXTRA=0 opts out; CPU smokes
    (NERF_BENCH_PLATFORM=cpu) must stay one-line (tests/test_bench.py).
    Decided from the environment alone: the parent must not touch the
    device before its preset children have run (_run_frontier_presets)."""
    if os.environ.get("NERF_BENCH_EXTRA", "1") in ("0", "false"):
        return False
    plat = os.environ.get("NERF_BENCH_PLATFORM", "")
    if plat and plat not in ("gpu", "cuda"):
        return False
    overrides = ("NERF_BENCH_MODE", "NERF_BENCH_SIZE", "NERF_BENCH_SAMPLES",
                 "NERF_BENCH_WEIGHTS", "NERF_BENCH_CHECKPOINT",
                 "NERF_BENCH_ARCH", "NERF_BENCH_MODEL", "NERF_BENCH_IMPL",
                 "NERF_BENCH_DTYPE", "NERF_BENCH_CHUNK",
                 # Accel/timing knobs too: a sweep leg that sets any of
                 # these is NOT the bare headline run, and presets must
                 # not inherit its unrelated overrides.
                 "NERF_BENCH_ACCEL", "NERF_BENCH_ACCEL_AABB",
                 "NERF_BENCH_AABB_PROBES", "NERF_BENCH_RANGE_STRIDE",
                 "NERF_BENCH_ACCEL_RES", "NERF_BENCH_ACCEL_T",
                 "NERF_BENCH_ACCEL_THRESH", "NERF_BENCH_ACCEL_SLACK",
                 "NERF_BENCH_REPEATS")
    return not any(os.environ.get(v) for v in overrides)


def _run_frontier_presets(t0: float) -> None:
    """Run each preset as a SUBPROCESS (fresh env-derived config) and
    re-emit its last JSON record tagged with the preset name. A preset
    failure never harms the headline leg.

    The children run strictly before the parent initializes its own JAX
    backend: a JAX process reserves most of the card's memory when it
    first uses it, so a child started while the parent holds the card
    would fail for want of memory (and two processes computing at once
    would spoil each other's times)."""
    import subprocess

    repo = os.path.dirname(os.path.abspath(__file__))
    deadline = float(os.environ.get("NERF_BENCH_DEADLINE", "2400"))
    reserve = 900.0   # wall-clock kept for the headline leg
    for name, env_over in _FRONTIER_PRESETS:
        if deadline <= 0:
            # Operator disabled the deadline: children inherit that
            # (cold-cache compiles may legitimately exceed any budget).
            remaining, budget = 1e9, 1e9
        else:
            remaining = deadline - (time.monotonic() - t0)
            budget = min(700.0, remaining - reserve)
        if budget < 240.0:
            print(f"frontier preset {name}: skipped "
                  f"({remaining:.0f}s left, reserved for the headline leg)",
                  file=sys.stderr, flush=True)
            continue
        env = dict(os.environ)
        env.update(env_over)
        if "NERF_BENCH_WEIGHTS" in env_over:
            env["NERF_BENCH_WEIGHTS"] = os.path.join(
                repo, env_over["NERF_BENCH_WEIGHTS"])
        env["NERF_BENCH_EXTRA"] = "0"        # no recursion
        try:
            out = subprocess.run([sys.executable, os.path.abspath(__file__)],
                                 cwd=repo, env=env, capture_output=True,
                                 text=True,
                                 timeout=None if deadline <= 0
                                 else budget + 120)
        except subprocess.TimeoutExpired:
            print(f"frontier preset {name}: timed out after {budget:.0f}s",
                  file=sys.stderr, flush=True)
            continue
        rec = None
        for line in out.stdout.splitlines():
            if line.strip().startswith("{"):
                try:
                    rec = json.loads(line)   # last JSON line wins
                except ValueError:
                    pass
        if rec is None:
            print(f"frontier preset {name}: no record (rc={out.returncode}) "
                  f"{out.stderr[-300:]}", file=sys.stderr, flush=True)
            continue
        rec["preset"] = name
        print(json.dumps(rec), flush=True)


def main() -> None:
    # Accel defaults: NO per-sample culling + probe-based ray packing on
    # stride-4 subsampled ranges, 32 probes. Explicit env values override.
    # Set before any record can print so error records join the same
    # metric series. Evaluate the frontier-preset gate BEFORE the
    # setdefault block: the defaults below make NERF_BENCH_AABB_PROBES/
    # RANGE_STRIDE "set", and the gate's override check must see the
    # CALLER's env, not our own defaults.
    presets_due = _frontier_presets_due()
    os.environ.setdefault("NERF_ACCEL_COMPACT", "off")
    os.environ.setdefault("NERF_BENCH_AABB_PROBES", "32")
    os.environ.setdefault("NERF_BENCH_RANGE_STRIDE", "4")
    import jax

    if os.environ.get("NERF_BENCH_PLATFORM"):
        # Smoke-test hatch (e.g. =cpu), applied before the first device use.
        jax.config.update("jax_platforms", os.environ["NERF_BENCH_PLATFORM"])
    from nerf_rs_tpu.utils import enable_compile_cache

    enable_compile_cache()
    if presets_due:
        # BEFORE the parent's own backend init (see _run_frontier_presets).
        _run_frontier_presets(time.monotonic())

    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.render import render_image

    size = int(os.environ.get("NERF_BENCH_SIZE", "800"))
    impl = os.environ.get("NERF_BENCH_IMPL", "xla")
    dtype = os.environ.get("NERF_BENCH_DTYPE", "bfloat16")
    repeats = int(os.environ.get("NERF_BENCH_REPEATS", "3"))
    # Default "auto": try the occupancy-culled fast path, keep it ONLY if it
    # beats the 40 dB accel contract vs the exact render, else report a
    # measured exact-path number instead. A plain `python bench.py` thus
    # lands the best *honest* number available without per-round env tuning.
    accel_env = os.environ.get("NERF_BENCH_ACCEL", "auto")
    accel_auto = accel_env == "auto"
    accel = accel_auto or accel_env not in ("0", "", "false")

    nc, nf = _samples()
    # NERF_BENCH_CHUNK: rays per lax.map chunk. 16384 is the measured
    # sweet spot at 64+128 (192 merged samples); reduced/single-pass
    # presets fit 4x more rays per chunk and amortize per-chunk kernel
    # overhead — an A/B axis for the s64x0 frontier.
    chunk = int(os.environ.get("NERF_BENCH_CHUNK", "16384"))
    cfg = RenderConfig(n_coarse=nc, n_fine=nf, ray_chunk=chunk, impl=impl,
                       dtype=dtype)
    if os.environ.get("NERF_BENCH_ACCEL_AABB", "0") not in ("0", "", "false"):
        cfg = cfg.replace(accel_sample_aabb=True)
    # Probe culling defaults ON (32 probes, "0" disables): with the
    # stride-4 + compact-off defaults this makes a BARE `python bench.py`
    # run the lossless probe-cull accel config. The auto race still
    # reports the exact path whenever culling loses (small frames).
    if os.environ.get("NERF_BENCH_AABB_PROBES", "32") not in ("0", ""):
        cfg = cfg.replace(
            accel_aabb_probes=int(os.environ.get("NERF_BENCH_AABB_PROBES",
                                                 "32")))
    if "NERF_BENCH_ACCEL_T" in os.environ:
        cfg = cfg.replace(accel_t_threshold=float(os.environ["NERF_BENCH_ACCEL_T"]))
    if "NERF_BENCH_ACCEL_SLACK" in os.environ:
        cfg = cfg.replace(accel_t_slack_bins=float(os.environ["NERF_BENCH_ACCEL_SLACK"]))
    # Accel-mode shape: no per-sample culling + ray-level packing
    # (background rays never rendered).
    # NERF_ACCEL_COMPACT=none|scatter|gather enables per-sample culling;
    # NERF_BENCH_CULL_RAYS=0 disables the packing. A/B knobs, off-default.
    cfg = cfg.replace(
        accel_compact=os.environ.get("NERF_ACCEL_COMPACT", "off"),
        accel_cull_rays=os.environ.get("NERF_BENCH_CULL_RAYS", "1")
        not in ("0", "false"),
        accel_range_stride=int(os.environ.get("NERF_BENCH_RANGE_STRIDE",
                                              "4")),
    )
    model_env = os.environ.get("NERF_BENCH_MODEL", "mlp")
    if model_env == "hashgrid":
        # Hash-grid family throughput (models/hashgrid.py) at the default
        # full-size HashGridConfig. Render mode uses random-init params
        # (rays/s is weight-value-independent) unless NERF_BENCH_CHECKPOINT
        # points at a trained one; train mode measures full steps. impl
        # applies to the MLP family only — keep the metric label honest.
        # ray_chunk shrinks to 4096: the encode's gather intermediates are
        # ~300 KB/ray (idx + feats + trilinear weights at L=16x8 corners x
        # 192 samples), ~5 GB per 16384-ray chunk.
        impl = "xla"
        cfg = cfg.replace(
            model="hashgrid", impl="xla",
            ray_chunk=min(cfg.ray_chunk, 4096),
            # Table-gradient path A/B (NERF_HASH_GRAD=sorted for the
            # segment-sum VJP; scatter won the 2026-08-19 A/B, 556 vs 335
            # rays/s — see HashGridConfig.grad_impl).
            hash=cfg.hash.replace(
                grad_impl=os.environ.get("NERF_HASH_GRAD", "scatter")))
    if os.environ.get("NERF_BENCH_MODE", "render") == "train":
        return _bench_train(cfg, repeats)

    assets = find_lego_assets()
    if assets is None:
        print(json.dumps({"metric": "rays/s fwd lego", "value": 0.0, "unit": "rays/s",
                          "vs_baseline": 0.0, "error": "assets missing"}))
        return
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    arch_env = os.environ.get("NERF_BENCH_ARCH")
    weights_env = os.environ.get("NERF_BENCH_WEIGHTS")
    ckpt_env = os.environ.get("NERF_BENCH_CHECKPOINT")
    student = bool(arch_env)
    if ckpt_env:
        # A trained checkpoint of ANY family (cli train output): hashgrid
        # checkpoints carry their hyper-parameters in the model.json
        # sidecar; MLP-family ones are shape-inferred. Accel stays
        # available — the grid is swept with the checkpoint's own field.
        from nerf_rs_tpu.io.checkpoint import (
            hashgrid_render_config, load_model_config, restore_params,
        )
        from pathlib import Path as _P

        loaded, _step = restore_params(ckpt_env)
        loaded = jax.device_put(loaded)
        if "shared" in loaded:
            info = load_model_config(_P(ckpt_env))
            if info is None or info.get("model") != "hashgrid":
                _print_error_record(
                    f"{ckpt_env} is a shared-network checkpoint with no "
                    "model.json sidecar")
                return
            cfg = hashgrid_render_config(info, cfg)
            # Same OOM guard as the random-init hashgrid branch below.
            cfg = cfg.replace(ray_chunk=min(cfg.ray_chunk, 4096))
            params_c = params_f = loaded["shared"]
            # Keep the metric label honest even when NERF_BENCH_MODEL was
            # not set alongside the checkpoint: impl does not apply to the
            # family, and _metric_name derives the '+hashgrid' tag from
            # the env var (hashgrid and MLP checkpoints must not alias one
            # metric-keyed series).
            impl = "xla"
            cfg = cfg.replace(impl="xla")
            os.environ["NERF_BENCH_MODEL"] = "hashgrid"
        else:
            params_c, params_f = loaded["coarse"], loaded["fine"]
    elif model_env == "hashgrid":
        # Random-init hash-grid throughput: speed side of the family before
        # one is trained. Accel/PSNR machinery is skipped (random tables
        # give a near-uniform density field — a grid would cull nothing
        # meaningful).
        from nerf_rs_tpu.models.hashgrid import init_hashgrid_params

        params_c = params_f = jax.device_put(
            init_hashgrid_params(jax.random.key(1), cfg.hash))
        accel = False
    elif arch_env:
        # Student-architecture throughput (ArchConfig family): random-init
        # params — rays/s is weight-value-independent, so this measures the
        # speed side of a distilled student before one is trained.
        # Accel/PSNR machinery is skipped (meaningless on random weights).
        from nerf_rs_tpu.config import ArchConfig
        from nerf_rs_tpu.models.mlp import init_nerf_params

        dims = [int(v) for v in arch_env.split(",")]
        dims += [256, 128, 8, 4][len(dims):]
        arch = ArchConfig(width=dims[0], v_width=dims[1],
                          depth=dims[2], skip_at=dims[3])
        params_c = jax.device_put(init_nerf_params(jax.random.key(1), arch=arch))
        params_f = jax.device_put(init_nerf_params(jax.random.key(2), arch=arch))
        accel = False
    elif weights_env:
        # Trained weights from anywhere (e.g. a distilled-student export):
        # a .npz bundle or a reference-format directory with coarse/ + fine/.
        from nerf_rs_tpu.io.weights import load_scene_assets

        from pathlib import Path as _P
        p = _P(weights_env)
        if p.is_file():
            loaded, _ = load_scene_assets(p)
        else:
            loaded = {"coarse": load_nerf_params(p / "coarse"),
                      "fine": load_nerf_params(p / "fine")}
        params_c, params_f = loaded["coarse"], loaded["fine"]
    else:
        params_c = load_nerf_params(assets / "coarse")
        params_f = load_nerf_params(assets / "fine")

    import numpy as np

    key = jax.random.key(0)

    def timed(grid):
        # Warmup / compile, then timed repeats, each ending in
        # block_until_ready (the device finishes the frame in the window).
        img = render_image(params_c, params_f, camera, size, size, key, cfg,
                           grid=grid)
        jax.block_until_ready(img)
        times = []
        for i in range(repeats):
            t0 = time.perf_counter()
            img = render_image(params_c, params_f, camera, size, size,
                               jax.random.fold_in(key, i), cfg, grid=grid)
            jax.block_until_ready(img)
            times.append(time.perf_counter() - t0)
        # The frame itself transfers once, outside the timed loop — the
        # PSNR guards below need host pixels either way.
        return np.asarray(img), min(times)

    grid = None
    auto_note = None
    if accel:
        try:
            from nerf_rs_tpu.accel import build_scene_grid, calibrate_capacities

            from nerf_rs_tpu.accel import hashgrid_grid_kwargs

            grid_kw = (hashgrid_grid_kwargs(cfg)
                       if cfg.model == "hashgrid" else {})
            if os.environ.get("NERF_BENCH_ACCEL_THRESH"):
                # Grid tightness (tools/grid_threshold_study.py): higher
                # sigma thresholds shrink the occupied set -> more rays
                # packed away, tighter AABB/probe spans. PSNR-guarded like
                # every accel knob.
                grid_kw["sigma_threshold"] = float(
                    os.environ["NERF_BENCH_ACCEL_THRESH"])
            grid = build_scene_grid(params_c, params_f,
                                    resolution=_accel_res(), **grid_kw)
            if cfg.accel_compact not in ("none", "off"):
                # Measured capacities: one instrumented render, then the
                # timed renders run with the post-culling live set + 15%
                # margin. Mask-only culling has no capacities to calibrate.
                cfg = calibrate_capacities(params_c, params_f, grid, camera,
                                           size, size, key, cfg)
        except Exception as e:  # degenerate grid, etc.
            if not accel_auto:
                raise
            grid, accel = None, False
            auto_note = f"accel auto-disabled: {type(e).__name__}: {e}"

    img, best = timed(grid)

    accel_psnr = None
    if accel:
        # Guard: a fast accel number only counts if the image still matches
        # the exact path (the accel contract is >40 dB, tests/test_accel.py).
        exact = render_image(params_c, params_f, camera, size, size,
                             jax.random.fold_in(key, repeats - 1), cfg)
        accel_psnr = _psnr_db(exact, img)
        if accel_psnr < 40.0 and accel_auto and not cfg.accel_sample_aabb:
            # Auto mode: below the contract, fall back to a MEASURED exact
            # run so the round still lands a valid number. (Placement-
            # changing aabb configs are judged on full_psnr_db instead —
            # see the invalidation exemption below.)
            auto_note = (f"accel auto-rejected: psnr {accel_psnr} dB < 40 dB "
                         "contract — reporting the exact path")
            grid, accel = None, False
            img, best = timed(None)
        elif accel_auto:
            # Auto mode is a RACE, not a PSNR check alone: time the exact
            # path too and keep whichever is faster — the accel path's
            # ranges/pack/scatter programs can lose to the dense pipeline
            # even when its image is fine, and auto must never report a
            # slower-than-exact headline.
            img_exact, best_exact = timed(None)
            if best_exact < best:
                auto_note = (
                    f"accel auto-rejected: slower than exact "
                    f"({size * size / best:.0f} vs {size * size / best_exact:.0f}"
                    " rays/s) — reporting the exact path")
                grid, accel = None, False
                img, best = img_exact, best_exact

    n_rays = size * size
    rays_per_s = n_rays / best
    n_chips = jax.device_count()
    result = {
        "metric": f"{_metric_name(impl=impl, dtype=dtype, accel=accel)}, {n_chips} chip(s)",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / (n_chips * 10_000_000.0), 4),
    }
    if accel_psnr is not None and accel:
        result["accel_psnr_db"] = accel_psnr
        if accel_psnr < 40.0 and not cfg.accel_sample_aabb:
            # Explicit NERF_BENCH_ACCEL=1 below the contract: the fast
            # number is invalid (e.g. a capacity overflow zeroed real
            # samples) — flag it so metric-keyed history cannot ingest it
            # as a real speedup. Placement-changing configs (aabb/probes)
            # are exempt: vs the same-count exact render their PSNR is
            # bounded by stratified-sampling chaos, not error — their
            # quality axis is full_psnr_db (the 64+128 reference), which
            # frontier consumers read directly.
            result["vs_baseline"] = 0.0
            result["error"] = (
                f"accel_psnr_db {accel_psnr} < 40 dB contract — speedup invalid "
                "(capacity overflow / mis-calibrated grid?)"
            )
    result.update(_device_fields())
    if auto_note:
        result["note"] = auto_note
    if student:
        result["student_arch"] = arch_env
    if (nc, nf) != (64, 128) and not student:
        # Quality axis of the rays/s-vs-PSNR frontier: reduced-sample runs
        # (e.g. the reference's own 32+64 wasm preset) report PSNR vs the
        # full-quality 64+128 exact render. Informational, not a guard —
        # the sample-count trade-off is the point of these configs.
        full_cfg = cfg.replace(n_coarse=64, n_fine=128)
        full = render_image(params_c, params_f, camera, size, size,
                            jax.random.fold_in(key, repeats - 1), full_cfg)
        result["full_psnr_db"] = _psnr_db(full, img)
    if ((weights_env or ckpt_env)
            and os.environ.get("NERF_BENCH_TEACHER_PSNR", "1") not in ("0", "false")):
        # Trained-weights runs additionally report quality against the
        # PRETRAINED teacher's full 64+128 exact render at the SAME
        # resolution — the axis a reference user actually compares on
        # (the reference's whole value is its pretrained quality,
        # /root/reference/src/lib.rs:732-742). full_psnr_db above is
        # self-referential (same weights, full samples); this one pins the
        # trained artifact to the ground-truth field.
        from nerf_rs_tpu.config import RenderConfig as _RC

        # Clamp the teacher render's chunk: single-pass presets bench with
        # NERF_BENCH_CHUNK up to 65536, but the TEACHER renders at full
        # 64+128 (192 merged samples), 3x the per-ray memory — an
        # unclamped chunk can run out of device memory in exactly the
        # configs this axis targets. And never let a teacher-reference
        # failure void the measured record: emit without teacher_psnr_db
        # instead.
        try:
            teacher_cfg = _RC(n_coarse=64, n_fine=128,
                              ray_chunk=min(cfg.ray_chunk, 16384),
                              impl="xla", dtype=dtype)
            teacher = render_image(load_nerf_params(assets / "coarse"),
                                   load_nerf_params(assets / "fine"),
                                   camera, size, size,
                                   jax.random.fold_in(key, repeats - 1),
                                   teacher_cfg)
            result["teacher_psnr_db"] = _psnr_db(teacher, img)
        except Exception as e:
            result["note"] = (result.get("note", "") +
                              f" teacher_psnr_db failed: "
                              f"{type(e).__name__}: {str(e)[:200]}").strip()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
