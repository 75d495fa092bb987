#!/usr/bin/env python3
"""Smoke test of the main paths on one GPU: render, train and serve.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the sharded path only

Runs as ONE process (a JAX process reserves most of a card's memory when it
first uses it, so a second process on the same card would fail). Phases,
in order; any failure raises, exits nonzero and prints no result line:

1. device   JAX's default backend must be the GPU; the card's name and
            power limit come from nvidia-smi (and must be readable).
2. numerics f32 MLP on the card vs the same MLP on the host CPU backend,
            and the TF golden samples (tolerances: TOL_* below).
3. teacher  800x800, 64+128 samples: exact path (f32 and bf16) and the
            culled headline path (occupancy grid, 32 probes, stride 4,
            accel_compact="off"), timed; bf16 vs f32 and culled vs exact
            PSNR.
4. single   the vendored single-pass artifacts (student128_sp29,
            teacher_sp30) at 64+0 with probe-placed samples, timed, with
            their PSNR against the teacher's exact frame.
5. train    a few distillation steps through ``python -m nerf_rs_tpu
            train`` (cli.main), saved, restored and one more step.
6. serve    an in-process ThreadingHTTPServer answers /render requests
            through api.render_image_rgba.
7. legs     hash-grid family (render + one train step) and --impl int8.

Every timing line names the card and its power limit. The last line of
standard output is the JSON result the driver reads.

Each ``phase_*`` function takes a ``Scale`` so the tests can run the same
code at a tiny size on the CPU (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# Tolerances, each with its reason.
# f32 MLP, card vs host CPU at HIGHEST precision: both are true-f32 GEMMs
# that differ only in summation order. rgb (in [0, 1]) must agree to 1e-4
# absolute. sigma reaches ~1000 on lego, and eight layers of 256-term sums
# with cancellation leave ~2e-5 relative (3.7e-4 absolute) between two
# f32 orders on the H100, so sigma is held to 1e-4 RELATIVE to
# max(1, |sigma|) — still 10x under what a TF32 path (~1e-3) would show.
TOL_MLP_F32 = 1e-4
# The TF reference's golden samples: the reference test's own bar
# (lib.rs:753-916, tests/test_golden.py).
TOL_GOLDEN = 1e-2
# bf16 frame vs f32 frame, same key: bf16 operands with f32 accumulation
# hold ~47 dB at the CPU test size; 40 dB is the repo's image contract.
MIN_PSNR_BF16 = 40.0
# Culled (accel) frame vs exact frame: the accel contract (bench.py,
# tests/test_accel.py).
MIN_PSNR_ACCEL = 40.0
# Single-pass artifacts vs the teacher's exact frame at 800x800 (Scale's
# min_single_pass_db): they were trained to ~29-30 dB at 64+0 against the
# full 64+128 teacher (assets/trained/*/summary.json); 25 dB catches a
# broken path without pinning training quality.
# int8 W8A8 vs f32, same key: post-training per-row int8 keeps ~39 dB on
# CPU numerics (tools/int8_study.py); 30 dB catches a broken lowering.
MIN_PSNR_INT8 = 30.0
# Sharded vs single-device render: bitwise equal on CPU devices (per-ray
# RNG keyed by global ray index); on cards XLA may pick other GEMM
# algorithms per program, so up to 1e-5 is accepted with a printed reason.
TOL_SHARDED_RENDER = 1e-5
# Data-parallel step vs single device, same global batch: the pmean of
# per-shard mean losses equals the global mean up to f32 rounding.
TOL_SHARDED_LOSS = 1e-6


@dataclasses.dataclass(frozen=True)
class Scale:
    """Sizes of one run. The defaults are the real ones (the card); the
    tests pass tiny ones."""

    size: int = 800                 # frame side for the teacher/artifacts
    samples: tuple = (64, 128)      # teacher (coarse, fine) samples
    single_pass: int = 64           # coarse samples of the 64+0 artifacts
    ray_chunk: int = 16384
    grid_res: int = 128
    probes: int = 32
    stride: int = 4
    mlp_rays: int = 4096            # x 16 samples = 65536 MLP samples
    train_batch: int = 8192
    train_steps: int = 3
    train_probes: int = 128
    serve_size: int = 256
    leg_size: int = 64
    leg_samples: tuple = (32, 64)
    repeats: int = 2
    # The artifacts' PSNR floor holds at the real size and sample counts
    # only (see the tolerances above).
    min_single_pass_db: float = 25.0


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def psnr_db(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return -10.0 * math.log10(max(mse, 1e-20))


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi could not be run: {e}") from e
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and bool(lines),
          f"nvidia-smi failed (rc {out.returncode}): {out.stderr.strip()}")
    return lines[0].strip()


class Log:
    """Prints phase lines; timings carry the card line beside them."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, msg: str) -> None:
        print(msg, flush=True)

    def timing(self, what: str, seconds: float, extra: str = "") -> None:
        print(f"  time {what}: {seconds * 1e3:.1f} ms{extra} [{self.card}]",
              flush=True)


def _timed(fn, repeats: int):
    """(result, first-call seconds incl. compile, best steady seconds).
    ``fn`` renders with a fixed key, so every call computes the same
    frame."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def _scene():
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params

    assets = find_lego_assets()
    check(assets is not None, "pretrained lego assets not found")
    teacher = {"coarse": load_nerf_params(assets / "coarse"),
               "fine": load_nerf_params(assets / "fine")}
    golden = load_golden(assets / "tf_reference_samples.json")
    return assets, teacher, golden, camera_from_golden(golden)


def _headline_cfg(sc: Scale, **kw):
    from nerf_rs_tpu.config import RenderConfig

    nc, nf = sc.samples
    return RenderConfig(n_coarse=nc, n_fine=nf, ray_chunk=sc.ray_chunk, **kw)


# ---------------------------------------------------------------- phases


def phase_numerics(sc: Scale, log: Log) -> None:
    """f32 MLP on the default device vs the host CPU backend, and the TF
    golden samples on the default device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nerf_rs_tpu.io.golden import golden_examples
    from nerf_rs_tpu.models.mlp import nerf_mlp
    from nerf_rs_tpu.ops.rays import camera_rays

    _, teacher, golden, camera = _scene()
    side = int(math.isqrt(sc.mlp_rays))
    _, dirs = camera_rays(camera, side, side)
    dirs = np.asarray(dirs).reshape(-1, 3)
    t = np.linspace(2.0, 6.0, 16, dtype=np.float32)
    pts = (np.asarray(camera.position, np.float32)[None, None]
           + dirs[:, None] * t[None, :, None])
    view = np.broadcast_to(dirs[:, None], pts.shape)
    mlp = jax.jit(nerf_mlp)
    rgb_d, sig_d = mlp(teacher["fine"], jnp.asarray(pts), jnp.asarray(view))
    cpu = jax.devices("cpu")[0]
    rgb_h, sig_h = mlp(jax.device_put(teacher["fine"], cpu),
                       jax.device_put(pts, cpu), jax.device_put(view, cpu))
    err_rgb = float(np.abs(np.asarray(rgb_d) - np.asarray(rgb_h)).max())
    d_sig = np.abs(np.asarray(sig_d) - np.asarray(sig_h))
    err_sig = float(d_sig.max())
    rel_sig = float((d_sig / np.maximum(np.abs(np.asarray(sig_h)), 1.0)).max())
    log(f"  f32 MLP, {pts.shape[0] * pts.shape[1]} lego samples, "
        f"{jax.devices()[0].platform} vs host cpu: max abs err rgb "
        f"{err_rgb:.2e}, sigma {err_sig:.2e} (max sigma "
        f"{float(np.asarray(sig_h).max()):.1f}, max rel err {rel_sig:.2e}; "
        f"tol {TOL_MLP_F32:g} abs on rgb, relative on sigma)")
    check(err_rgb <= TOL_MLP_F32 and rel_sig <= TOL_MLP_F32,
          f"f32 MLP differs from the host reference: rgb {err_rgb:.2e}, "
          f"sigma relative {rel_sig:.2e} (tol {TOL_MLP_F32:g})")

    worst = 0.0
    for net in ("coarse", "fine"):
        for ex in golden_examples(golden):
            p = ex["ray_o"][None] + ex["ray_d"][None] * ex["z_vals"][:, None]
            d = np.broadcast_to(ex["viewdir_unit"], p.shape)
            rgb, sig = mlp(teacher[net], jnp.asarray(p), jnp.asarray(d))
            worst = max(worst,
                        float(np.abs(np.asarray(sig) - ex[f"{net}_sigma"]).max()),
                        float(np.abs(np.asarray(rgb) - ex[f"{net}_rgb"]).max()))
    log(f"  golden samples (coarse+fine): worst abs err {worst:.2e} "
        f"(tol {TOL_GOLDEN:g})")
    check(worst <= TOL_GOLDEN, f"golden samples off by {worst:.2e}")


def phase_teacher(sc: Scale, log: Log):
    """The pretrained teacher at the headline frame: f32 exact (the
    reference frame), bf16 exact and bf16 culled. Returns the f32 frame."""
    import jax
    import numpy as np

    from nerf_rs_tpu.accel import build_scene_grid
    from nerf_rs_tpu.render import render_image

    _, teacher, _, camera = _scene()
    pc, pf = teacher["coarse"], teacher["fine"]
    key = jax.random.key(0)
    nc, nf = sc.samples
    n = sc.size * sc.size
    tag = f"{sc.size}x{sc.size} {nc}+{nf}"

    def run(cfg, grid=None):
        img, first, best = _timed(
            lambda: render_image(pc, pf, camera, sc.size, sc.size, key, cfg,
                                 grid=grid), sc.repeats)
        return np.asarray(img), first, best

    f32, first, best = run(_headline_cfg(sc))
    log.timing(f"teacher {tag} f32 exact frame", best,
               f", {n / best:,.0f} rays/s, first call {first:.1f} s")
    bf16_cfg = _headline_cfg(sc, dtype="bfloat16")
    bf16, first, best = run(bf16_cfg)
    log.timing(f"teacher {tag} bf16 exact frame", best,
               f", {n / best:,.0f} rays/s, first call {first:.1f} s")
    t0 = time.perf_counter()
    grid = jax.block_until_ready(build_scene_grid(pc, pf,
                                                  resolution=sc.grid_res))
    log.timing(f"occupancy grid {sc.grid_res}^3 build (incl. compile)",
               time.perf_counter() - t0)
    cull_cfg = bf16_cfg.replace(accel_aabb_probes=sc.probes,
                                accel_range_stride=sc.stride,
                                accel_compact="off", accel_cull_rays=True)
    culled, first, best = run(cull_cfg, grid)
    log.timing(f"teacher {tag} bf16 culled frame (probes {sc.probes}, "
               f"stride {sc.stride})", best,
               f", {n / best:,.0f} rays/s, first call {first:.1f} s")

    for name, img in (("f32", f32), ("bf16", bf16), ("culled", culled)):
        check(img.shape == (sc.size, sc.size, 3) and np.isfinite(img).all(),
              f"{name} frame: bad shape {img.shape} or non-finite values")
    p_bf16 = psnr_db(bf16, f32)
    p_cull = psnr_db(culled, bf16)
    log(f"  bf16 vs f32 exact frame: {p_bf16:.2f} dB (min {MIN_PSNR_BF16})")
    log(f"  culled vs exact bf16 frame: {p_cull:.2f} dB (min {MIN_PSNR_ACCEL})")
    check(p_bf16 >= MIN_PSNR_BF16, f"bf16 frame {p_bf16:.2f} dB < {MIN_PSNR_BF16}")
    check(p_cull >= MIN_PSNR_ACCEL, f"culled frame {p_cull:.2f} dB < {MIN_PSNR_ACCEL}")
    return f32


def phase_single_pass(sc: Scale, log: Log, reference) -> None:
    """The vendored single-pass artifacts at 64+0 with probe-placed
    samples, against the teacher's exact f32 frame."""
    import jax
    import numpy as np

    from nerf_rs_tpu.accel import build_scene_grid
    from nerf_rs_tpu.io.weights import load_nerf_params
    from nerf_rs_tpu.render import render_image
    from nerf_rs_tpu.utils import REPO_ROOT

    _, _, _, camera = _scene()
    key = jax.random.key(0)
    n = sc.size * sc.size
    cfg = _headline_cfg(sc, dtype="bfloat16").replace(
        n_coarse=sc.single_pass, n_fine=0, accel_sample_aabb=True,
        accel_aabb_probes=sc.probes, accel_range_stride=sc.stride,
        accel_compact="off", accel_cull_rays=True)
    for name in ("student128_sp29", "teacher_sp30"):
        d = REPO_ROOT / "assets" / "trained" / name
        pc = load_nerf_params(d / "coarse")
        pf = load_nerf_params(d / "fine")
        grid = build_scene_grid(pc, pf, resolution=sc.grid_res)
        img, first, best = _timed(
            lambda: render_image(pc, pf, camera, sc.size, sc.size, key, cfg,
                                 grid=grid), sc.repeats)
        img = np.asarray(img)
        check(np.isfinite(img).all(), f"{name}: non-finite frame")
        p = psnr_db(img, reference)
        log.timing(f"{name} {sc.size}x{sc.size} {sc.single_pass}+0 bf16 "
                   f"probe-placed frame", best,
                   f", {n / best:,.0f} rays/s, first call {first:.1f} s, "
                   f"{p:.2f} dB vs teacher f32 exact")
        check(p >= sc.min_single_pass_db,
              f"{name}: {p:.2f} dB vs teacher < {sc.min_single_pass_db}")


def phase_train(sc: Scale, log: Log, workdir: str) -> None:
    """The single-pass distillation recipe through cli.main: a few steps,
    a checkpoint, then a resumed run that restores it and steps once."""
    import numpy as np

    from nerf_rs_tpu import cli
    from nerf_rs_tpu.io.checkpoint import latest_checkpoint, restore_params
    from nerf_rs_tpu.utils import REPO_ROOT

    ckpt = os.path.join(workdir, "train_ckpt")
    base = ["train", "--width", "128", "--v-width", "64",
            "--coarse-samples", str(sc.single_pass), "--fine-samples", "0",
            "--teacher-samples", ",".join(map(str, sc.samples)),
            "--init-weights", str(REPO_ROOT / "assets/trained/student128_30db"),
            "--accel-every", "2", "--accel-warmup", "0", "--accel-aabb",
            "--accel-probes", str(sc.train_probes), "--accel-pad", "4",
            "--accel-res", str(sc.grid_res), "--lr", "1e-4",
            "--batch-rays", str(sc.train_batch), "--ray-chunk",
            str(sc.ray_chunk), "--log-every", "1", "--checkpoint-dir", ckpt,
            "--checkpoint-every", "1000000"]
    for steps, what in ((sc.train_steps, "fresh"), (sc.train_steps + 1, "resumed")):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(base + ["--steps", str(steps)])
        dt = time.perf_counter() - t0
        text = out.getvalue()
        check(rc == 0, f"train ({what}) returned {rc}:\n{text[-2000:]}")
        losses = [float(line.split("loss ")[1].split()[0])
                  for line in text.splitlines() if line.startswith("step ")]
        check(bool(losses) and all(np.isfinite(losses)),
              f"train ({what}): no finite loss in the log:\n{text[-2000:]}")
        if what == "resumed":
            check(f"at step {sc.train_steps}" in text,
                  f"train did not resume from step {sc.train_steps}:\n"
                  f"{text[-2000:]}")
        log.timing(f"train {what} to step {steps}, batch {sc.train_batch} "
                   f"(incl. compile, teacher targets, checkpoint)", dt,
                   f", last loss {losses[-1]:.5f}")
    last = latest_checkpoint(ckpt)
    check(last is not None and last.name == f"step_{sc.train_steps + 1:08d}",
          f"expected checkpoint step {sc.train_steps + 1}, found {last}")
    params, step = restore_params(last)
    import jax

    leaves = jax.tree_util.tree_leaves(params)
    check(step == sc.train_steps + 1
          and all(np.isfinite(np.asarray(v)).all() for v in leaves),
          "restored checkpoint has a wrong step or non-finite params")
    log(f"  checkpoint {last.name}: {len(leaves)} arrays restored, finite")


def phase_serve(sc: Scale, log: Log) -> None:
    """In-process HTTP viewer on port 0: the page and a few /render
    requests through api.render_image_rgba."""
    import numpy as np

    from http.server import ThreadingHTTPServer

    from nerf_rs_tpu import api
    from nerf_rs_tpu.serve import Handler

    api.init_renderer(checkpoint=None)
    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            page = r.read().decode()
        check("rendered on" in page, "viewer page lacks its device line")
        s = sc.serve_size
        for seed in range(3):
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                    f"{base}/render?width={s}&height={s}&seed={seed}",
                    timeout=1200) as r:
                body = r.read()
                status = r.status
            dt = time.perf_counter() - t0
            rgba = np.frombuffer(body, np.uint8).reshape(s, s, 4)
            check(status == 200 and (rgba[..., 3] == 255).all()
                  and rgba[..., :3].min() < 200,
                  f"/render seed {seed}: status {status}, bad image")
            log.timing(f"serve /render {s}x{s} seed {seed}"
                       + (" (first: incl. compile)" if seed == 0 else ""), dt)
        try:
            urllib.request.urlopen(f"{base}/render?width=0", timeout=60)
            raise SmokeFailure("/render?width=0 was not rejected")
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"/render?width=0 gave {e.code}, not 400")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread did not stop")


def phase_legs(sc: Scale, log: Log) -> None:
    """Compile-and-run legs: the hash-grid family (render + one train
    step) and the int8 MLP impl against the f32 render."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nerf_rs_tpu.config import HashGridConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu.models.hashgrid import init_hashgrid_params
    from nerf_rs_tpu.parallel.train_sharded import (
        create_sharded_train_state, sharded_train_step,
    )
    from nerf_rs_tpu.render import render_image

    _, teacher, _, camera = _scene()
    s = sc.leg_size
    nc, nf = sc.leg_samples
    key = jax.random.key(0)

    hcfg = RenderConfig(n_coarse=nc, n_fine=nf, ray_chunk=4096,
                        model="hashgrid", hash=HashGridConfig())
    hp = jax.device_put(init_hashgrid_params(jax.random.key(1), hcfg.hash))
    t0 = time.perf_counter()
    img = np.asarray(render_image(hp, hp, camera, s, s, key, hcfg))
    log.timing(f"hashgrid {s}x{s} {nc}+{nf} render (incl. compile)",
               time.perf_counter() - t0)
    check(np.isfinite(img).all(), "hashgrid render is not finite")
    tcfg = TrainConfig(batch_rays=1024, adam_eps=1e-15, lr_init=1e-2,
                       lr_final=1e-4, render=hcfg.replace(ray_chunk=1024))
    mesh, state = create_sharded_train_state(jax.random.key(2), tcfg)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {"origins": jnp.tile(jnp.asarray([[0.0, -4.0, 1.0]]), (1024, 1)),
             "dirs": jnp.asarray(d),
             "rgb": jnp.asarray(rng.uniform(size=(1024, 3)).astype(np.float32)),
             "near": jnp.float32(2.0), "far": jnp.float32(6.0)}
    t0 = time.perf_counter()
    state, metrics = sharded_train_step(mesh, state, batch, key, tcfg)
    loss = float(metrics["loss"])
    log.timing("hashgrid train step, batch 1024 (incl. compile)",
               time.perf_counter() - t0, f", loss {loss:.5f}")
    check(np.isfinite(loss), "hashgrid train loss is not finite")

    cfg = RenderConfig(n_coarse=nc, n_fine=nf, ray_chunk=4096)
    ref = np.asarray(render_image(teacher["coarse"], teacher["fine"], camera,
                                  s, s, key, cfg))
    t0 = time.perf_counter()
    q = np.asarray(render_image(teacher["coarse"], teacher["fine"], camera,
                                s, s, key, cfg.replace(impl="int8")))
    p = psnr_db(q, ref)
    log.timing(f"int8 {s}x{s} {nc}+{nf} render (incl. compile)",
               time.perf_counter() - t0, f", {p:.2f} dB vs f32")
    check(np.isfinite(q).all() and p >= MIN_PSNR_INT8,
          f"int8 render {p:.2f} dB vs f32 < {MIN_PSNR_INT8}")


def phase_sharded(sc: Scale, log: Log, n_devices: int) -> None:
    """render_image_sharded on an n-device mesh vs render_image on one
    device (f32), and one data-parallel train step vs one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nerf_rs_tpu.config import TrainConfig
    from nerf_rs_tpu.parallel.mesh import make_mesh
    from nerf_rs_tpu.parallel.render_sharded import render_image_sharded
    from nerf_rs_tpu.parallel.train_sharded import (
        create_sharded_train_state, sharded_train_step,
    )
    from nerf_rs_tpu.render import render_image

    devices = jax.devices()[:n_devices]
    check(len(devices) == n_devices,
          f"need {n_devices} devices, JAX sees {len(jax.devices())}")
    mesh = make_mesh(devices)
    _, teacher, _, camera = _scene()
    pc, pf = teacher["coarse"], teacher["fine"]
    cfg = _headline_cfg(sc)
    key = jax.random.key(0)
    n = sc.size * sc.size

    single, first, best = _timed(
        lambda: render_image(pc, pf, camera, sc.size, sc.size, key, cfg),
        sc.repeats)
    log.timing(f"render_image {sc.size}x{sc.size} f32, 1 device", best,
               f", {n / best:,.0f} rays/s, first call {first:.1f} s")
    shard, first, best = _timed(
        lambda: render_image_sharded(pc, pf, camera, sc.size, sc.size, key,
                                       cfg, mesh=mesh), sc.repeats)
    log.timing(f"render_image_sharded {sc.size}x{sc.size} f32, "
               f"{n_devices} devices", best,
               f", {n / best:,.0f} rays/s, first call {first:.1f} s")
    err = float(np.abs(np.asarray(shard) - np.asarray(single)).max())
    if err == 0.0:
        log("  sharded vs single-device frame: bitwise equal")
    else:
        log(f"  sharded vs single-device frame: max abs err {err:.2e} "
            f"(accepted up to {TOL_SHARDED_RENDER:g}: each program may pick "
            "its own GEMM algorithm on the card, so sums can differ in "
            "their last bits)")
    check(err <= TOL_SHARDED_RENDER,
          f"sharded frame differs by {err:.2e} > {TOL_SHARDED_RENDER:g}")

    batch_rays = max(sc.train_batch, 8 * n_devices)
    tcfg = TrainConfig(batch_rays=batch_rays,
                       render=cfg.replace(ray_chunk=batch_rays))
    rng = np.random.default_rng(0)
    d = rng.normal(size=(batch_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {"origins": np.tile(np.asarray([[0.0, -4.0, 1.0]], np.float32),
                                (batch_rays, 1)),
             "dirs": d,
             "rgb": rng.uniform(size=(batch_rays, 3)).astype(np.float32),
             "near": np.float32(2.0), "far": np.float32(6.0)}
    losses = []
    for mesh_i in (make_mesh(devices[:1]), mesh):
        m, state = create_sharded_train_state(jax.random.key(1), tcfg, mesh_i)
        t0 = time.perf_counter()
        state, metrics = sharded_train_step(
            m, state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(2), tcfg)
        losses.append(float(metrics["loss"]))
        log.timing(f"sharded_train_step batch {batch_rays}, "
                   f"{mesh_i.devices.size} device(s) (incl. compile)",
                   time.perf_counter() - t0, f", loss {losses[-1]:.8f}")
    diff = abs(losses[0] - losses[1])
    log(f"  train loss 1 vs {n_devices} devices: |diff| {diff:.2e} "
        f"(tol {TOL_SHARDED_LOSS:g})")
    check(diff <= TOL_SHARDED_LOSS and all(np.isfinite(losses)),
          f"sharded loss differs by {diff:.2e} > {TOL_SHARDED_LOSS:g}")


# ---------------------------------------------------------------- driver


def _platforms_with_host_cpu() -> None:
    """Keep the host CPU backend available beside the GPU (the numerics
    phase compares against it) when JAX_PLATFORMS names only the GPU."""
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path on four cards")
    args = ap.parse_args(argv)

    _platforms_with_host_cpu()
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX found no GPU (default backend {backend!r}); "
              "this smoke test needs one", file=sys.stderr)
        return 2
    card = card_line()
    log = Log(card)
    dev = jax.devices()[0]
    log(f"card: {card}")
    log(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}")

    from nerf_rs_tpu.utils import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    sc = Scale()
    t_all = time.perf_counter()
    if args.chips == 4:
        log("phase sharded")
        phase_sharded(sc, log, 4)
    else:
        log("phase numerics")
        phase_numerics(sc, log)
        log("phase teacher")
        reference = phase_teacher(sc, log)
        log("phase single-pass")
        phase_single_pass(sc, log, reference)
        log("phase train")
        with tempfile.TemporaryDirectory() as work:
            phase_train(sc, log, work)
        log("phase serve")
        phase_serve(sc, log)
        log("phase legs")
        phase_legs(sc, log)
    log.timing("all phases", time.perf_counter() - t_all)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
