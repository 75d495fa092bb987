"""Command-line front-end.

Replacement for the reference's front-ends (render_cli_image,
/root/reference/src/lib.rs:647-677, and the wasm render_image_rgba entry,
lib.rs:700-726) — everything the reference hardcodes is a flag here.

    python -m nerf_rs_tpu render --width 800 --height 800 -o out.png
    python -m nerf_rs_tpu benchmark --size 800
    python -m nerf_rs_tpu verify
    python -m nerf_rs_tpu train --distill --steps 500
    python -m nerf_rs_tpu export --checkpoint ckpts/step_00000500 -o weights/
    python -m nerf_rs_tpu info
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _load_scene(args, device_put: bool = True):
    """``device_put=False`` skips the teacher weight upload for callers
    that only need the camera/golden (e.g. render --checkpoint, where the
    checkpoint supplies the weights)."""
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_scene_assets

    assets = Path(args.weights) if getattr(args, "weights", None) else find_lego_assets()
    if assets is None:
        sys.exit("error: no weight assets found (set --weights or $NERF_RS_TPU_ASSETS)")
    try:
        params, golden = load_scene_assets(assets, device_put=device_put)
    except FileNotFoundError:
        # A bare weight export (coarse/ + fine/, no camera JSON — e.g.
        # `cli export` output): usable with an explicit --camera, or with
        # the pretrained assets' camera as the fallback.
        from nerf_rs_tpu.io.weights import load_nerf_params

        params = {"coarse": load_nerf_params(assets / "coarse"),
                  "fine": load_nerf_params(assets / "fine")}
        cam_src = (Path(args.camera) if getattr(args, "camera", None)
                   else (find_lego_assets() or assets) / "tf_reference_samples.json")
        if not Path(cam_src).exists():
            sys.exit(f"error: {assets} has no tf_reference_samples.json — "
                     "pass --camera <json>")
        golden = load_golden(cam_src)
        camera = camera_from_golden(golden)
        return params, camera, golden
    if getattr(args, "camera", None):
        golden = load_golden(Path(args.camera))
    camera = camera_from_golden(golden)
    return params, camera, golden


def _render_config(args):
    from nerf_rs_tpu.config import RenderConfig

    return RenderConfig(
        n_coarse=args.coarse_samples,
        n_fine=args.fine_samples,
        ray_chunk=args.ray_chunk,
        impl=args.impl,
        dtype=args.dtype,
    )


def cmd_render(args) -> int:
    import jax
    import numpy as np

    from nerf_rs_tpu.io.image import save_png, save_ppm
    from nerf_rs_tpu.render import render_image

    from nerf_rs_tpu.utils.profiling import device_trace

    params, camera, _ = _load_scene(
        args, device_put=not getattr(args, "checkpoint", None))
    cfg = _render_config(args)
    if getattr(args, "checkpoint", None):
        # Render a TRAINED checkpoint directly (any family) — the camera
        # still comes from the scene assets / --camera. Hashgrid
        # checkpoints carry their hyper-parameters in the model.json
        # sidecar `train` writes.
        from nerf_rs_tpu.io.checkpoint import (
            hashgrid_render_config, load_model_config, restore_params,
        )

        ckpt_params, step = restore_params(args.checkpoint)
        ckpt_params = jax.device_put(ckpt_params)
        if "shared" in ckpt_params:
            info = load_model_config(Path(args.checkpoint))
            if info is None or info.get("model") != "hashgrid":
                sys.exit(f"error: {args.checkpoint} holds a shared-network "
                         "(hashgrid) checkpoint but no model.json sidecar "
                         "was found next to it")
            cfg = hashgrid_render_config(info, cfg)
            params = {"coarse": ckpt_params["shared"],
                      "fine": ckpt_params["shared"]}
        else:
            params = ckpt_params
        print(f"rendering checkpoint {args.checkpoint} (step {step})")
    impl_label = cfg.impl if cfg.model == "mlp" else cfg.model
    print(f"Rendering {args.width}x{args.height} with {cfg.n_coarse} coarse and "
          f"{cfg.n_fine} fine samples per ray ({impl_label}/{cfg.dtype})")
    grid = None
    if getattr(args, "accel_aabb", False) and not args.accel:
        # AABB clamping is meaningless without the grid — a silent
        # uniform-placement render would misattribute results to the clamp.
        print("note: --accel-aabb implies --accel")
        args.accel = True
    if args.accel:
        from nerf_rs_tpu.accel import (
            build_scene_grid, calibrate_capacities, suggest_capacities,
        )

        t0 = time.perf_counter()
        if getattr(args, "accel_aabb", False):
            cfg = cfg.replace(accel_sample_aabb=True)
        cfg = cfg.replace(
            accel_compact=getattr(args, "accel_compact", "none"))
        if getattr(args, "accel_cull_rays", False):
            cfg = cfg.replace(accel_cull_rays=True)
        from nerf_rs_tpu.accel import hashgrid_grid_kwargs

        grid_kw = hashgrid_grid_kwargs(cfg) if cfg.model == "hashgrid" else {}
        grid = build_scene_grid(params["coarse"], params["fine"],
                                resolution=args.accel_res, **grid_kw)
        # Chunk-safe capacities for THIS camera/size: compaction overflow
        # would silently zero real samples (accel.suggest_capacities).
        chunk = None
        if args.sharded:
            from nerf_rs_tpu.parallel.render_sharded import effective_chunk

            chunk = effective_chunk(args.height * args.width,
                                    jax.device_count(), cfg)
        cap_note = ("packing/placement only (no per-sample culling)"
                    if cfg.accel_compact == "off"
                    else "mask-only (no capacities)")
        if cfg.accel_compact not in ("none", "off"):
            # Compaction modes need chunk-safe capacities; mask-only has
            # none to calibrate.
            if args.accel_calibrate or cfg.accel_sample_aabb:
                # AABB clamping concentrates samples in occupied cells, so
                # the geometry-only suggestion (uniform midpoints)
                # undershoots — always use the measured calibration with
                # the clamp active.
                cfg = calibrate_capacities(
                    params["coarse"], params["fine"], grid, camera,
                    args.height, args.width, jax.random.key(args.seed), cfg,
                    chunk=chunk)
            else:
                cfg = suggest_capacities(grid, camera, args.height,
                                         args.width, cfg, chunk=chunk)
            cap_note = (f"capacities {cfg.accel_coarse_capacity:.2f}/"
                        f"{cfg.accel_fine_capacity:.2f}")
        frac = float(np.mean(np.asarray(grid.occ, np.float32)))
        print(f"occupancy grid {args.accel_res}^3 built in "
              f"{time.perf_counter() - t0:.2f}s ({100 * frac:.1f}% occupied; "
              f"{cap_note})")
    if args.sharded:
        from nerf_rs_tpu.parallel.render_sharded import render_image_sharded

        def run(k, cam):
            return render_image_sharded(params["coarse"], params["fine"],
                                        cam, args.height, args.width, k, cfg,
                                        grid=grid)
    else:
        def run(k, cam):
            return render_image(params["coarse"], params["fine"], cam,
                                args.height, args.width, k, cfg, grid=grid)

    from nerf_rs_tpu.ops.rays import orbit_camera

    n_frames = max(1, args.orbit)
    out = Path(args.output)

    def save(path, img):
        if path.suffix.lower() == ".ppm":
            save_ppm(path, img, args.height, args.width)
        else:
            save_png(path, img, args.height, args.width)
        print(f"Wrote {path}")

    aux_out = args.depth_output or args.acc_output
    if aux_out:
        from nerf_rs_tpu.render import render_image_aux

        def run_aux(k, cam):
            return render_image_aux(params["coarse"], params["fine"], cam,
                                    args.height, args.width, k, cfg, grid=grid)

    def frame_path(base, fi):
        p = Path(base)
        return p if n_frames == 1 else p.with_name(
            f"{p.stem}_{fi:03d}{p.suffix}")

    t0 = time.perf_counter()
    with device_trace(args.trace_dir):
        for fi in range(n_frames):
            cam_i = camera if n_frames == 1 else orbit_camera(
                camera, 2.0 * np.pi * fi / n_frames)
            if aux_out:
                rgb, depth, acc = run_aux(jax.random.key(args.seed), cam_i)
                img = np.asarray(rgb)
                if args.depth_output:
                    # Depth normalized to [near, far], near = white
                    # (standard disparity-style visualization).
                    d = (np.asarray(depth) - camera.near) / (camera.far - camera.near)
                    save(frame_path(args.depth_output, fi),
                         np.repeat(1.0 - np.clip(d, 0, 1)[..., None], 3, -1))
                if args.acc_output:
                    save(frame_path(args.acc_output, fi),
                         np.repeat(np.clip(np.asarray(acc), 0, 1)[..., None], 3, -1))
            else:
                img = np.asarray(run(jax.random.key(args.seed), cam_i))
            save(frame_path(out, fi), img)
    dt = time.perf_counter() - t0
    rays = args.width * args.height * n_frames
    print(f"Rendering completed in {dt:.2f} seconds ({rays / dt:,.0f} rays/s, "
          f"includes compile on first run)")
    return 0


def cmd_benchmark(args) -> int:
    import os

    os.environ["NERF_BENCH_SIZE"] = str(args.size)
    os.environ["NERF_BENCH_IMPL"] = args.impl
    os.environ["NERF_BENCH_DTYPE"] = args.dtype
    os.environ["NERF_BENCH_MODE"] = args.mode
    os.environ["NERF_BENCH_ACCEL"] = "1" if args.accel else "0"
    os.environ["NERF_BENCH_REPEATS"] = str(args.repeats)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import bench  # repo-root bench.py

    bench.main()
    return 0


def cmd_verify(args) -> int:
    """Golden-sample check of the f32 MLP (the reference's unit test,
    lib.rs:753-916), plus optional full-pipeline image checks."""
    import jax.numpy as jnp
    import numpy as np

    from nerf_rs_tpu.io.golden import golden_examples
    from nerf_rs_tpu.models.mlp import nerf_mlp

    # _load_scene's golden honors --camera and .npz bundles alike.
    params, _, golden = _load_scene(args)
    mlp = nerf_mlp

    worst = 0.0
    ok = True
    for net in ("coarse", "fine"):
        for ex in golden_examples(golden):
            pts = ex["ray_o"][None] + ex["ray_d"][None] * ex["z_vals"][:, None]
            dirs = np.broadcast_to(ex["viewdir_unit"], pts.shape)
            rgb, sigma = mlp(params[net], jnp.asarray(pts), jnp.asarray(dirs))
            err = max(
                float(np.abs(np.asarray(sigma) - ex[f"{net}_sigma"]).max()),
                float(np.abs(np.asarray(rgb) - ex[f"{net}_rgb"]).max()),
            )
            worst = max(worst, err)
            status = "OK" if err < args.tolerance else "FAIL"
            ok &= err < args.tolerance
            print(f"{net} pixel {ex['pixel']}: max abs err {err:.2e} [{status}]")
    print(f"worst error {worst:.2e} (tolerance {args.tolerance})")

    if args.image:
        # Full-pipeline image regression: the same committed-golden check
        # tests/test_render.py pins (64x64, 16+32 samples, key 0),
        # exposed on the CLI so users can validate a deployment without
        # running the test suite.
        import jax

        from nerf_rs_tpu.io.golden import camera_from_golden
        from nerf_rs_tpu.io.image import load_ppm
        from nerf_rs_tpu.render import render_image

        ref_path = Path(args.image_golden) if args.image_golden else (
            Path(__file__).resolve().parent.parent
            / "tests" / "goldens" / "lego_64x64_16c32f_key0.ppm")
        if not ref_path.exists():
            print(f"image check SKIPPED: golden render not found ({ref_path})")
            return 0 if ok else 1
        cfg = _render_config(args).replace(n_coarse=16, n_fine=32,
                                           ray_chunk=1024)
        img = np.asarray(render_image(
            params["coarse"], params["fine"], camera_from_golden(golden),
            64, 64, jax.random.key(0), cfg))
        mse = float(np.mean((img - load_ppm(ref_path)) ** 2))
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        # u8 quantization caps agreement near ~50 dB; bf16 costs more.
        bar = 45.0 if cfg.dtype == "float32" else 38.0
        img_ok = psnr > bar
        ok &= img_ok
        print(f"image vs committed golden: {psnr:.1f} dB "
              f"[{'OK' if img_ok else 'FAIL'}] (bar {bar:.0f} dB, "
              f"{cfg.impl}/{cfg.dtype})")

    if getattr(args, "image_full", False):
        # Full-quality gate: the committed 256x256 64+128 f32 key-0 render
        # (the analogue of the reference's committed output.ppm). ~12 min
        # on CPU — hence opt-in separately from --image.
        import jax

        from nerf_rs_tpu.io.golden import camera_from_golden
        from nerf_rs_tpu.io.image import load_ppm
        from nerf_rs_tpu.render import render_image

        ref_path = (Path(__file__).resolve().parent.parent
                    / "tests" / "goldens" / "lego_256x256_64c128f_key0.ppm")
        if not ref_path.exists():
            print(f"full-image check SKIPPED: golden not found ({ref_path})")
            return 0 if ok else 1
        cfg = _render_config(args).replace(n_coarse=64, n_fine=128,
                                           ray_chunk=8192)
        img = np.asarray(render_image(
            params["coarse"], params["fine"], camera_from_golden(golden),
            256, 256, jax.random.key(0), cfg))
        mse = float(np.mean((img - load_ppm(ref_path)) ** 2))
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        bar = 45.0 if cfg.dtype == "float32" else 38.0
        img_ok = psnr > bar
        ok &= img_ok
        print(f"full image (256x256, 64+128) vs committed golden: "
              f"{psnr:.1f} dB [{'OK' if img_ok else 'FAIL'}] "
              f"(bar {bar:.0f} dB, {cfg.impl}/{cfg.dtype})")
    return 0 if ok else 1


def cmd_train(args) -> int:
    import jax
    import numpy as np

    from nerf_rs_tpu.config import RenderConfig, TrainConfig
    from nerf_rs_tpu.io.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )
    from nerf_rs_tpu.parallel.train_sharded import (
        create_sharded_train_state,
        sharded_train_step,
    )

    from nerf_rs_tpu.config import ArchConfig, HashGridConfig

    arch = ArchConfig(width=args.width, v_width=args.v_width,
                      depth=args.depth, skip_at=args.skip_at)
    if args.model == "hashgrid":
        # Instant-NGP family (models/hashgrid.py): one shared network for
        # both passes, higher lr + tiny Adam eps (the paper's recipe —
        # table gradients are minute under the default eps).
        hcfg = HashGridConfig(
            levels=args.hash_levels, table_log2=args.hash_table_log2,
            res_max=args.hash_res_max, features=args.hash_features,
            aabb=(-args.hash_extent, args.hash_extent))
        lr = args.lr if args.lr is not None else 1e-2
        cfg = TrainConfig(
            batch_rays=args.batch_rays, n_steps=args.steps,
            checkpoint_every=args.checkpoint_every, seed=args.seed,
            lr_init=lr, lr_final=lr * 1e-2, adam_eps=1e-15,
            render=RenderConfig(
                n_coarse=args.coarse_samples, n_fine=args.fine_samples,
                ray_chunk=args.batch_rays, dtype=args.dtype,
                model="hashgrid", hash=hcfg,
            ),
        )
    else:
        impl = args.impl
        if impl == "int8":
            # Real-int8 forwards are non-differentiable through the int8
            # values (only the absmax scales carry gradient) — a training
            # run would move the loss while learning nothing. QAT is the
            # trainable form of the same arithmetic.
            sys.exit("error: --impl int8 is inference-only; train with "
                     "--impl int8qat (same quantized values, STE gradients)")
        cfg = TrainConfig(
            batch_rays=args.batch_rays,
            n_steps=args.steps,
            checkpoint_every=args.checkpoint_every,
            seed=args.seed,
            arch=arch,
            render=RenderConfig(
                n_coarse=args.coarse_samples, n_fine=args.fine_samples,
                ray_chunk=args.batch_rays, impl=impl, dtype=args.dtype,
            ),
        )
        if args.lr is not None:
            cfg = cfg.replace(lr_init=args.lr,
                              lr_final=min(cfg.lr_final, args.lr))
    if getattr(args, "accel_probes", None) or getattr(args, "accel_aabb", False):
        # Placement-aware training: render training batches with the SAME
        # occupied-range sample placement the serving preset uses
        # (accel_sample_aabb + per-ray probe refinement). Without this, a
        # reduced-sample student fine-tunes its field against UNIFORM
        # [near,far] placement and the serving-time probe-placed render
        # evaluates a field optimized for different integration points —
        # measured 2026-08-20: the uniform-placement single-pass fine-tune
        # crawled (+0.14 dB/1000 steps). Needs the occupancy grid, i.e.
        # --accel-every (the grid refreshes from the current student).
        if not args.accel_every:
            sys.exit("error: --accel-aabb/--accel-probes need --accel-every "
                     "(the placement ranges come from the occupancy grid)")
        cfg = cfg.replace(render=cfg.render.replace(
            accel_sample_aabb=True,
            accel_aabb_probes=int(getattr(args, "accel_probes", 0) or 0),
            accel_pad_probes=float(getattr(args, "accel_pad", 1.0) or 1.0)))
    mesh, state = create_sharded_train_state(jax.random.key(cfg.seed), cfg)
    print(f"mesh: {mesh}; devices: {jax.device_count()}")

    resumed = False
    if args.checkpoint_dir:
        from nerf_rs_tpu.io.checkpoint import load_model_config, save_model_config

        # Model-family sidecar (hash resolutions/aabb are not inferable
        # from array shapes). Guards run against EXISTING checkpoints only
        # — a stale sidecar from a run that died before its first
        # checkpoint must not block a retry with different flags — and the
        # sidecar is (re)written only after every guard passes, so a
        # mismatched invocation cannot corrupt the directory's metadata.
        want_info = {"model": args.model}
        if args.model == "hashgrid":
            import dataclasses

            want_info["hash"] = dataclasses.asdict(cfg.render.hash)
        # Normalize through JSON so tuples (aabb) compare equal to the
        # lists a read-back sidecar holds.
        want_info = json.loads(json.dumps(want_info))
        ckpt = latest_checkpoint(args.checkpoint_dir)
        if ckpt is not None:
            from nerf_rs_tpu.io.checkpoint import checkpoint_param_keys
            from nerf_rs_tpu.parallel.mesh import replicate

            # Family guard first (key paths only): resuming an MLP dir with
            # --model hashgrid (or vice versa) would otherwise die in an
            # opaque leaf-path error — or worse, pass the sidecar check on
            # a pre-sidecar dir.
            want_keys = {"shared"} if args.model == "hashgrid" else {"coarse", "fine"}
            got_keys = checkpoint_param_keys(ckpt)
            if got_keys != want_keys:
                sys.exit(
                    f"error: checkpoint {ckpt} holds params {sorted(got_keys)} "
                    f"but --model {args.model} trains {sorted(want_keys)} — "
                    "match the --model flag to the checkpoint or use a fresh "
                    "--checkpoint-dir.")
            have_info = load_model_config(Path(args.checkpoint_dir))

            def _structural(info):
                # grad_impl is a training-implementation knob (which VJP
                # computes the table gradient) — it does not shape the
                # params, so a default flip must not strand existing
                # checkpoint dirs.
                if info is None or "hash" not in info:
                    return info
                info = json.loads(json.dumps(info))
                info["hash"].pop("grad_impl", None)
                return info

            if (have_info is not None
                    and _structural(have_info) != _structural(want_info)):
                sys.exit(f"error: {args.checkpoint_dir}/model.json holds a "
                         f"different model config than the flags request.\n"
                         f"  checkpoint: {have_info}\n  requested:  {want_info}\n"
                         "Match the flags or use a fresh --checkpoint-dir.")
            if args.model != "hashgrid":
                from nerf_rs_tpu.io.checkpoint import checkpoint_kernel_shapes
                from nerf_rs_tpu.models.mlp import arch_shapes

                # Arch guard BEFORE the templated restore: a checkpoint with
                # different layer widths or depth would otherwise die in an
                # opaque per-leaf shape error. Fail with the actual archs,
                # reading only the coarse kernels. (The hashgrid family is
                # guarded by the model.json comparison above instead.)
                want = arch_shapes(arch)
                got = checkpoint_kernel_shapes(ckpt)
                if got != want:
                    sys.exit(
                        f"error: checkpoint {ckpt} holds a different architecture "
                        f"than the requested --width/--v-width/--depth/--skip-at "
                        f"({arch}).\n  checkpoint layers: {sorted(got.items())}\n"
                        f"  requested layers:  {sorted(want.items())}\n"
                        "Match the flags to the checkpoint or use a fresh "
                        "--checkpoint-dir.")
            # Restored leaves are host numpy — re-commit to the mesh with the
            # replicated sharding the fresh-start path uses.
            state = replicate(mesh, restore_checkpoint(ckpt, state))
            print(f"resumed from {ckpt} at step {int(state.step)}")
            resumed = True
        save_model_config(Path(args.checkpoint_dir), want_info)

    if getattr(args, "init_weights", None) and not resumed:
        # Warm start from exported weights (reference .bin layout or .npz
        # bundle): fine-tune a distilled student for a different serving
        # regime (reduced samples, single-pass, QAT) without re-distilling
        # from scratch. Fresh optimizer state + step 0 — this is a new run
        # seeded with good params, not a resume.
        from nerf_rs_tpu.models.mlp import arch_shapes
        from nerf_rs_tpu.parallel.mesh import replicate

        if args.model == "hashgrid":
            sys.exit("error: --init-weights supports the MLP family only "
                     "(hashgrid checkpoints resume via --checkpoint-dir)")
        iw = Path(args.init_weights)
        if iw.suffix == ".npz":
            from nerf_rs_tpu.io.weights import load_bundle

            bundle_params, _ = load_bundle(iw, device_put=False)
            pc, pf = bundle_params["coarse"], bundle_params["fine"]
        else:
            from nerf_rs_tpu.io.weights import load_nerf_params

            pc = load_nerf_params(iw / "coarse", device_put=False)
            pf = load_nerf_params(iw / "fine", device_put=False)
        want = arch_shapes(arch)
        # Validate BOTH networks: a truncated/mismatched export whose
        # coarse/ differs would otherwise pass here and die later with an
        # opaque optimizer pytree-shape error.
        for net, loaded_p in (("fine", pf), ("coarse", pc)):
            got = {name: tuple(lay["kernel"].shape)
                   for name, lay in loaded_p.items()}
            if got != want:
                sys.exit(
                    f"error: --init-weights {iw} {net}/ holds a different "
                    f"architecture than the requested flags ({arch}).\n"
                    f"  weights layers:   {sorted(got.items())}\n"
                    f"  requested layers: {sorted(want.items())}")
        state = replicate(mesh, state._replace(
            params={"coarse": pc, "fine": pf}))
        print(f"initialized params from {iw} (fresh optimizer, step 0)")

    if args.data:
        from nerf_rs_tpu.data import BlenderDataset

        dataset = BlenderDataset(args.data)
    else:
        from nerf_rs_tpu.data import DistillationDataset

        teacher, _, _ = _load_scene(args)
        # The teacher is always the canonical MLP (also for a hashgrid
        # student). The quantized impls select the STUDENT's forward; the
        # distill targets must come from the exact float teacher, or QAT
        # optimizes toward a ~39 dB-corrupted reference and caps the very
        # quality it exists to preserve.
        teacher_impl = ("xla" if args.impl in ("int8", "int8qat")
                        else args.impl)
        teacher_cfg = cfg.render.replace(impl=teacher_impl, model="mlp")
        if getattr(args, "teacher_samples", None):
            # Full-quality targets for a reduced-sample/single-pass student:
            # the student renders its training batches at ITS sample counts,
            # the teacher at these (typically 64+128) — distill toward what
            # users compare against, not a preset-degraded teacher.
            tc, tf = (int(v) for v in args.teacher_samples.split(","))
            teacher_cfg = teacher_cfg.replace(n_coarse=tc, n_fine=tf)
        dataset = DistillationDataset(teacher, cfg=teacher_cfg, seed=cfg.seed)
        print("no --data given: distilling from the pretrained lego networks"
              + (f" (teacher targets at {teacher_cfg.n_coarse}+"
                 f"{teacher_cfg.n_fine} samples)"
                 if getattr(args, "teacher_samples", None) else ""))

    # Preemption safety: SIGTERM/SIGINT request a graceful stop; the loop
    # finishes the in-flight step, checkpoints, and exits 0 so a restarted
    # job resumes from the same directory (the reference has no failure
    # recovery at all — SURVEY.md §5).
    import signal

    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        print(f"received signal {signum}: checkpointing and stopping")
        stop_requested["flag"] = True

    old_handlers = {
        s: signal.signal(s, _request_stop) for s in (signal.SIGTERM, signal.SIGINT)
    }

    key = jax.random.key(cfg.seed + 1)
    t0 = time.perf_counter()
    start_step = int(state.step)
    try:
        # Seed folds in the resume step so a restored run draws fresh batches
        # instead of replaying the sequence from the beginning.
        grid = None
        if args.accel_every:
            # ONE function object for every refresh: mlp_fn identity keys
            # accel._grid_sweep's jit cache, so a per-refresh lambda would
            # recompile the sweep every N steps. Hashgrid additionally
            # threads its own aabb (accel.hashgrid_grid_kwargs, cached).
            if cfg.render.model == "hashgrid":
                from nerf_rs_tpu.accel import hashgrid_grid_kwargs

                grid_build_kw = hashgrid_grid_kwargs(cfg.render)
            else:
                from nerf_rs_tpu.render import get_mlp_fn

                _mlp = get_mlp_fn(cfg.render)

                def accel_mlp_fn(p, x, d):
                    return _mlp(p, x, d, sigma_only=True)

                grid_build_kw = {"mlp_fn": accel_mlp_fn}

        def refresh_grid(step):
            """Occupancy-culled training: bake the grid from the CURRENT
            student (culling by a stale or foreign density field would
            starve gradients where the student is wrong), with the
            CONFIGURED MLP impl/dtype (the default grid sweep would
            threshold bf16 sigmas under an f32 run). Degenerate grids fall back to dense for
            this refresh period: near-empty (early training, density not
            yet formed) and near-full (compaction at capacity ~1.0 culls
            nothing and only adds overhead). A culled cell gets exactly
            zero gradient, so --accel-explore re-opens a random fraction
            of cells each refresh — regions the student wrongly zeroed
            can recover (NerfAcc keeps exploration alive the same way).
            Capacities come from accel.capacities_from_occupancy, floored
            at the defaults and quantized to bound recompiles; the
            accel_overflow metric in the step log confirms headroom."""
            import jax.numpy as jnp

            from nerf_rs_tpu.accel import build_scene_grid, capacities_from_occupancy

            from nerf_rs_tpu.train import split_params

            pc, pf = split_params(state.params)
            g = build_scene_grid(pc, pf, resolution=args.accel_res,
                                 **grid_build_kw)
            occ = np.asarray(g.occ)
            # Near-empty check on the RAW grid: exploration cells would
            # mask an unformed density field and this guard would go dead.
            raw_frac = float(occ.mean())
            if raw_frac < 0.005:
                print(f"accel: grid only {raw_frac:.2%} occupied — "
                      "training dense until density forms")
                return None, cfg
            if args.accel_explore > 0:
                rng = np.random.default_rng(cfg.seed + step)
                occ = occ | (rng.random(occ.shape) < args.accel_explore)
                g = g._replace(occ=jnp.asarray(occ))
            frac = float(occ.mean())  # capacities cover explore cells too
            cap_c, cap_f = capacities_from_occupancy(frac, cfg.render)
            if cap_c >= 1.0:
                print(f"accel: grid {frac:.1%} occupied — culling would "
                      "skip nothing, training dense this period")
                return None, cfg
            if cfg.render.accel_compact in ("none", "off"):
                # Mask-only culling (the default): no capacities to tune —
                # the grid zeroes sigma/gradient in empty cells at dense
                # cost, which is the NerfAcc training benefit (cleaner
                # gradients) without the measured compaction slowdown.
                print(f"accel: rebuilt {args.accel_res}^3 grid "
                      f"({frac:.1%} occupied; mask-only)")
                return g, cfg
            new_cfg = cfg.replace(render=cfg.render.replace(
                accel_coarse_capacity=cap_c, accel_fine_capacity=cap_f))
            print(f"accel: rebuilt {args.accel_res}^3 grid ({frac:.1%} "
                  f"occupied; capacities {cap_c:.2f}/{cap_f:.2f})")
            return g, new_cfg

        step_cfg = cfg
        batch_iter = dataset.batches(cfg.batch_rays, seed=cfg.seed + start_step)
        for step, batch in enumerate(batch_iter, start=start_step):
            if step >= cfg.n_steps or stop_requested["flag"]:
                break
            if (args.accel_every and step >= args.accel_warmup
                    and (step % args.accel_every == 0
                         # A RESUMED run must not train grid-less until the
                         # next refresh boundary: with --accel-aabb that
                         # silently reverts to uniform placement for up to
                         # accel_every steps every chunk (chunked
                         # convergence runs resume constantly).
                         or (step == start_step and grid is None))):
                grid, step_cfg = refresh_grid(step)
            state, metrics = sharded_train_step(
                mesh, state, batch, jax.random.fold_in(key, step), step_cfg,
                grid=grid)
            if step % args.log_every == 0 or step + 1 == cfg.n_steps:
                m = {k: float(v) for k, v in metrics.items()}
                rays_s = cfg.batch_rays * (step - start_step + 1) / (time.perf_counter() - t0)
                extra = ""
                if "live_frac_coarse" in m:
                    extra = (f" accel-load {m['live_frac_coarse']:.2f}/"
                             f"{m['live_frac_fine']:.2f}")
                    # accel_overflow is an indicator pmean — nonzero iff
                    # ANY device overflowed (a plain max of the pooled
                    # live_frac means would dilute one hot shard).
                    if m.get("accel_overflow", 0.0) > 0.0:
                        extra += " OVERFLOW (raise accel capacities)"
                print(f"step {step}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} "
                      f"({rays_s:,.0f} rays/s fwd+bwd){extra}")
            if args.checkpoint_dir and (step + 1) % cfg.checkpoint_every == 0:
                path = save_checkpoint(args.checkpoint_dir, state)
                print(f"checkpointed {path}")
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        if args.checkpoint_dir:
            path = save_checkpoint(args.checkpoint_dir, state)
            print(f"final checkpoint {path}")
    return 0


def cmd_evaluate(args) -> int:
    """Render a validation view with checkpoint params and report PSNR
    against the pretrained teacher's render of the same view."""
    import jax
    import numpy as np

    from nerf_rs_tpu.io.checkpoint import latest_checkpoint, restore_params
    from nerf_rs_tpu.render import render_image

    if (args.checkpoint is None and args.checkpoint_dir is None
            and getattr(args, "weights_dir", None) is None):
        sys.exit("error: pass --checkpoint, --checkpoint-dir, or --weights-dir")
    teacher, camera, _ = _load_scene(args)
    cfg = _render_config(args)
    if getattr(args, "weights_dir", None):
        # Exported .bin weights (any ArchConfig member) — the portable
        # artifact form, e.g. assets/trained/*.
        from nerf_rs_tpu.io.weights import load_nerf_params

        wd = Path(args.weights_dir)
        params = jax.device_put({"coarse": load_nerf_params(wd / "coarse",
                                                            device_put=False),
                                 "fine": load_nerf_params(wd / "fine",
                                                          device_put=False)})
        step, ckpt = -1, wd
    else:
        ckpt = args.checkpoint or latest_checkpoint(args.checkpoint_dir)
        if ckpt is None:
            sys.exit("error: no checkpoint found (--checkpoint or --checkpoint-dir)")
        # Template-free restore: the student's architecture (any ArchConfig
        # member) is inferred from the checkpoint itself; a hashgrid family
        # member carries its non-inferable hyper-parameters in the model.json
        # sidecar written by `train`.
        params, step = restore_params(ckpt)
        params = jax.device_put(params)
    # The PSNR reference must be the EXACT teacher: --impl int8 selects
    # how the CHECKPOINT renders (judge a QAT student on the arithmetic
    # it serves), not a corruption of the reference image.
    teacher_cfg = cfg
    if cfg.impl in ("int8", "int8qat"):
        teacher_cfg = cfg.replace(impl="xla")
    if getattr(args, "ref_samples", None):
        # Full-quality reference for a reduced-sample/single-pass config:
        # the checkpoint renders at ITS sample counts, the teacher at the
        # (typically 64+128) reference counts — the honest frontier metric
        # (quality actually delivered vs quality users expect).
        rc, rf = (int(v) for v in args.ref_samples.split(","))
        teacher_cfg = teacher_cfg.replace(n_coarse=rc, n_fine=rf)
    if "shared" in params:
        from nerf_rs_tpu.io.checkpoint import hashgrid_render_config, load_model_config

        info = load_model_config(ckpt)
        if info is None or info.get("model") != "hashgrid":
            sys.exit(f"error: {ckpt} holds a shared-network (hashgrid) "
                     "checkpoint but no model.json sidecar was found next "
                     "to it — re-run train with --checkpoint-dir to write one")
        cfg = hashgrid_render_config(info, cfg)
        pc, pf = params["shared"], params["shared"]
    else:
        pc, pf = params["coarse"], params["fine"]

    grid = None
    if getattr(args, "accel_probes", 0):
        # Judge the checkpoint under the SERVING preset's probe-refined
        # sample placement (grid from the checkpoint's own field) against
        # the exact teacher reference — the honest axis for reduced-sample
        # or single-pass fine-tunes (the uniform-placement render
        # understates what the serving config actually delivers).
        from nerf_rs_tpu.accel import build_scene_grid, hashgrid_grid_kwargs

        # Hashgrid checkpoints need the family-aware sweep function + aabb
        # (the default grid sweep assumes MLP params — train/bench thread
        # the same kwargs).
        grid_build_kw = (hashgrid_grid_kwargs(cfg)
                         if "shared" in params else {})
        grid = build_scene_grid(pc, pf,
                                resolution=getattr(args, "accel_res", 128),
                                **grid_build_kw)
        cfg = cfg.replace(accel_sample_aabb=True, accel_compact="off",
                          accel_aabb_probes=int(args.accel_probes),
                          accel_range_stride=int(getattr(
                              args, "accel_stride", 1) or 1))
    key = jax.random.key(args.seed)
    ref = np.asarray(render_image(teacher["coarse"], teacher["fine"], camera,
                                  args.size, args.size, key, teacher_cfg))
    img = np.asarray(render_image(pc, pf, camera,
                                  args.size, args.size, key, cfg,
                                  grid=grid))
    mse = float(np.mean((img - ref) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    print(f"step {step}: {args.size}x{args.size} PSNR vs teacher "
          f"{psnr:.2f} dB (mse {mse:.3e})")
    return 0


def cmd_extract(args) -> int:
    """Extract the trained field's iso-surface as a PLY mesh (geometry
    export — previews / DCC import; the reference renders images only)."""
    import time

    from nerf_rs_tpu.extract import extract_scene_mesh, save_ply

    params, _, _ = _load_scene(args)
    t0 = time.perf_counter()
    verts, faces = extract_scene_mesh(
        params["coarse"], params["fine"], resolution=args.resolution,
        aabb=(-args.extent, args.extent), iso=args.iso)
    if len(faces) == 0:
        sys.exit(f"error: no surface at iso={args.iso} — try a lower --iso")
    colors = None
    if not args.no_color:
        from nerf_rs_tpu.extract import vertex_colors

        colors = vertex_colors(params["fine"], verts, faces)
    save_ply(args.output, verts, faces, colors=colors)
    print(f"wrote {args.output}: {len(verts):,} vertices, "
          f"{len(faces):,} triangles"
          f"{' (vertex colors)' if colors is not None else ''} "
          f"({args.resolution}^3 lattice, iso {args.iso}, "
          f"{time.perf_counter() - t0:.1f}s)")
    return 0


def cmd_export(args) -> int:
    """Export a training checkpoint to the reference .bin format (any
    ArchConfig member; shapes.txt records the student dims)."""
    from nerf_rs_tpu.io.checkpoint import export_reference_format, restore_params

    params, step = restore_params(args.checkpoint)
    if "shared" in params:
        sys.exit("error: hashgrid checkpoints have no reference .bin "
                 "equivalent (the reference loader consumes dense-MLP "
                 "layers only, src/lib.rs:108-174) — use evaluate/render "
                 "with --checkpoint instead")
    export_reference_format(args.output, params)
    print(f"exported step {step} params to {args.output} "
          "(reference shapes.txt + .bin format)")
    return 0


def cmd_pack(args) -> int:
    """Pack the scene (both networks + golden JSON) into one .npz bundle —
    the reference's wasm weight embedding (src/weights.rs:1-100) as a
    single self-contained artifact; loadable via --weights / assets_dir /
    $NERF_RS_TPU_ASSETS."""
    import json

    from nerf_rs_tpu.io.weights import find_lego_assets, load_scene_assets, save_bundle

    assets = Path(args.weights) if args.weights else find_lego_assets()
    if assets is None:
        sys.exit("error: no weight assets found (set --weights or $NERF_RS_TPU_ASSETS)")
    params, golden = load_scene_assets(assets, device_put=False)
    save_bundle(args.output, params["coarse"], params["fine"],
                json.dumps(golden))
    size_mb = Path(args.output).stat().st_size / 1e6
    print(f"packed {assets} -> {args.output} ({size_mb:.1f} MB, "
          "coarse + fine + camera/golden JSON)")
    return 0


def cmd_info(args) -> int:
    import jax

    print(f"jax {jax.__version__}")
    print(f"backend: {jax.default_backend()}")
    print(f"devices ({jax.device_count()}): {jax.devices()}")
    from nerf_rs_tpu.io import native
    from nerf_rs_tpu.io.weights import find_lego_assets

    print(f"native io: {'available' if native.available() else 'unavailable (numpy fallback)'}")
    print(f"lego assets: {find_lego_assets()}")
    return 0


def _add_common(p):
    p.add_argument("--weights", help="weight bundle dir (default: auto-discover)")
    p.add_argument("--camera", help="camera JSON (default: bundle's golden JSON)")
    p.add_argument("--impl", default="xla",
                   choices=["xla", "int8", "int8qat"],
                   help="MLP impl: the XLA MLP (f32, or bf16 operands with "
                        "--dtype bfloat16), real W8A8 int8 inference, or "
                        "the QAT fake-quant forward to distill int8 "
                        "students (models/quant.py)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--coarse-samples", type=int, default=64)
    p.add_argument("--fine-samples", type=int, default=128)
    p.add_argument("--ray-chunk", type=int, default=16384)
    p.add_argument("--seed", type=int, default=0)


def main(argv=None) -> int:
    from nerf_rs_tpu.utils import enable_compile_cache

    # Persistent compile cache: repeated CLI invocations — resumed
    # training chunks, orbit sweeps, evaluate — reuse compiled programs.
    enable_compile_cache()
    parser = argparse.ArgumentParser(prog="nerf_rs_tpu", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render an image")
    _add_common(p)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("-o", "--output", default="output.ppm")
    p.add_argument("--sharded", action="store_true",
                   help="shard rays over every visible chip (shard_map)")
    p.add_argument("--accel", action="store_true",
                   help="occupancy-grid empty-space skipping (fast mode)")
    p.add_argument("--accel-res", type=int, default=128,
                   help="occupancy grid resolution per axis")
    p.add_argument("--accel-calibrate", action="store_true",
                   help="measure capacities with one instrumented render "
                        "(tighter than the default geometry estimate)")
    p.add_argument("--accel-aabb", action="store_true",
                   help="clamp each ray's sample range to the occupied-AABB "
                        "intersection (same sample count, denser on the "
                        "object; implies --accel-calibrate)")
    p.add_argument("--accel-compact", default="none",
                   choices=("off", "none", "scatter", "gather"),
                   help="per-sample culling: 'off' (grid steers ray packing "
                        "+ placement only — rendered rays stay exact), "
                        "'none' (mask-only: dense eval, zeroed sigma), or "
                        "fixed-capacity compaction (kept for A/B)")
    p.add_argument("--accel-cull-rays", action="store_true",
                   help="pack away rays that miss the occupied box and "
                        "composite them to background without rendering "
                        "(works single-device and --sharded)")
    p.add_argument("--trace-dir", help="write a jax.profiler trace here")
    p.add_argument("--depth-output",
                   help="also write the depth map (expected-t, near=white) "
                        "as PNG/PPM here")
    p.add_argument("--acc-output",
                   help="also write the accumulated-opacity map here")
    p.add_argument("--checkpoint",
                   help="render a trained checkpoint (any model family) "
                        "instead of the pretrained weights")
    p.add_argument("--orbit", type=int, default=0,
                   help="render N turntable frames rotating the camera "
                        "about the scene's z-axis (output gets _000.. "
                        "suffixes; accel capacities are tuned on the base "
                        "view — the sweep keeps the same camera distance)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("benchmark", help="rays/s benchmark (prints one JSON line)")
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--impl", default="xla", choices=["xla", "int8", "int8qat"],
                   help="MLP impl (see the render command)")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--mode", default="render", choices=["render", "train"],
                   help="train = full fwd+bwd+opt steps")
    p.add_argument("--accel", action="store_true",
                   help="occupancy-grid fast mode (PSNR-guarded)")
    p.add_argument("--repeats", type=int, default=3)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("verify", help="golden-sample verification")
    _add_common(p)
    p.add_argument("--tolerance", type=float, default=1e-2)
    p.add_argument("--image", action="store_true",
                   help="also run the full-pipeline image regression vs "
                        "the committed golden render")
    p.add_argument("--image-golden",
                   help="path to a golden PPM (default: the committed "
                        "tests/goldens artifact)")
    p.add_argument("--image-full", action="store_true",
                   help="also gate a FULL-QUALITY render (256x256, 64+128 "
                        "samples, key 0) against the committed golden — "
                        "~12 min on CPU")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("train", help="train coarse+fine networks")
    _add_common(p)
    p.add_argument("--model", default="mlp", choices=["mlp", "hashgrid"],
                   help="field-network family: the reference MLP / "
                        "ArchConfig students, or the Instant-NGP "
                        "multiresolution hash grid (one shared network "
                        "for both passes)")
    p.add_argument("--lr", type=float, default=None,
                   help="initial learning rate (default: 5e-4 for mlp, "
                        "1e-2 for hashgrid)")
    p.add_argument("--hash-levels", type=int, default=16,
                   help="hashgrid: resolution levels")
    p.add_argument("--hash-table-log2", type=int, default=17,
                   help="hashgrid: log2 table entries per level")
    p.add_argument("--hash-res-max", type=int, default=1024,
                   help="hashgrid: finest grid resolution")
    p.add_argument("--hash-features", type=int, default=2,
                   help="hashgrid: feature channels per table entry; at "
                        "fixed encoding width L*F, '--hash-levels 4 "
                        "--hash-features 8' gathers 4x fewer rows than the "
                        "paper's 16x2")
    p.add_argument("--hash-extent", type=float, default=2.0,
                   help="hashgrid: scene AABB half-width (+-extent)")
    p.add_argument("--width", type=int, default=256,
                   help="trunk width (non-canonical values train a smaller "
                        "distillation student)")
    p.add_argument("--v-width", type=int, default=128,
                   help="view-branch width")
    p.add_argument("--depth", type=int, default=8, help="dense trunk layers")
    p.add_argument("--skip-at", type=int, default=4,
                   help="encoded input re-concatenated before "
                        "dense{skip_at+1} (reference: 4)")
    p.add_argument("--teacher-samples", metavar="NC,NF",
                   help="distillation only: render the TEACHER targets at "
                        "these sample counts instead of the student's "
                        "--coarse-samples/--fine-samples — REQUIRED when "
                        "retargeting a student to a reduced-sample or "
                        "single-pass preset, or it distills toward a "
                        "degraded teacher (e.g. --coarse-samples 64 "
                        "--fine-samples 0 --teacher-samples 64,128)")
    p.add_argument("--init-weights",
                   help="warm-start: initialize params from an exported "
                        "weight dir (coarse/ + fine/ .bin, cli export) or "
                        ".npz bundle of the SAME --width/--v-width/--depth/"
                        "--skip-at arch — e.g. fine-tune a distilled "
                        "student for a reduced-sample preset, or QAT "
                        "(--impl int8qat) from its float checkpoint. "
                        "Ignored when --checkpoint-dir already holds a "
                        "checkpoint (resume wins). MLP family only")
    p.add_argument("--data", help="nerf_synthetic scene dir (default: distill)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-rays", type=int, default=4096)
    p.add_argument("--checkpoint-dir")
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--accel-every", type=int, default=0,
                   help="occupancy-culled training: rebuild the grid from "
                        "the student every N steps (0 = off)")
    p.add_argument("--accel-res", type=int, default=128,
                   help="occupancy grid resolution per axis")
    p.add_argument("--accel-warmup", type=int, default=256,
                   help="train dense for this many steps before the first "
                        "grid refresh (density must form somewhere first)")
    p.add_argument("--accel-explore", type=float, default=0.01,
                   help="fraction of cells randomly re-opened at each grid "
                        "refresh, so regions the student wrongly zeroed "
                        "keep receiving gradient (0 = off)")
    p.add_argument("--accel-aabb", action="store_true",
                   help="placement-aware training: clamp each training "
                        "ray's sample range to its occupied-AABB span "
                        "(needs --accel-every) — match the serving "
                        "preset's sample placement when fine-tuning for "
                        "a reduced-sample/single-pass config")
    p.add_argument("--accel-probes", type=int, default=0,
                   help="with --accel-aabb semantics: refine each ray's "
                        "range to its own occupied run via this many grid "
                        "probes (serving presets use 128)")
    p.add_argument("--accel-pad", type=float, default=1.0,
                   help="with --accel-probes: pad each training ray's "
                        "range by this many probe intervals per side — "
                        "serving pools ranges over stride blocks (wider), "
                        "so ~4 keeps training placement matched to the "
                        "stride-4 serving preset")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="checkpoint PSNR vs the pretrained teacher")
    _add_common(p)
    p.add_argument("--checkpoint", help="checkpoint path (default: latest in dir)")
    p.add_argument("--checkpoint-dir")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--weights-dir",
                   help="evaluate an exported weight dir (coarse/ + fine/ "
                        ".bin) instead of a training checkpoint — e.g. the "
                        "vendored assets/trained/* artifacts")
    p.add_argument("--ref-samples", metavar="NC,NF",
                   help="render the TEACHER reference at these sample "
                        "counts instead of the checkpoint's --coarse-"
                        "samples/--fine-samples — judges a reduced-sample "
                        "or single-pass config against the full-quality "
                        "teacher render (e.g. --coarse-samples 64 "
                        "--fine-samples 0 --ref-samples 64,128)")
    p.add_argument("--accel-probes", type=int, default=0,
                   help="render the CHECKPOINT under serving-preset probe "
                        "placement (occupied-run refinement, grid built "
                        "from the checkpoint's own field; serving uses "
                        "128) instead of uniform [near,far] sampling")
    p.add_argument("--accel-stride", type=int, default=4,
                   help="with --accel-probes: probe a stride-subsampled "
                        "ray grid, conservatively pooled (the serving "
                        "preset's accel_range_stride)")
    p.add_argument("--accel-res", type=int, default=128,
                   help="with --accel-probes: occupancy grid resolution")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("export", help="checkpoint -> reference .bin format")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("extract",
                       help="trained field -> PLY surface mesh (geometry "
                            "export)")
    p.add_argument("--weights", help="scene assets dir / .npz bundle "
                                     "(default: pretrained lego)")
    p.add_argument("-o", "--output", required=True, help="output .ply path")
    p.add_argument("--resolution", type=int, default=128,
                   help="density lattice resolution per axis")
    p.add_argument("--iso", type=float, default=10.0,
                   help="density iso level treated as the surface")
    p.add_argument("--extent", type=float, default=2.0,
                   help="half-width of the sampled cube (aabb +-extent)")
    p.add_argument("--no-color", action="store_true",
                   help="skip baking vertex colors (fine network queried "
                        "along the inward normal)")
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("pack", help="scene -> single self-contained .npz bundle")
    p.add_argument("--weights", help="weight bundle dir (default: auto-discover)")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("serve", help="HTTP browser viewer (reference web UI)")
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--warmup", action="store_true")
    p.add_argument("--accel", action="store_true",
                   help="serve through the occupancy-grid fast path")
    p.add_argument("--accel-res", type=int, default=128)
    p.add_argument("--checkpoint",
                   help="serve a cli-train checkpoint (any model family)")
    p.set_defaults(fn=lambda a: __import__(
        "nerf_rs_tpu.serve", fromlist=["main"]
    ).main(["--port", str(a.port), "--host", a.host]
           + (["--warmup"] if a.warmup else [])
           + (["--accel", "--accel-res", str(a.accel_res)] if a.accel else [])
           + (["--checkpoint", a.checkpoint] if a.checkpoint else [])))

    p = sub.add_parser("info", help="device/mesh info")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
