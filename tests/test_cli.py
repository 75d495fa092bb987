"""CLI front-end smoke tests (the reference's entry points, lib.rs:647-726,
reimagined as flags — SURVEY.md component 19/20)."""

import json
import sys

import numpy as np
import pytest

from nerf_rs_tpu.cli import main


def test_cli_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "backend" in out and "devices" in out


def test_cli_render_png(tmp_path, assets_dir, capsys):
    out = tmp_path / "img.png"
    rc = main([
        "render", "--width", "16", "--height", "16",
        "--coarse-samples", "8", "--fine-samples", "8",
        "--ray-chunk", "256", "--impl", "xla", "-o", str(out),
    ])
    assert rc == 0 and out.exists()
    from nerf_rs_tpu.io.image import load_png

    img = load_png(out)
    assert img.shape == (16, 16, 3)


def test_cli_render_ppm_sharded(tmp_path, assets_dir):
    out = tmp_path / "img.ppm"
    rc = main([
        "render", "--width", "16", "--height", "16",
        "--coarse-samples", "8", "--fine-samples", "8",
        "--ray-chunk", "128", "--impl", "xla", "--sharded", "-o", str(out),
    ])
    assert rc == 0 and out.exists()
    from nerf_rs_tpu.io.image import load_ppm

    img = load_ppm(out)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()


def test_cli_render_orbit(tmp_path, assets_dir):
    out = tmp_path / "turn.png"
    rc = main([
        "render", "--width", "8", "--height", "8",
        "--coarse-samples", "4", "--fine-samples", "4",
        "--ray-chunk", "64", "--impl", "xla", "--orbit", "3",
        "-o", str(out),
    ])
    assert rc == 0
    frames = sorted(tmp_path.glob("turn_*.png"))
    assert [f.name for f in frames] == ["turn_000.png", "turn_001.png",
                                        "turn_002.png"]
    from nerf_rs_tpu.io.image import load_png

    f0, f1 = load_png(frames[0]), load_png(frames[1])
    assert f0.shape == (8, 8, 3)
    assert np.abs(f0 - f1).max() > 0  # the view actually changed


def test_cli_verify_golden(assets_dir, capsys):
    assert main(["verify", "--impl", "xla"]) == 0
    out = capsys.readouterr().out
    assert "worst error" in out and "FAIL" not in out


def test_profiling_utils(capsys):
    from nerf_rs_tpu.utils.profiling import Phases, Progress, device_trace

    ph = Phases()
    with ph("a"):
        pass
    with ph("a"):
        pass
    totals = ph.report()
    assert ph.counts["a"] == 2 and "a" in totals

    prog = Progress(100, interval=0.0)
    prog.update(50)
    prog.update(50)
    out = capsys.readouterr().out
    assert "100/100" in out

    with device_trace(None):
        pass  # no-op path


def test_multihost_single_process_helpers():
    """Single-process behavior of the multi-host helpers (a real multi-host
    run needs N processes; the single-process path must be a no-op)."""
    import jax

    from nerf_rs_tpu.parallel.multihost import (
        gather_image_shards, initialize, process_ray_slice,
    )

    assert initialize() is False          # no coordinator env -> single process
    sl = process_ray_slice(100)
    assert sl == slice(0, 100)
    px = np.arange(30, dtype=np.float32).reshape(10, 3)
    out = gather_image_shards(px, 10)
    np.testing.assert_array_equal(out, px)


def test_cli_train_distill_and_resume(tmp_path, assets_dir):
    """Two tiny distillation train runs against the same checkpoint dir:
    the second resumes from the first's step (checkpoint/resume path,
    SIGTERM-safe loop shares the same save code)."""
    ck = str(tmp_path / "ck")
    args = ["train", "--steps", "2", "--batch-rays", "64",
            "--coarse-samples", "4", "--fine-samples", "8",
            "--ray-chunk", "64", "--impl", "xla",
            "--checkpoint-dir", ck, "--checkpoint-every", "100",
            "--log-every", "1"]
    assert main(args) == 0
    from nerf_rs_tpu.io.checkpoint import latest_checkpoint

    first = latest_checkpoint(ck)
    assert first is not None and first.name == "step_00000002"
    assert main([*args[:2], "4", *args[3:]]) == 0  # --steps 4, resumes at 2
    assert latest_checkpoint(ck).name == "step_00000004"


def test_cli_verify_image(assets_dir, capsys):
    assert main(["verify", "--impl", "xla", "--image"]) == 0
    out = capsys.readouterr().out
    assert "image vs committed golden" in out and "[OK]" in out


def test_cli_train_accel_refresh(tmp_path, assets_dir, capsys):
    """Occupancy-culled training path end-to-end: the grid refresh runs
    (warmup honored), degenerate grids fall back to dense, and the loop
    completes. A random-init student's grid is near-empty or (with heavy
    exploration) near-full — both degenerate branches print and train
    dense, which is exactly the designed behavior."""
    args = ["train", "--steps", "3", "--batch-rays", "64",
            "--coarse-samples", "4", "--fine-samples", "8",
            "--ray-chunk", "64", "--impl", "xla", "--log-every", "1",
            "--accel-every", "1", "--accel-res", "8",
            "--accel-warmup", "1", "--accel-explore", "0.6"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "accel:" in out  # refresh ran after warmup
    assert "step 2" in out


def test_cli_evaluate(tmp_path, assets_dir, capsys):
    ck = str(tmp_path / "ck")
    base = ["--coarse-samples", "4", "--fine-samples", "8",
            "--ray-chunk", "64", "--impl", "xla"]
    assert main(["train", "--steps", "1", "--batch-rays", "64",
                 *base, "--checkpoint-dir", ck, "--log-every", "1"]) == 0
    assert main(["evaluate", "--checkpoint-dir", ck, "--size", "8", *base]) == 0
    out = capsys.readouterr().out
    assert "PSNR vs teacher" in out


def test_cli_render_bare_export_weights(tmp_path, assets_dir):
    """`render --weights <cli-export dir>` (coarse/+fine/ only, no camera
    JSON) works: params load bare, the camera falls back to the pretrained
    assets' golden (or --camera); an unaligned student arch renders."""
    import jax

    from nerf_rs_tpu.config import ArchConfig
    from nerf_rs_tpu.io.weights import save_nerf_params
    from nerf_rs_tpu.models.mlp import init_nerf_params

    arch = ArchConfig(width=64, v_width=32, depth=4, skip_at=2)
    export = tmp_path / "export"
    save_nerf_params(export / "coarse",
                     init_nerf_params(jax.random.key(0), arch=arch))
    save_nerf_params(export / "fine",
                     init_nerf_params(jax.random.key(1), arch=arch))
    out = tmp_path / "img.png"
    rc = main(["render", "--weights", str(export), "--width", "8",
               "--height", "8", "--coarse-samples", "4",
               "--fine-samples", "8", "--ray-chunk", "64",
               "-o", str(out)])
    assert rc == 0 and out.exists()


def test_cli_train_hashgrid_roundtrip(tmp_path, assets_dir, capsys):
    """Hash-grid family end-to-end through the CLI: train (shared network,
    model.json sidecar), resume-guard against mismatched hash flags,
    evaluate, render --checkpoint, and the export guard (no reference .bin
    equivalent exists for hash tables)."""
    ck = str(tmp_path / "ck")
    base = ["--coarse-samples", "4", "--fine-samples", "8",
            "--ray-chunk", "64"]
    hash_flags = ["--model", "hashgrid", "--hash-levels", "2",
                  "--hash-table-log2", "10", "--hash-res-max", "16"]
    assert main(["train", "--steps", "2", "--batch-rays", "64", *base,
                 *hash_flags, "--checkpoint-dir", ck,
                 "--log-every", "1"]) == 0
    from nerf_rs_tpu.io.checkpoint import latest_checkpoint, load_model_config

    ckpt = latest_checkpoint(ck)
    assert ckpt is not None
    info = load_model_config(ckpt)
    assert info["model"] == "hashgrid" and info["hash"]["levels"] == 2

    # Resume with different hash flags must fail loudly (resolutions are
    # not inferable from the checkpoint arrays).
    with pytest.raises(SystemExit):
        main(["train", "--steps", "3", "--batch-rays", "64", *base,
              "--model", "hashgrid", "--hash-levels", "4",
              "--hash-table-log2", "10", "--hash-res-max", "16",
              "--checkpoint-dir", ck])
    # ...and with matching flags it resumes.
    assert main(["train", "--steps", "3", "--batch-rays", "64", *base,
                 *hash_flags, "--checkpoint-dir", ck,
                 "--log-every", "1"]) == 0
    assert latest_checkpoint(ck).name == "step_00000003"

    assert main(["evaluate", "--checkpoint-dir", ck, "--size", "8",
                 *base]) == 0
    assert "PSNR vs teacher" in capsys.readouterr().out

    out_png = tmp_path / "hash.png"
    assert main(["render", "--checkpoint", str(latest_checkpoint(ck)),
                 "--width", "8", "--height", "8", *base,
                 "-o", str(out_png)]) == 0
    assert out_png.exists()

    with pytest.raises(SystemExit):
        main(["export", "--checkpoint", str(latest_checkpoint(ck)),
              "-o", str(tmp_path / "exp")])


def test_cli_train_init_weights_and_eval_weights_dir(tmp_path, assets_dir, capsys):
    """Round-4 fine-tune surface: warm-start `train` from an exported .bin
    weight dir (--init-weights) and judge an export directly against the
    full-quality teacher reference (`evaluate --weights-dir --ref-samples`)
    — the workflow that retargets a distilled student to a reduced-sample
    or single-pass serving preset."""
    ck = str(tmp_path / "ck")
    exp = str(tmp_path / "exp")
    base = ["--width", "64", "--v-width", "32", "--depth", "2",
            "--skip-at", "1", "--batch-rays", "64",
            "--coarse-samples", "4", "--fine-samples", "8",
            "--ray-chunk", "64", "--impl", "xla", "--log-every", "1"]
    assert main(["train", "--steps", "1", *base, "--checkpoint-dir", ck,
                 "--checkpoint-every", "1"]) == 0
    from nerf_rs_tpu.io.checkpoint import latest_checkpoint

    assert main(["export", "--checkpoint", str(latest_checkpoint(ck)),
                 "-o", exp]) == 0
    capsys.readouterr()

    # warm start in a different serving regime (single-pass, fresh opt)
    assert main(["train", "--steps", "1", *base[:10],
                 "--coarse-samples", "4", "--fine-samples", "0",
                 "--ray-chunk", "64", "--impl", "xla", "--log-every", "1",
                 "--init-weights", exp]) == 0
    assert f"initialized params from {exp}" in capsys.readouterr().out

    # arch-mismatch guard fails loudly, not silently
    with pytest.raises(SystemExit):
        main(["train", "--steps", "1", "--width", "32", "--v-width", "32",
              "--depth", "2", "--skip-at", "1", "--batch-rays", "64",
              "--coarse-samples", "4", "--fine-samples", "8",
              "--ray-chunk", "64", "--impl", "xla",
              "--init-weights", exp])

    # resume wins over --init-weights when the dir already has a checkpoint
    assert main(["train", "--steps", "2", *base, "--checkpoint-dir", ck,
                 "--init-weights", exp]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "initialized params from" not in out

    # evaluate the export directly: single-pass config vs full reference
    assert main(["evaluate", "--weights-dir", exp, "--size", "8",
                 "--coarse-samples", "4", "--fine-samples", "0",
                 "--ref-samples", "4,8", "--impl", "xla"]) == 0
    assert "PSNR vs teacher" in capsys.readouterr().out


def test_cli_train_teacher_samples(tmp_path, assets_dir, capsys):
    """`train --teacher-samples NC,NF` (distillation only): the TEACHER
    renders targets at its own sample counts while the student trains at
    the serving preset — without it, a single-pass student would distill
    toward a teacher degraded to the student's own preset."""
    assert main(["train", "--steps", "1", "--batch-rays", "64",
                 "--width", "128", "--v-width", "64",
                 "--coarse-samples", "4", "--fine-samples", "0",
                 "--teacher-samples", "4,8", "--ray-chunk", "64",
                 "--impl", "xla", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "teacher targets at 4+8 samples" in out
