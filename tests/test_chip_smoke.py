"""chip_smoke.py: the GPU smoke test's refusal without a GPU, and every
phase function at a tiny size on the CPU (the sharded phase on 4 of the 8
virtual devices). The real sizes run only on the card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TINY = chip_smoke.Scale(
    size=24, samples=(16, 32), single_pass=32, ray_chunk=256, grid_res=24,
    probes=16, stride=2, mlp_rays=64, train_batch=64, train_steps=1,
    train_probes=16, serve_size=16, leg_size=8, leg_samples=(8, 16),
    repeats=1,
    # 24x24 at 32+0 vs a 16+32 teacher: far below the 800x800 floor.
    min_single_pass_db=15.0)


@pytest.fixture()
def log(capsys):
    return chip_smoke.Log("cpu test")


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_keeps_host_cpu_platform(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    chip_smoke._platforms_with_host_cpu()
    assert os.environ["JAX_PLATFORMS"] == "cuda,cpu"
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    chip_smoke._platforms_with_host_cpu()
    assert os.environ["JAX_PLATFORMS"] == "cpu"


def test_phase_numerics(log, assets_dir, capsys):
    chip_smoke.phase_numerics(TINY, log)
    assert "golden samples" in capsys.readouterr().out


def test_phase_teacher_and_single_pass(log, assets_dir, capsys):
    reference = chip_smoke.phase_teacher(TINY, log)
    assert reference.shape == (24, 24, 3)
    chip_smoke.phase_single_pass(TINY, log, reference)
    out = capsys.readouterr().out
    assert "bf16 vs f32 exact frame" in out
    assert "student128_sp29" in out and "teacher_sp30" in out


def test_phase_train(log, assets_dir, tmp_path, capsys):
    chip_smoke.phase_train(TINY, log, str(tmp_path))
    assert "checkpoint step_00000002" in capsys.readouterr().out


def test_phase_serve(log, assets_dir, capsys):
    from nerf_rs_tpu import api

    try:
        chip_smoke.phase_serve(TINY, log)
    finally:
        api._state.clear()
    assert "serve /render 16x16 seed 2" in capsys.readouterr().out


def test_phase_legs(log, assets_dir, capsys):
    chip_smoke.phase_legs(TINY, log)
    out = capsys.readouterr().out
    assert "hashgrid train step" in out and "int8" in out


def test_phase_sharded_on_four_devices(log, assets_dir, capsys):
    chip_smoke.phase_sharded(TINY, log, 4)
    assert "bitwise equal" in capsys.readouterr().out


def test_check_raises():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="broken"):
        chip_smoke.check(False, "broken")
