"""Bitrot guard for the examples gallery: run the cheap examples as real
subprocesses with tiny sizes (imports, flags, and API usage all exercised;
heavyweight ones — 06 multihost (self-launches 2 OS processes), 07
accel training — are covered by the unit suite for the same APIs)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(script, *args):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # examples force CPU via --cpu themselves
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT,
    )


@pytest.mark.parametrize("script,args", [
    ("01_render.py", ("--cpu", "--size", "16", "--out", "/tmp/ex01.png")),
    ("03_train_distillation.py",
     ("--cpu", "--steps", "2", "--batch-rays", "64", "--ckpt", "/tmp/ex03")),
    ("04_multichip_render.py", ("--cpu", "--size", "16")),
    ("05_occupancy_grid.py",
     ("--cpu", "--size", "16", "--resolution", "16")),
    ("08_turntable.py",
     ("--cpu", "--frames", "2", "--size", "16", "--outdir", "/tmp/ex08")),
    ("09_student_distillation.py",
     ("--cpu", "--steps", "2", "--batch-rays", "64", "--eval-size", "8")),
    ("10_geometry_export.py",
     ("--cpu", "--resolution", "16", "--out", "/tmp/ex10.ply")),
    ("11_hashgrid.py",
     ("--cpu", "--steps", "2", "--batch-rays", "64", "--levels", "2",
      "--table-log2", "10", "--res-max", "16", "--eval-size", "8",
      "--out", "/tmp/ex11.png")),
    ("12_int8_quantization.py",
     ("--cpu", "--size", "16", "--steps", "2", "--batch-rays", "64")),
])
def test_example_runs(script, args, assets_dir):
    r = _run(script, *args)
    assert r.returncode == 0, f"{script} failed:\n{r.stdout}\n{r.stderr}"
