"""bench.py contract: the driver runs it headless at end of round and a
round without a valid JSON line is a failed round — so the CLI surface
itself is under test (subprocess, CPU platform hatch, tiny config)."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run_bench(extra_env):
    env = dict(os.environ)
    env.update({
        "NERF_BENCH_PLATFORM": "cpu",
        "NERF_BENCH_SIZE": "16",
        "NERF_BENCH_REPEATS": "1",
        "NERF_BENCH_SAMPLES": "8,16",
        "NERF_BENCH_ACCEL_RES": "16",
        "NERF_BENCH_DEADLINE": "0",
    })
    env.update(extra_env)
    out = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=540)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, f"expected exactly one JSON line, got {out.stdout!r}"
    rec = json.loads(lines[0])
    for field in ("metric", "value", "unit", "vs_baseline"):
        assert field in rec, rec
    return rec


def test_bench_auto_accel_keeps_or_falls_back():
    """Default config (ACCEL=auto): either outcome is fine, but the record
    must be valid and unflagged — auto may never emit an error for a
    below-contract accel run, it must fall back to the exact path."""
    rec = _run_bench({})
    assert rec["value"] > 0
    assert "error" not in rec
    if "+accel" in rec["metric"]:
        assert rec["accel_psnr_db"] >= 40.0
    else:
        assert "auto-rejected" in rec.get("note", "") or "auto-disabled" in rec.get("note", "")


def test_bench_auto_rejects_bad_accel_config():
    """A culling config mis-tuned on purpose: auto must report the exact
    path (no +accel tag, no error) with the rejection note."""
    rec = _run_bench({"NERF_BENCH_ACCEL_T": "0.9", "NERF_BENCH_ACCEL_SLACK": "0"})
    assert rec["value"] > 0
    assert "error" not in rec
    assert "+accel" not in rec["metric"]
    assert "auto-rejected" in rec.get("note", "")


def test_bench_explicit_accel_flags_bad_config_as_error():
    """NERF_BENCH_ACCEL=1 keeps round-1 semantics: a below-contract run is
    reported but flagged invalid (vs_baseline zeroed + error field)."""
    # Termination culling lives in the masking modes; the round-3 default
    # accel_compact="off" ignores NERF_BENCH_ACCEL_T entirely.
    rec = _run_bench({"NERF_BENCH_ACCEL": "1", "NERF_ACCEL_COMPACT": "none",
                      "NERF_BENCH_ACCEL_T": "0.9", "NERF_BENCH_ACCEL_SLACK": "0"})
    assert rec["vs_baseline"] == 0.0
    assert "accel_psnr_db" in rec and rec["accel_psnr_db"] < 40.0
    assert "40 dB contract" in rec["error"]


def test_bench_hashgrid_model_and_trained_checkpoint(tmp_path):
    """The watcher chain's final steps: NERF_BENCH_MODEL=hashgrid
    (random-init) and NERF_BENCH_CHECKPOINT on a cli-train hashgrid
    checkpoint must both emit one valid, correctly-labeled JSON line."""
    rec = _run_bench({"NERF_BENCH_MODEL": "hashgrid",
                      "NERF_BENCH_ACCEL": "0"})
    assert "+hashgrid" in rec["metric"] and "xla" in rec["metric"]
    assert rec["value"] > 0

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    ck = str(tmp_path / "ck")
    out = subprocess.run(
        [sys.executable, "-m", "nerf_rs_tpu", "train", "--model", "hashgrid",
         "--hash-levels", "2", "--hash-table-log2", "10",
         "--hash-res-max", "16", "--coarse-samples", "4",
         "--fine-samples", "8", "--ray-chunk", "64", "--batch-rays", "64",
         "--steps", "1", "--checkpoint-dir", ck, "--log-every", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=540)
    assert out.returncode == 0, out.stderr[-2000:]
    step = sorted(Path(ck).glob("step_*"))[-1]
    # No NERF_BENCH_MODEL: the sidecar alone must flip the label to
    # xla/+hashgrid (metric-series integrity).
    rec = _run_bench({"NERF_BENCH_CHECKPOINT": str(step),
                      "NERF_BENCH_ACCEL": "0"})
    assert "+hashgrid+checkpoint" in rec["metric"]
    assert "pallas" not in rec["metric"]
    assert rec["value"] > 0


def test_frontier_presets_gating(monkeypatch):
    """Frontier records are emitted ONLY on the bare headline run (the GPU,
    or NERF_BENCH_PLATFORM=gpu): CPU smokes, sweep legs (any env
    override), and NERF_BENCH_EXTRA=0 must stay one-line (the
    `len(lines) == 1` contract above depends on it)."""
    sys.path.insert(0, str(REPO))
    try:
        import bench

        for var in ("NERF_BENCH_PLATFORM", "NERF_BENCH_EXTRA",
                    "NERF_BENCH_MODE", "NERF_BENCH_SIZE",
                    "NERF_BENCH_SAMPLES", "NERF_BENCH_WEIGHTS",
                    "NERF_BENCH_CHECKPOINT", "NERF_BENCH_ARCH",
                    "NERF_BENCH_MODEL", "NERF_BENCH_IMPL",
                    "NERF_BENCH_DTYPE", "NERF_BENCH_CHUNK"):
            monkeypatch.delenv(var, raising=False)
        assert bench._frontier_presets_due()                    # bare run
        monkeypatch.setenv("NERF_BENCH_PLATFORM", "gpu")
        assert bench._frontier_presets_due()
        monkeypatch.setenv("NERF_BENCH_PLATFORM", "cpu")        # smoke
        assert not bench._frontier_presets_due()
        monkeypatch.delenv("NERF_BENCH_PLATFORM")
        monkeypatch.setenv("NERF_BENCH_WEIGHTS", "/tmp/w")      # sweep leg
        assert not bench._frontier_presets_due()
        monkeypatch.delenv("NERF_BENCH_WEIGHTS")
        monkeypatch.setenv("NERF_BENCH_EXTRA", "0")             # opt-out
        assert not bench._frontier_presets_due()
        # Preset weight dirs must exist (vendored assets) — a rename would
        # otherwise silently emit error records at round end.
        for _name, env_over in bench._FRONTIER_PRESETS:
            w = env_over.get("NERF_BENCH_WEIGHTS")
            if w:
                assert (REPO / w).is_dir(), w
    finally:
        sys.path.remove(str(REPO))


def test_bench_default_metric_is_headline_config(monkeypatch):
    """A BARE `python bench.py` runs the lossless probe-cull accel config
    (probe culling 32, stride 4, compact off). Pin the metric label so a
    default regression cannot silently demote the headline series."""
    sys.path.insert(0, str(REPO))
    try:
        import bench

        for var in ("NERF_BENCH_ACCEL", "NERF_BENCH_AABB_PROBES",
                    "NERF_BENCH_RANGE_STRIDE", "NERF_ACCEL_COMPACT",
                    "NERF_BENCH_MODE", "NERF_BENCH_SIZE",
                    "NERF_BENCH_SAMPLES", "NERF_BENCH_ARCH"):
            monkeypatch.delenv(var, raising=False)
        name = bench._metric_name()
        assert "+accel" in name
        assert "+probecull32" in name
        assert "+stride4" in name
        assert "+coff" in name
        assert "800x800 64+128" in name
    finally:
        sys.path.remove(str(REPO))


def test_records_name_device_and_power_limit(monkeypatch):
    """Every record carries JAX's platform/device_kind/count and the
    nvidia-smi name/power-limit line ("" where nvidia-smi is absent)."""
    sys.path.insert(0, str(REPO))
    try:
        import bench

        monkeypatch.setenv("PATH", "/nonexistent")
        assert bench._power_limit() == ""
        fields = bench._device_fields()
        assert fields["device"]["platform"] == "cpu"
        assert fields["device"]["count"] >= 1 and fields["device"]["kind"]
        assert fields["power_limit"] == ""
    finally:
        sys.path.remove(str(REPO))
