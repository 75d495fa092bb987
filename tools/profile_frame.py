"""Where the device time of one teacher frame goes, on the GPU.

Renders the headline exact frame (pretrained lego teacher, 800x800,
64+128 samples, bf16 operands, ray_chunk 16384), times it, traces one
frame with jax.profiler, and splits the trace's device kernel time by the
render's named scopes (render.render_rays: coarse_mlp, resample,
fine_mlp). Then times the fine MLP and the resampling chain alone at the
frame's per-chunk shape for their achieved rates, and lists the GEMM
kernels XLA picked.

    python tools/profile_frame.py [--size 800] [--out chiprun_out/profile]

Needs a GPU (exits 2 otherwise). Writes <out>/profile_frame.json.

The tool turns XLA's CUDA command buffers off (--xla_gpu_enable_command_
buffer=): inside a command buffer every kernel reports the op
"command_buffer", which hides the scope it belongs to. Kernel device
times are unaffected; host launch overhead is not what this measures.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_gpu_enable_command_buffer=").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

STAGES = ("coarse_mlp", "resample", "fine_mlp")


def mlp_flops_per_sample(params, sigma_only: bool = False) -> int:
    """2 * sum(d_in * d_out) over the layers a forward evaluates."""
    total = 0
    for name, layer in params.items():
        if sigma_only and name in ("bottleneck", "viewdirs", "rgb"):
            continue
        d_in, d_out = layer["kernel"].shape
        total += 2 * d_in * d_out
    return total


def _device_events(trace_dir):
    """(name, duration_ns, stats dict) of every event on a GPU plane."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    data = ProfileData.from_file(paths[-1])
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                out.append((ev.name, ev.duration_ns, ev.start_ns,
                            dict(ev.stats), line.name))
    return out


def _op_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> op_name metadata (carries named scopes)."""
    scopes = {}
    for m in re.finditer(r"%?([\w.\-]+) = [^\n]*?metadata=\{[^}]*op_name=\"([^\"]*)\"",
                         hlo_text):
        scopes[m.group(1)] = m.group(2)
    return scopes


def _busy_ns(events) -> float:
    """Union of the event intervals (device busy time)."""
    iv = sorted((s, s + d) for _, d, s, _, _ in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _time(fn, *args, n=10):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        print("profile_frame: needs a GPU", file=sys.stderr)
        return 2

    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.models.mlp import nerf_mlp
    from nerf_rs_tpu.ops.sampling import importance_samples, merge_samples, stratified_samples
    from nerf_rs_tpu.ops.volume import compute_weights
    from nerf_rs_tpu.render import render_image
    from nerf_rs_tpu.utils import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    assets = find_lego_assets()
    pc = load_nerf_params(assets / "coarse")
    pf = load_nerf_params(assets / "fine")
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    chunk = 16384
    cfg = RenderConfig(n_coarse=64, n_fine=128, ray_chunk=chunk,
                       dtype="bfloat16")
    size = args.size
    key = jax.random.key(0)
    n_chunks = -(-size * size // chunk)
    res = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "size": size, "ray_chunk": chunk, "chunks": n_chunks}

    def frame():
        return render_image(pc, pf, camera, size, size, key, cfg)

    res["frame_s"] = _time(frame, n=3)
    os.makedirs(args.out, exist_ok=True)
    trace_dir = os.path.join(args.out, "trace")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(frame())
    events = _device_events(trace_dir)

    # Scope attribution: kernel events carry the HLO op they run
    # ("hlo_op"); the compiled program's metadata maps it to its scope.
    from nerf_rs_tpu.ops.rays import camera_rays
    from nerf_rs_tpu.render import _render_flat

    _, dirs = camera_rays(camera, size, size)
    n_pad = n_chunks * chunk
    dirs_flat = jnp.concatenate(
        [dirs.reshape(-1, 3), jnp.ones((n_pad - size * size, 3))], axis=0)
    hlo = _render_flat.lower(
        pc, pf, jnp.asarray(camera.position), dirs_flat,
        jnp.asarray(camera.near), jnp.asarray(camera.far), key, n_pad,
        cfg).compile().as_text()
    scopes = _op_scopes(hlo)
    by_stage = collections.Counter()
    by_kernel = collections.Counter()
    stat_keys = set()
    for name, dur, _, stats, _ in events:
        stat_keys.update(stats)
        by_kernel[name] += dur
        op = str(stats.get("hlo_op", ""))
        scope = scopes.get(op, "") or scopes.get(re.sub(r"_(\d+)$", r".\1", name), "")
        stage = next((s for s in STAGES if f"/{s}/" in scope or scope.endswith(s)),
                     "other")
        by_stage[stage] += dur
    kernel_ns = sum(by_kernel.values())
    res["trace"] = {
        "events": len(events),
        "kernel_ns_sum": kernel_ns,
        "busy_ns": _busy_ns(events),
        "stat_keys": sorted(stat_keys),
        "stage_ns": dict(by_stage),
        "hlo_ops_sample": sorted({str(e[3].get("hlo_op")) for e in events})[:40],
        "top_kernels": [(k, v) for k, v in by_kernel.most_common(25)],
        "gemm_kernels": sorted({k for k in by_kernel
                                if re.search(r"gemm|cutlass|xmma|wgmma|sm90|triton_dot|cublas",
                                             k, re.I)}),
    }

    # Stand-alone stages at the per-chunk shape.
    rng = np.random.default_rng(0)
    d = rng.normal(size=(chunk, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dirs_c = jnp.asarray(d)
    origin = jnp.asarray(camera.position)
    t_c = stratified_samples(jax.random.key(1), 2.0, 6.0, 64, (chunk,))
    pts_c = origin + dirs_c[:, None] * t_c[..., None]
    t_f = jnp.sort(jnp.concatenate(
        [t_c, jnp.asarray(rng.uniform(2, 6, (chunk, 128)).astype(np.float32))],
        -1), -1)
    pts_f = origin + dirs_c[:, None] * t_f[..., None]
    fine = jax.jit(lambda p, x, v: nerf_mlp(p, x, v, dtype="bfloat16"))
    coarse = jax.jit(lambda p, x, v: nerf_mlp(p, x, v, dtype="bfloat16",
                                              sigma_only=True))

    @jax.jit
    def resample(sigma, t, k):
        w = compute_weights(sigma, t, 6.0)
        return merge_samples(t, importance_samples(k, t, w, 128))

    fine_s = _time(fine, pf, pts_f, dirs_c[:, None])
    coarse_s = _time(coarse, pc, pts_c, dirs_c[:, None])
    sigma = coarse(pc, pts_c, dirs_c[:, None])[1]
    resample_s = _time(resample, sigma, t_c, jax.random.key(2))
    f_fine = mlp_flops_per_sample(pf) * chunk * 192
    f_coarse = mlp_flops_per_sample(pc, sigma_only=True) * chunk * 64
    res["standalone"] = {
        "fine_mlp_chunk_s": fine_s,
        "fine_mlp_tflops": f_fine / fine_s / 1e12,
        "fine_mlp_frame_s": fine_s * n_chunks,
        "coarse_mlp_chunk_s": coarse_s,
        "coarse_mlp_tflops": f_coarse / coarse_s / 1e12,
        "resample_chunk_s": resample_s,
        "resample_frame_s": resample_s * n_chunks,
        "flops_per_sample_fine": mlp_flops_per_sample(pf),
    }
    with jax.profiler.trace(os.path.join(args.out, "trace_fine")):
        jax.block_until_ready(fine(pf, pts_f, dirs_c[:, None]))
    ev = _device_events(os.path.join(args.out, "trace_fine"))
    per = collections.Counter()
    for name, dur, _, _, _ in ev:
        per[name] += dur
    res["standalone"]["fine_mlp_trace_ns"] = sum(per.values())
    res["standalone"]["fine_mlp_kernels"] = per.most_common(20)

    with open(os.path.join(args.out, "profile_frame.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    st = res["standalone"]
    tr = res["trace"]
    print(f"card: {card}")
    print(f"frame {size}x{size} 64+128 bf16 exact: {res['frame_s'] * 1e3:.1f} ms "
          f"({size * size / res['frame_s']:,.0f} rays/s)")
    print(f"trace: kernel sum {tr['kernel_ns_sum'] / 1e6:.1f} ms, busy "
          f"{tr['busy_ns'] / 1e6:.1f} ms; by scope (ms): "
          + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in tr["stage_ns"].items()))
    print(f"fine MLP alone, {chunk}x192 samples: {st['fine_mlp_chunk_s'] * 1e3:.2f} ms "
          f"({st['fine_mlp_tflops']:.1f} TFLOP/s; trace "
          f"{st['fine_mlp_trace_ns'] / 1e6:.2f} ms) x {n_chunks} chunks = "
          f"{st['fine_mlp_frame_s'] * 1e3:.1f} ms/frame")
    print(f"coarse MLP alone, {chunk}x64 sigma-only: "
          f"{st['coarse_mlp_chunk_s'] * 1e3:.2f} ms ({st['coarse_mlp_tflops']:.1f} TFLOP/s)")
    print(f"resample chain alone, {chunk} rays: {st['resample_chunk_s'] * 1e3:.2f} ms "
          f"x {n_chunks} = {st['resample_frame_s'] * 1e3:.1f} ms/frame")
    print("GEMM kernels:", "; ".join(tr["gemm_kernels"][:10]))
    print("top kernels (ms):", "; ".join(f"{k[:60]} {v / 1e6:.1f}"
                                          for k, v in tr["top_kernels"][:10]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
