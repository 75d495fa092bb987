"""Checkpoint I/O for the reference `.bin` weight format.

The reference stores each network as a directory of raw little-endian f32
row-major tensors plus a ``shapes.txt`` manifest (one ``name dim0 [dim1]``
per line) — loader at /root/reference/src/lib.rs:34-174, format doc at
lego_rust/README.md:23-36.  Here the same format round-trips to/from a JAX
param pytree ``{layer: {"kernel": (in, out), "bias": (out,)}}``.

Kernels are stored ``(input_dim, output_dim)`` row-major, so the forward is
``x @ kernel + bias`` with ``x`` laid out ``(batch, features)`` — the same
math as the reference's transposed GEMM on ``(features, batch)`` activations
(network.rs:90-122), but in the batch-major layout XLA's GEMMs prefer.

When the optional C++ fast-IO extension is built (csrc/nerf_io.cpp), bulk
tensor reads go through it; otherwise numpy.fromfile is used.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# Fixed inventory of the NeRF MLP's parameters (lego_rust/*/shapes.txt).
LAYER_NAMES: Tuple[str, ...] = (
    "dense0",
    "dense1",
    "dense2",
    "dense3",
    "dense4",
    "dense5",
    "dense6",
    "dense7",
    "bottleneck",
    "viewdirs",
    "rgb",
    "alpha",
)

# Canonical shapes for the lego architecture (coarse and fine are identical):
# dense0 63x256, dense1-4 256x256, dense5 319x256 (skip), dense6-7 256x256,
# bottleneck 256x256, viewdirs 283x128, rgb 128x3, alpha 256x1.
CANONICAL_SHAPES: Dict[str, Tuple[int, int]] = {
    "dense0": (63, 256),
    "dense1": (256, 256),
    "dense2": (256, 256),
    "dense3": (256, 256),
    "dense4": (256, 256),
    "dense5": (319, 256),
    "dense6": (256, 256),
    "dense7": (256, 256),
    "bottleneck": (256, 256),
    "viewdirs": (283, 128),
    "rgb": (128, 3),
    "alpha": (256, 1),
}

ASSET_ENV_VAR = "NERF_RS_TPU_ASSETS"
_DEFAULT_ASSET_DIRS = (
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "assets", "lego_rust"),
    "/root/reference/lego_rust",
)


def find_lego_assets() -> Optional[Path]:
    """Locate the pretrained lego weight bundle (coarse/ + fine/ + golden JSON).

    Search order: $NERF_RS_TPU_ASSETS, the vendored repo-local
    ``assets/lego_rust`` (self-contained deploys — SHA256SUMS committed
    alongside), then the mounted reference assets. Returns None when
    unavailable so tests can skip gracefully.
    """
    candidates = []
    if os.environ.get(ASSET_ENV_VAR):
        candidates.append(os.environ[ASSET_ENV_VAR])
    candidates.extend(_DEFAULT_ASSET_DIRS)
    for cand in candidates:
        p = Path(cand)
        if p.suffix == ".npz" and p.is_file():
            return p  # single-file bundle (save_bundle)
        if (p / "coarse" / "shapes.txt").exists() and (p / "fine" / "shapes.txt").exists():
            return p
    return None


def read_shapes(path: Path) -> List[Tuple[str, Tuple[int, ...]]]:
    """Parse a ``shapes.txt`` manifest (name followed by dims, whitespace-split)."""
    entries: List[Tuple[str, Tuple[int, ...]]] = []
    for line in path.read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        entries.append((parts[0], tuple(int(d) for d in parts[1:])))
    return entries


def _read_tensor_numpy(path: Path, dims: Tuple[int, ...]) -> np.ndarray:
    arr = np.fromfile(path, dtype="<f4")
    expected = int(np.prod(dims)) if dims else arr.size
    if arr.size != expected:
        raise ValueError(f"{path}: expected {expected} f32 values, got {arr.size}")
    return arr.reshape(dims)


def _read_tensor(path: Path, dims: Tuple[int, ...]) -> np.ndarray:
    try:
        from nerf_rs_tpu.io import native  # optional C++ fast path

        if native.available():
            return native.read_tensor_f32(str(path), dims)
    except Exception:
        pass
    return _read_tensor_numpy(path, dims)




def param_layer_names(params_or_keys) -> Tuple[str, ...]:
    """Ordered layer list for any ArchConfig family member: dense0..N in
    index order, then the four heads. The canonical arch yields exactly
    LAYER_NAMES (the reference's fixed list, lib.rs:133-169)."""
    keys = set(params_or_keys)
    dense = sorted((k for k in keys if re.fullmatch(r"dense\d+", k)),
                   key=lambda k: int(k[5:]))
    heads = tuple(h for h in ("bottleneck", "viewdirs", "rgb", "alpha") if h in keys)
    return tuple(dense) + heads

def load_raw_params(directory: os.PathLike) -> Dict[str, np.ndarray]:
    """Load every tensor named in ``shapes.txt`` from ``directory``."""
    directory = Path(directory)
    out: Dict[str, np.ndarray] = {}
    for name, dims in read_shapes(directory / "shapes.txt"):
        out[name] = _read_tensor(directory / f"{name}.bin", dims)
    return out


def load_nerf_params(
    directory: os.PathLike, dtype=np.float32, device_put: bool = True
) -> Dict[str, Dict[str, np.ndarray]]:
    """Assemble the param pytree from a reference-format weight directory.

    Mirrors the fixed name list of the reference loader (lib.rs:133-169) and
    its "no unused parameters" check (lib.rs:171).

    By default the pytree is committed to the default JAX device: leaving the
    leaves as host numpy arrays makes EVERY jit call re-upload all 2.4 MB of
    weights. ``device_put=False`` returns raw numpy.
    """
    raw = load_raw_params(directory)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    layers = param_layer_names(
        {n[: -len("_kernel")] for n in raw if n.endswith("_kernel")})
    for layer in layers:
        kernel = raw.pop(f"{layer}_kernel")
        bias = raw.pop(f"{layer}_bias")
        if kernel.ndim != 2:
            raise ValueError(f"{layer}_kernel must be rank-2, got {kernel.shape}")
        if bias.shape != (kernel.shape[1],):
            raise ValueError(
                f"{layer}_bias shape {bias.shape} does not match kernel {kernel.shape}"
            )
        params[layer] = {
            "kernel": kernel.astype(dtype),
            "bias": bias.astype(dtype),
        }
    if raw:
        raise ValueError(f"unused parameters left after load: {sorted(raw)}")
    # Fail at LOAD time, not as an opaque KeyError deep inside jit tracing:
    # the layer list is derived from whatever shapes.txt names (any
    # ArchConfig member), so a directory missing a head or a dense layer
    # would otherwise assemble "successfully".
    validate_param_chain(params)
    if device_put:
        import jax

        params = jax.device_put(params)
    return params


def save_nerf_params(directory: os.PathLike, params) -> None:
    """Write a param pytree back out in the reference `.bin` + shapes.txt format,
    so checkpoints trained here load in the reference renderer unchanged."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    lines = []
    for layer in param_layer_names(params):
        kernel = np.asarray(params[layer]["kernel"], dtype="<f4")
        bias = np.asarray(params[layer]["bias"], dtype="<f4")
        kernel.tofile(directory / f"{layer}_kernel.bin")
        bias.tofile(directory / f"{layer}_bias.bin")
        lines.append(f"{layer}_kernel {kernel.shape[0]} {kernel.shape[1]}")
        lines.append(f"{layer}_bias {bias.shape[0]}")
    (directory / "shapes.txt").write_text("\n".join(lines) + "\n")


def save_bundle(path: os.PathLike, coarse_params, fine_params,
                golden_json_text: str) -> None:
    """Pack both networks + the camera/golden JSON into ONE ``.npz`` file.

    The analogue of the reference's weights-in-the-binary wasm
    embedding (/root/reference/src/weights.rs:1-100, include_bytes! of all
    48 tensors + shapes.txt + the JSON): a single self-contained artifact
    that initializes the renderer with no directory tree and no mounted
    reference. Load with :func:`load_bundle`, or point
    ``$NERF_RS_TPU_ASSETS`` / ``init_renderer(assets_dir=...)`` at it.
    """
    arrays: Dict[str, np.ndarray] = {}
    for net, params in (("coarse", coarse_params), ("fine", fine_params)):
        for layer in param_layer_names(params):
            arrays[f"{net}.{layer}.kernel"] = np.asarray(
                params[layer]["kernel"], dtype="<f4")
            arrays[f"{net}.{layer}.bias"] = np.asarray(
                params[layer]["bias"], dtype="<f4")
    arrays["golden_json"] = np.frombuffer(
        golden_json_text.encode("utf-8"), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_bundle(path: os.PathLike, dtype=np.float32, device_put: bool = True):
    """Load a :func:`save_bundle` artifact -> ``(params, golden_dict)`` with
    ``params = {"coarse": pytree, "fine": pytree}`` (same pytree contract and
    shape validation as :func:`load_nerf_params`)."""
    import json

    with np.load(Path(path)) as z:
        golden = json.loads(bytes(z["golden_json"]).decode("utf-8"))
        params: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
        for net in ("coarse", "fine"):
            tree: Dict[str, Dict[str, np.ndarray]] = {}
            layers = param_layer_names(
                {f.split(".")[1] for f in z.files
                 if f.startswith(f"{net}.") and f.endswith(".kernel")})
            for layer in layers:
                tree[layer] = {
                    "kernel": z[f"{net}.{layer}.kernel"].astype(dtype),
                    "bias": z[f"{net}.{layer}.bias"].astype(dtype),
                }
            validate_param_chain(tree)   # any ArchConfig member, not just canonical
            params[net] = tree
    if device_put:
        import jax

        params = jax.device_put(params)
    return params, golden


def load_scene_assets(assets: os.PathLike, dtype=np.float32,
                      device_put: bool = True):
    """Uniform scene loader: ``assets`` is either a reference-format weight
    directory (coarse/ + fine/ + tf_reference_samples.json) or a single
    ``.npz`` bundle from :func:`save_bundle`. Returns
    ``({"coarse": pytree, "fine": pytree}, golden_dict)``."""
    import json

    assets = Path(assets)
    if assets.is_file():
        return load_bundle(assets, dtype=dtype, device_put=device_put)
    params = {
        "coarse": load_nerf_params(assets / "coarse", dtype=dtype,
                                   device_put=device_put),
        "fine": load_nerf_params(assets / "fine", dtype=dtype,
                                 device_put=device_put),
    }
    with open(assets / "tf_reference_samples.json") as f:
        golden = json.load(f)
    return params, golden


def validate_param_shapes(params) -> None:
    """Assert the pytree matches the canonical lego architecture."""
    for layer, (d_in, d_out) in CANONICAL_SHAPES.items():
        k = params[layer]["kernel"]
        b = params[layer]["bias"]
        if tuple(k.shape) != (d_in, d_out):
            raise ValueError(f"{layer}.kernel: expected {(d_in, d_out)}, got {tuple(k.shape)}")
        if tuple(b.shape) != (d_out,):
            raise ValueError(f"{layer}.bias: expected {(d_out,)}, got {tuple(b.shape)}")


def validate_param_chain(params, x_freqs: int = 10, d_freqs: int = 4) -> None:
    """Assert a (possibly non-canonical) pytree is a consistent ArchConfig
    family member: trunk dims chain (with exactly one skip re-concat of the
    encoded input allowed), heads consume the trunk width, rgb consumes the
    view branch. Accepts everything models.mlp.nerf_mlp can run."""
    enc_x, enc_d = 3 + 6 * x_freqs, 3 + 6 * d_freqs
    layers = param_layer_names(params)
    dense = [n for n in layers if n.startswith("dense")]
    if not dense or dense != [f"dense{i}" for i in range(len(dense))]:
        raise ValueError(f"trunk layers must be dense0..N, got {dense}")
    for head in ("bottleneck", "viewdirs", "rgb", "alpha"):
        if head not in layers:
            raise ValueError(f"missing head layer {head!r}")
    h = enc_x
    skips = 0
    for name in dense:
        k = params[name]["kernel"]
        b = params[name]["bias"]
        if tuple(b.shape) != (k.shape[1],):
            raise ValueError(f"{name}.bias {tuple(b.shape)} != kernel cols {k.shape[1]}")
        if k.shape[0] == h + enc_x and name != "dense0":
            skips += 1                      # skip concat feeds this layer
        elif k.shape[0] != h:
            raise ValueError(
                f"{name}.kernel input dim {k.shape[0]} matches neither the "
                f"running width {h} nor a skip concat {h + enc_x}")
        h = k.shape[1]
    if skips > 1:
        raise ValueError(f"expected at most one skip concat, found {skips}")
    width = h
    for name, d_in in (("bottleneck", width), ("alpha", width),
                       ("viewdirs", width + enc_d)):
        if params[name]["kernel"].shape[0] != d_in:
            raise ValueError(
                f"{name}.kernel input dim {params[name]['kernel'].shape[0]} "
                f"!= expected {d_in}")
    v_width = params["viewdirs"]["kernel"].shape[1]
    if tuple(params["rgb"]["kernel"].shape) != (v_width, 3):
        raise ValueError(
            f"rgb.kernel {tuple(params['rgb']['kernel'].shape)} != ({v_width}, 3)")
    if params["alpha"]["kernel"].shape[1] != 1:
        raise ValueError("alpha.kernel must have 1 output column")
