"""Training checkpoints (.npz state files) + reference `.bin` export.

The reference's only "checkpoint format" is the shapes.txt + raw LE-f32 .bin
directory it loads from (/root/reference/src/lib.rs:108-174); it cannot save.
Here training state (params + optimizer + step) round-trips through one
``state.npz`` per step directory, keyed by each leaf's pytree path, and the
params alone can be exported to the reference format so a reference-renderer
user can consume trained checkpoints.

Layout::

    <checkpoint_dir>/model.json              model-family sidecar
    <checkpoint_dir>/step_00000500/state.npz ".step", ".params['coarse'][...]",
                                             ".opt_state[0].mu[...]", ...
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Dict, Optional

import jax
import numpy as np

from nerf_rs_tpu.io.weights import load_nerf_params, save_nerf_params

_STATE_FILE = "state.npz"
_STEP_DIR = re.compile(r"step_\d+")
_DICT_KEY = re.compile(r"\['([^']*)'\]")


def save_checkpoint(directory, state, *, keep: int = 3) -> Path:
    """Save TrainState at <directory>/step_<N>/state.npz; prunes old steps.

    The step directory is written under a temporary name and renamed into
    place, so a crash mid-save never leaves a half-written ``step_<N>``
    that ``latest_checkpoint`` would pick up."""
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    step = int(state.step)
    path = directory / f"step_{step:08d}"
    tmp = directory / f".{path.name}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    arrays = {jax.tree_util.keystr(k): np.asarray(v) for k, v in leaves}
    with open(tmp / _STATE_FILE, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    for old in _step_dirs(directory)[:-keep]:
        shutil.rmtree(old)
    return path


def _step_dirs(directory: Path):
    return sorted(p for p in directory.glob("step_*")
                  if _STEP_DIR.fullmatch(p.name) and (p / _STATE_FILE).is_file())


def latest_checkpoint(directory) -> Optional[Path]:
    directory = Path(directory)
    if not directory.is_dir():
        return None
    steps = _step_dirs(directory)
    return steps[-1] if steps else None


def _load_arrays(path) -> Dict[str, np.ndarray]:
    with np.load(Path(path) / _STATE_FILE) as z:
        return {k: z[k] for k in z.files}


def restore_checkpoint(path, template):
    """Restore a TrainState saved by save_checkpoint. ``template`` is a state
    with the right structure (e.g. from create_train_state); every leaf's
    path and shape must match the saved one. Restored leaves are host
    numpy arrays."""
    arrays = _load_arrays(path)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for k, v in leaves:
        name = jax.tree_util.keystr(k)
        if name not in arrays:
            raise ValueError(f"checkpoint {path} has no leaf {name}")
        a = arrays[name]
        if a.shape != np.shape(v):
            raise ValueError(f"checkpoint {path} leaf {name} has shape "
                             f"{a.shape}, the template {np.shape(v)}")
        out.append(a)
    if len(arrays) != len(leaves):
        extra = sorted(set(arrays) - {jax.tree_util.keystr(k) for k, _ in leaves})
        raise ValueError(f"checkpoint {path} holds leaves the template lacks: "
                         f"{extra[:5]}")
    return jax.tree_util.tree_unflatten(treedef, out)


def _params_tree(path, only: Optional[str] = None) -> dict:
    """Nested param dict rebuilt from the saved ``.params[...]`` key paths
    (param trees are str-keyed dicts all the way down). ``only`` limits the
    read to one top-level subtree."""
    tree: dict = {}
    with np.load(Path(path) / _STATE_FILE) as z:
        for name in z.files:
            if not name.startswith(".params["):
                continue
            keys = _DICT_KEY.findall(name)
            if only is not None and keys[0] != only:
                continue
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = z[name]
    return tree


def checkpoint_kernel_shapes(path):
    """{layer: kernel shape} of a checkpoint's coarse net — the cheap way to
    detect an architecture mismatch before a full templated restore."""
    return {layer: tuple(leaf["kernel"].shape)
            for layer, leaf in _params_tree(path, "coarse")["coarse"].items()}


def checkpoint_param_keys(path) -> set:
    """Top-level param-subtree keys of a checkpoint ({'coarse', 'fine'} for
    the MLP family, {'shared'} for hashgrid), read from the key paths only —
    the cheap family check before a templated restore."""
    with np.load(Path(path) / _STATE_FILE) as z:
        return {_DICT_KEY.findall(n)[0] for n in z.files
                if n.startswith(".params[")}


def restore_params(path):
    """Restore only ``(params, step)`` from a checkpoint, template-free.

    The param tree is rebuilt from the saved key paths, so this works for
    ANY ArchConfig family member without knowing its shape up front —
    evaluate/export infer the architecture from the checkpoint instead of
    requiring matching --width/--depth flags. (Resuming *training* still
    goes through restore_checkpoint with a template, because the optimizer
    state must be rebuilt as optax namedtuples.)
    """
    with np.load(Path(path) / _STATE_FILE) as z:
        step = int(z[".step"])
    return _params_tree(path), step


def save_model_config(directory, info: dict) -> Path:
    """Persist the model-family metadata (model name + non-inferable
    hyper-parameters, e.g. HashGridConfig's resolutions/aabb) as a
    ``model.json`` sidecar at the checkpoint ROOT. MLP-family checkpoints
    don't need one (ArchConfig is inferred from kernel shapes), hash-grid
    checkpoints do — table shapes alone don't determine the per-level
    resolutions."""
    import json

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "model.json"
    path.write_text(json.dumps(info, indent=1))
    return path


def load_model_config(path) -> Optional[dict]:
    """Read the ``model.json`` sidecar for a checkpoint path (the step dir
    or the root dir); None when absent (pre-sidecar / MLP checkpoints)."""
    import json

    path = Path(path)
    for candidate in (path / "model.json", path.parent / "model.json"):
        if candidate.is_file():
            return json.loads(candidate.read_text())
    return None


def hashgrid_render_config(info: dict, base):
    """RenderConfig for a hash-grid checkpoint from its sidecar ``info``,
    carried over the caller's sampling/chunk knobs in ``base``."""
    from nerf_rs_tpu.config import HashGridConfig

    hash_kw = dict(info.get("hash", {}))
    if "aabb" in hash_kw:
        hash_kw["aabb"] = tuple(hash_kw["aabb"])
    return base.replace(model="hashgrid", hash=HashGridConfig(**hash_kw))


def export_reference_format(directory, params) -> None:
    """Write {coarse,fine}/ weight dirs readable by the reference renderer
    (and by our loader)."""
    directory = Path(directory)
    for net in ("coarse", "fine"):
        save_nerf_params(directory / net, params[net])


def import_reference_format(directory):
    directory = Path(directory)
    return {
        "coarse": load_nerf_params(directory / "coarse"),
        "fine": load_nerf_params(directory / "fine"),
    }
