"""Checkpoint/resume (SURVEY.md §5: the reference has no saving; training
here must round-trip params + optimizer state + step through the in-repo
.npz format and export back to the reference's .bin format)."""

import jax
import numpy as np

from nerf_rs_tpu.config import RenderConfig, TrainConfig
from nerf_rs_tpu.io.checkpoint import (
    export_reference_format,
    import_reference_format,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from nerf_rs_tpu.train import create_train_state

CFG = TrainConfig(batch_rays=32, render=RenderConfig(n_coarse=4, n_fine=8, ray_chunk=32))


def _tree_equal(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_roundtrip(tmp_path):
    state = create_train_state(jax.random.key(0), CFG)
    state = state._replace(step=state.step + 7)
    path = save_checkpoint(tmp_path / "ckpts", state)
    assert latest_checkpoint(tmp_path / "ckpts") == path

    template = create_train_state(jax.random.key(1), CFG)
    restored = restore_checkpoint(path, template)
    assert int(restored.step) == 7
    _tree_equal(restored.params, state.params)
    _tree_equal(restored.opt_state, state.opt_state)


def test_checkpoint_prune_keeps_latest(tmp_path):
    state = create_train_state(jax.random.key(0), CFG)
    for step in (1, 2, 3, 4, 5):
        state = state._replace(step=jax.numpy.asarray(step))
        save_checkpoint(tmp_path / "c", state, keep=2)
    steps = sorted(p.name for p in (tmp_path / "c").glob("step_*"))
    assert steps == ["step_00000004", "step_00000005"]


def test_reference_format_export_import(tmp_path):
    """Params exported to shapes.txt + .bin re-import bit-identically — a
    reference-renderer user can consume trained checkpoints."""
    state = create_train_state(jax.random.key(2), CFG)
    export_reference_format(tmp_path / "weights", state.params)
    assert (tmp_path / "weights" / "coarse" / "shapes.txt").exists()
    back = import_reference_format(tmp_path / "weights")
    _tree_equal(back, state.params)


def test_checkpoint_roundtrip_hashgrid_family(tmp_path):
    """The hash-grid family (one 'shared' network, 3-D tables) round-trips
    the .npz state, templated and template-free."""
    import sys

    from nerf_rs_tpu.config import HashGridConfig
    from nerf_rs_tpu.io.checkpoint import checkpoint_param_keys, restore_params

    hcfg = TrainConfig(batch_rays=32, render=RenderConfig(
        n_coarse=4, n_fine=8, ray_chunk=32, model="hashgrid",
        hash=HashGridConfig(levels=2, table_log2=8, res_max=16)))
    state = create_train_state(jax.random.key(0), hcfg)
    state = state._replace(step=state.step + 3)
    path = save_checkpoint(tmp_path / "h", state)
    assert checkpoint_param_keys(path) == {"shared"}
    restored = restore_checkpoint(path, create_train_state(jax.random.key(1), hcfg))
    assert int(restored.step) == 3
    _tree_equal(restored.params, state.params)
    _tree_equal(restored.opt_state, state.opt_state)
    params, step = restore_params(path)
    assert step == 3 and params["shared"]["hash_tables"].shape == (2, 256, 2)
    _tree_equal(params, state.params)
    assert "orbax" not in " ".join(sys.modules)


def test_checkpoint_restore_rejects_mismatched_template(tmp_path):
    """A template whose leaves differ in shape from the saved state fails
    with the leaf's path, not an opaque error."""
    import pytest

    from nerf_rs_tpu.config import ArchConfig

    state = create_train_state(jax.random.key(0), CFG)
    path = save_checkpoint(tmp_path / "c", state)
    other = create_train_state(
        jax.random.key(0), CFG.replace(arch=ArchConfig(width=64, v_width=32)))
    with pytest.raises(ValueError, match=r"leaf .*kernel.* has shape"):
        restore_checkpoint(path, other)


def test_checkpoint_ignores_unfinished_step_dirs(tmp_path):
    """A step directory without its state file (a save that died before
    the rename) is never the latest checkpoint."""
    state = create_train_state(jax.random.key(0), CFG)
    path = save_checkpoint(tmp_path / "c", state)
    (tmp_path / "c" / "step_00000009").mkdir()
    (tmp_path / "c" / ".step_00000010.tmp").mkdir()
    assert latest_checkpoint(tmp_path / "c") == path
