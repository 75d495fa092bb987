"""ArchConfig model family: smaller distillation students alongside the
canonical lego architecture (the reference has exactly one arch,
network.rs:172-237; the family is the framework's FLOP-reduction lever:
MLP FLOPs fall quadratically with width)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import ArchConfig, TrainConfig
from nerf_rs_tpu.io.weights import (
    CANONICAL_SHAPES,
    load_nerf_params,
    load_bundle,
    param_layer_names,
    save_bundle,
    save_nerf_params,
    validate_param_chain,
)
from nerf_rs_tpu.models.mlp import arch_shapes, init_nerf_params, nerf_mlp

STUDENT = ArchConfig(width=128, v_width=64)
DEEP_STUDENT = ArchConfig(width=64, v_width=32, depth=6, skip_at=2)


def test_canonical_arch_shapes_match_reference():
    assert arch_shapes() == CANONICAL_SHAPES
    assert ArchConfig().is_canonical
    assert not STUDENT.is_canonical


@pytest.mark.parametrize("arch", [STUDENT, DEEP_STUDENT])
def test_student_forward_and_grads(arch):
    params = init_nerf_params(jax.random.key(0), arch=arch)
    pts = jnp.linspace(-1.0, 1.0, 21).reshape(7, 3)
    dirs = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (7, 1))
    rgb, sigma = nerf_mlp(params, pts, dirs)
    assert rgb.shape == (7, 3) and sigma.shape == (7,)
    assert bool(jnp.isfinite(rgb).all()) and bool(jnp.isfinite(sigma).all())

    def loss(p):
        r, s = nerf_mlp(p, pts, dirs)
        return jnp.sum(r ** 2) + jnp.sum(s ** 2)

    grads = jax.grad(loss)(params)
    total = sum(float(jnp.abs(g).sum()) for g in jax.tree_util.tree_leaves(grads))
    assert np.isfinite(total) and total > 0


@pytest.mark.parametrize("arch", [STUDENT, DEEP_STUDENT])
def test_student_reference_format_roundtrip(tmp_path, arch):
    """Non-canonical members round-trip the reference shapes.txt + .bin
    format (dims recorded per tensor, loader derives the layer list)."""
    params = init_nerf_params(jax.random.key(1), arch=arch)
    save_nerf_params(tmp_path / "net", params)
    loaded = load_nerf_params(tmp_path / "net", device_put=False)
    validate_param_chain(loaded)
    assert param_layer_names(loaded) == param_layer_names(params)
    for layer in params:
        np.testing.assert_array_equal(np.asarray(params[layer]["kernel"]),
                                      loaded[layer]["kernel"])


def test_student_bundle_roundtrip(tmp_path):
    coarse = init_nerf_params(jax.random.key(0), arch=STUDENT)
    fine = init_nerf_params(jax.random.key(1), arch=STUDENT)
    path = tmp_path / "student.npz"
    save_bundle(path, coarse, fine, json.dumps({"near": 2.0}))
    params, golden = load_bundle(path, device_put=False)
    assert golden == {"near": 2.0}
    assert params["fine"]["dense0"]["kernel"].shape == (63, 128)


def test_validate_param_chain_rejects_inconsistency():
    params = init_nerf_params(jax.random.key(0), arch=STUDENT)
    validate_param_chain(params)  # sane tree passes
    bad = dict(params)
    bad["dense2"] = {"kernel": np.zeros((99, 128), np.float32),
                     "bias": np.zeros((128,), np.float32)}
    with pytest.raises(ValueError):
        validate_param_chain(bad)


def test_student_train_step_runs():
    from nerf_rs_tpu.parallel.train_sharded import (
        create_sharded_train_state,
        sharded_train_step,
    )
    from nerf_rs_tpu.config import RenderConfig

    cfg = TrainConfig(
        arch=STUDENT, batch_rays=64,
        render=RenderConfig(n_coarse=8, n_fine=16, ray_chunk=64, impl="xla"),
    )
    mesh, state = create_sharded_train_state(jax.random.key(0), cfg)
    batch = {
        "origins": jnp.zeros((64, 3)) + jnp.asarray([0.0, 0.0, 4.0]),
        "dirs": jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (64, 1)),
        "rgb": jnp.full((64, 3), 0.5),
        "near": jnp.float32(2.0),
        "far": jnp.float32(6.0),
    }
    state, metrics = sharded_train_step(mesh, state, batch,
                                        jax.random.key(1), cfg)
    assert np.isfinite(float(metrics["loss"]))
    assert state.params["coarse"]["dense0"]["kernel"].shape == (63, 128)


def test_train_resume_arch_mismatch_errors(tmp_path):
    """Resuming a checkpoint with different --width/--depth flags must fail
    loudly, naming both architectures, before any array is restored."""
    from nerf_rs_tpu.cli import main

    ck = str(tmp_path / "ck")
    args = ["--steps", "1", "--batch-rays", "64",
            "--coarse-samples", "4", "--fine-samples", "8",
            "--ray-chunk", "64", "--impl", "xla",
            "--checkpoint-dir", ck, "--checkpoint-every", "100",
            "--log-every", "1"]
    assert main(["train", "--width", "64", "--v-width", "32",
                 "--depth", "4", "--skip-at", "2", *args]) == 0
    with pytest.raises(SystemExit, match="different architecture"):
        main(["train", "--width", "32", "--v-width", "16",
              "--depth", "4", "--skip-at", "2", *args])
    # Matching flags still resume cleanly.
    assert main(["train", "--width", "64", "--v-width", "32",
                 "--depth", "4", "--skip-at", "2",
                 *args[:1], "2", *args[2:]]) == 0


def test_restore_params_template_free(tmp_path):
    """evaluate/export infer the architecture from the checkpoint itself
    (restore_params needs no shape-matching template)."""
    from nerf_rs_tpu.io.checkpoint import restore_params, save_checkpoint
    from nerf_rs_tpu.train import create_train_state

    cfg = TrainConfig(arch=STUDENT)
    state = create_train_state(jax.random.key(0), cfg)
    path = save_checkpoint(tmp_path / "ckpts", state)
    params, step = restore_params(path)
    assert step == 0
    assert params["fine"]["viewdirs"]["kernel"].shape == (128 + 27, 64)
    np.testing.assert_array_equal(
        np.asarray(state.params["coarse"]["rgb"]["bias"]),
        params["coarse"]["rgb"]["bias"])


def test_load_nerf_params_rejects_malformed_directory(tmp_path):
    """A weight directory missing a head must fail AT LOAD, not as an
    opaque KeyError inside jit tracing later."""
    from nerf_rs_tpu.io.weights import load_nerf_params, save_nerf_params

    params = init_nerf_params(jax.random.key(0), arch=STUDENT)
    save_nerf_params(tmp_path / "net", params)
    # strip the alpha head from shapes.txt and its tensors
    st = (tmp_path / "net" / "shapes.txt").read_text().splitlines()
    (tmp_path / "net" / "shapes.txt").write_text(
        "\n".join(l for l in st if not l.startswith("alpha")) + "\n")
    with pytest.raises(ValueError, match="alpha"):
        load_nerf_params(tmp_path / "net", device_put=False)
