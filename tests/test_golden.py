"""Golden-value regression against the original TF NeRF.

The analogue of the reference's single unit test
(coarse_and_fine_match_reference_examples, /root/reference/src/lib.rs:753-916):
evaluate both pretrained networks at origin + ray_d * t for t in z_vals and
assert sigma and RGB within 1e-2 of the TF goldens. Data comes from the JSON
fixture instead of hardcoded literals.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.io.golden import golden_examples
from nerf_rs_tpu.io.weights import validate_param_shapes
from nerf_rs_tpu.models.mlp import count_params, nerf_mlp

TOL = 1e-2  # reference tolerance (lib.rs:735)


def test_param_shapes(lego_params):
    validate_param_shapes(lego_params["coarse"])
    validate_param_shapes(lego_params["fine"])
    # 595,844 params each: 8 dense + bottleneck + viewdirs + rgb + alpha.
    assert count_params(lego_params["coarse"]) == count_params(lego_params["fine"])


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_golden_examples(lego_params, golden, network):
    params = lego_params[network]
    for ex in golden_examples(golden):
        # Points use the UNNORMALIZED ray_d; view dirs use viewdir_unit
        # (TF convention, reference test lib.rs:853-860).
        pts = ex["ray_o"][None, :] + ex["ray_d"][None, :] * ex["z_vals"][:, None]
        dirs = np.broadcast_to(ex["viewdir_unit"], pts.shape)
        rgb, sigma = nerf_mlp(params, jnp.asarray(pts), jnp.asarray(dirs))
        np.testing.assert_allclose(sigma, ex[f"{network}_sigma"], atol=TOL, rtol=0)
        np.testing.assert_allclose(rgb, ex[f"{network}_rgb"], atol=TOL, rtol=0)


def test_batched_matches_single(lego_params, golden):
    """Arbitrary batch shapes give identical results (pure function of inputs)."""
    params = lego_params["coarse"]
    exs = list(golden_examples(golden))
    pts = np.stack([e["ray_o"] + e["ray_d"] * 3.0 for e in exs])
    dirs = np.stack([e["viewdir_unit"] for e in exs])
    rgb_b, sigma_b = nerf_mlp(params, jnp.asarray(pts), jnp.asarray(dirs))
    for i, e in enumerate(exs):
        rgb_1, sigma_1 = nerf_mlp(params, jnp.asarray(pts[i]), jnp.asarray(dirs[i]))
        np.testing.assert_allclose(rgb_b[i], rgb_1, atol=1e-6)
        np.testing.assert_allclose(sigma_b[i], sigma_1, atol=1e-5)
