"""Differentiable NeRF training — the capability the reference lacks
(SURVEY.md: "no training, no autodiff") but the north star demands.

Original-NeRF recipe: joint photometric MSE on the coarse and fine renders,
Adam with exponential lr decay 5e-4 -> 5e-6. Coarse and fine networks are
independent parameter sets trained together, exactly like bmild/nerf.

Distribution: batches of rays are sharded over the mesh's "rays" axis and
parameters are replicated, so XLA inserts a single psum all-reduce for the
gradients — the replacement for the reference's rayon layer.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from nerf_rs_tpu.config import TrainConfig
from nerf_rs_tpu.models.mlp import init_nerf_params
from nerf_rs_tpu.render import render_rays


class TrainState(NamedTuple):
    params: Dict[str, Any]   # {"coarse": pytree, "fine": pytree}
    opt_state: Any
    step: jnp.ndarray


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    schedule = optax.exponential_decay(
        init_value=cfg.lr_init,
        transition_steps=cfg.lr_decay_steps,
        decay_rate=cfg.lr_final / cfg.lr_init,
    )
    return optax.adam(schedule, eps=cfg.adam_eps)


def create_train_state(key: jax.Array, cfg: TrainConfig) -> TrainState:
    if cfg.render.model == "hashgrid":
        # The hash family trains ONE shared network queried by both the
        # coarse and fine passes (the Instant-NGP convention) — gradients
        # from both passes accumulate into the same tables.
        from nerf_rs_tpu.models.hashgrid import init_hashgrid_params

        params = {"shared": init_hashgrid_params(key, cfg.render.hash)}
    else:
        kc, kf = jax.random.split(key)
        params = {"coarse": init_nerf_params(kc, arch=cfg.arch),
                  "fine": init_nerf_params(kf, arch=cfg.arch)}
    opt_state = make_optimizer(cfg).init(params)
    return TrainState(params=params, opt_state=opt_state, step=jnp.zeros((), jnp.int32))


def split_params(params: Dict[str, Any]) -> Tuple[Any, Any]:
    """(coarse, fine) views of a train-state param dict — either separate
    subtrees or one 'shared' network serving both passes."""
    if "shared" in params:
        return params["shared"], params["shared"]
    return params["coarse"], params["fine"]


def nerf_loss(
    params: Dict[str, Any],
    batch: Dict[str, jnp.ndarray],
    key: jax.Array,
    cfg: TrainConfig,
    grid=None,
    ray_ids=None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Joint coarse+fine photometric MSE over a ray batch.

    batch: origins (B, 3) or a single (3,) origin, dirs (B, 3) unit,
    rgb (B, 3) targets, near/far scalars. ``grid`` (accel.OccupancyGrid)
    enables occupancy-culled MLP evaluation inside the differentiable
    render — culled samples scatter back with zero weight and zero
    gradient (NerfAcc-style accelerated training; refresh the grid from
    the student periodically, see cli train --accel-every).

    Per-ray RNG streams derive from ``ray_ids`` (default: the batch
    position), so a batch sharded over devices draws the same jitter as
    the same batch on one device (parallel/train_sharded.py passes the
    global ids per shard).
    """
    rcfg = cfg.render
    if ray_ids is None:
        ray_ids = jnp.arange(batch["dirs"].shape[0], dtype=jnp.int32)
    p_coarse, p_fine = split_params(params)
    rgb_fine, aux = render_rays(
        p_coarse, p_fine,
        batch["origins"], batch["dirs"], batch["near"], batch["far"],
        key, rcfg, return_aux=True, grid=grid, ray_ids=ray_ids,
    )
    mse_fine = jnp.mean((rgb_fine - batch["rgb"]) ** 2)
    mse_coarse = jnp.mean((aux["rgb_coarse"] - batch["rgb"]) ** 2)
    # Single-pass mode (n_fine == 0): the "coarse" image IS the render —
    # adding it again would only double the loss scale.
    coarse_w = cfg.coarse_loss_weight if rcfg.n_fine > 0 else 0.0
    loss = mse_fine + coarse_w * mse_coarse
    psnr = -10.0 * jnp.log10(jnp.maximum(mse_fine, 1e-10))
    metrics = {"loss": loss, "mse_fine": mse_fine,
               "mse_coarse": mse_coarse, "psnr": psnr}
    if "live_frac_coarse" in aux:
        # Compaction health (accel training): > 1.0 = capacity overflow,
        # gradients silently dropped for the overflowed samples.
        metrics["live_frac_coarse"] = aux["live_frac_coarse"]
        metrics["live_frac_fine"] = aux["live_frac_fine"]
        # Overflow INDICATOR (1.0 iff either pass overflowed here). Under
        # data-parallel pmean the live_frac means can dilute one shard's
        # overflow below 1.0; the mean of this indicator is nonzero iff
        # ANY device overflowed, so detection survives the single fused
        # all-reduce (parallel.train_sharded).
        metrics["accel_overflow"] = (
            jnp.maximum(aux["live_frac_coarse"], aux["live_frac_fine"]) > 1.0
        ).astype(jnp.float32)
    return loss, metrics


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def train_step(
    state: TrainState,
    batch: Dict[str, jnp.ndarray],
    key: jax.Array,
    cfg: TrainConfig,
    grid=None,
) -> Tuple[TrainState, Dict[str, jnp.ndarray]]:
    """One optimizer step. With ray-sharded batches and replicated params,
    the gradient psum over chips is inserted by XLA (overlap handled by its
    latency-hiding scheduler). ``grid`` enables occupancy-culled training
    (see nerf_loss)."""
    grad_fn = jax.value_and_grad(nerf_loss, has_aux=True)
    (_, metrics), grads = grad_fn(state.params, batch, key, cfg, grid)
    updates, opt_state = make_optimizer(cfg).update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), metrics
