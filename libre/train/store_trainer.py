"""Inverse rendering through the fused differentiable store core.

BASELINE config 5 ("optimize voxel densities + transfer function from
target images at pod scale") on the framework's FAST path: the forward
is the bricked post-classification plane march and the backward the
batched-recompute sweeps of ops/shearwarp_grad.render_store_grid_diff —
not the exact marcher (train/trainer.py, which remains the
oracle-faithful brick-sharded variant) nor the dense jnp pipeline
(train/shearwarp_trainer.py, now the reference implementation of this
module).

Sharding over the (brick × ray) mesh:

  * **views** shard over the brick axis — independent render+backward
    per view (the reference's one-Channel-per-view decomposition,
    livre/eq/Channel.cpp:259-308);
  * **slope-grid rows** shard over the ray axis — sort-first inside
    each view, expressed as a runtime ``v0`` offset per device.

The density store and transfer function are replicated; shard_map's
transpose psums their cotangents across the mesh — the gradient
all-reduce of a data-parallel training step.

Training constraints (same rules as InverseRenderProblem): early exit
is DISABLED under grad (a step function of the parameters), and all
views must share one major axis because the store is assembled in one
axis permutation.  Uncovered (SENTINEL) voxels receive zero gradient
through the coverage mask and are pinned by the update mask.

Beyond the replicated-store data parallelism above, r4 adds MODEL
parallelism: :func:`make_slab_loss_fn` shards the store itself 1/D per
device on the brick axis (uniform slice slabs + ppermute halo
exchange, fresh-carry plane-range segments through the same custom-VJP
renderer, over-fold outside shard_map) with gradients equal to the
replicated trainer — the decomposition that takes config 5 to ≥1024³
(see benchmarks/demo_slab_train.py for the per-device HBM model).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from libre.ops import shearwarp_grad as swg
from libre.ops.shearwarp_bricked import SENTINEL
from libre.parallel.mesh import BRICK_AXIS, RAY_AXIS


@dataclasses.dataclass(frozen=True)
class StoreProblem:
    """Static inverse-rendering problem over one store geometry.

    ``views`` is the (Nv, 11) matrix of view vectors
    (shearwarp_grad.view_vector — all on the same major axis); the
    static geometry is shared.  ``inter_size`` is the GLOBAL (V, U)
    slope grid per view.
    """

    views: np.ndarray  # (Nv, 11)
    na_store: int
    na_real: int
    nc_real: int
    nb_real: int
    k_planes: int
    inter_size: Tuple[int, int]
    world_min: np.ndarray
    world_max: np.ndarray
    axis: int
    diff_tf: bool = True
    kc: int = 32

    def static_for(self, v_size: int) -> swg._StaticView:
        return swg.static_view(
            na_store=self.na_store,
            na_real=self.na_real,
            nc_real=self.nc_real,
            nb_real=self.nb_real,
            k_planes=self.k_planes,
            v_size=v_size,
            u_size=self.inter_size[1],
            world_min=self.world_min,
            world_max=self.world_max,
            axis=self.axis,
            early_exit=1.1,  # disabled under grad
            kc=self.kc,
            diff_tf=self.diff_tf,
        )


def render_views(problem: StoreProblem, store, tf) -> jnp.ndarray:
    """Single-device render of every view → (Nv, V, U, 4) (target
    generation / parity oracle for the sharded step)."""
    static = problem.static_for(problem.inter_size[0])
    outs = [
        swg.render_store_grid_diff(store, tf, jnp.asarray(vs), static)
        for vs in problem.views
    ]
    return jnp.stack(outs)


def make_loss_fn(problem: StoreProblem, mesh: Optional[Mesh]):
    """(store, tf, targets (Nv, V, U, 4)) → mean-squared error, with the
    per-view forward+backward sharded views×rows over the mesh."""
    V, U = problem.inter_size
    n_views = len(problem.views)
    views_arr = jnp.asarray(problem.views, jnp.float32)

    if mesh is None:
        static = problem.static_for(V)

        def loss_fn(store, tf, targets):
            se = 0.0
            for i in range(n_views):
                img = swg.render_store_grid_diff(
                    store, tf, views_arr[i], static
                )
                se = se + jnp.sum((img - targets[i]) ** 2)
            return se / (n_views * V * U * 4)

        return loss_fn

    d_k = mesh.shape[BRICK_AXIS]
    d_v = mesh.shape[RAY_AXIS]
    if n_views % d_k or V % d_v:
        raise ValueError(
            f"views={n_views} V={V} must divide mesh axes {d_k}x{d_v}"
        )
    nv_l, v_l = n_views // d_k, V // d_v
    static_l = problem.static_for(v_l)
    denom = float(n_views * V * U * 4)

    def body(store, tf, views_l, targets_l):
        vd = jax.lax.axis_index(RAY_AXIS)
        se = 0.0
        for i in range(nv_l):
            vs = views_l[i]
            # Sort-first row offset: rows [vd·V_l, (vd+1)·V_l) of the
            # global grid start at v0 + vd·V_l·dv (dv = vs[5]).
            vs = vs.at[8].add(vd.astype(jnp.float32) * (v_l * vs[5]))
            img = swg.render_store_grid_diff(store, tf, vs, static_l)
            se = se + jnp.sum((img - targets_l[i]) ** 2)
        return jax.lax.psum(se, (BRICK_AXIS, RAY_AXIS)) / denom

    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(BRICK_AXIS), P(BRICK_AXIS, RAY_AXIS)),
        out_specs=P(),
        # The body may run a pallas_call, whose outputs carry no
        # varying-mesh-axes annotation (see parallel/bricked_sharded.py).
        check_vma=False,
    )

    def loss_fn(store, tf, targets):
        return sharded(store, tf, views_arr, targets)

    return loss_fn


def shard_store_slabs_uniform(store: jnp.ndarray, d_k: int) -> jnp.ndarray:
    """(Na, Nc, Nb) store → (d_k, Na/d_k, Nc, Nb) uniform slice
    shards (leading axis goes on the mesh brick axis; each device holds
    1/d_k of the store — the HBM-scaling half of config 5)."""
    na = store.shape[0]
    if na % d_k:
        raise ValueError(f"na={na} must divide the brick axis {d_k}")
    return store.reshape(d_k, na // d_k, *store.shape[1:])


def make_slab_loss_fn(problem: StoreProblem, mesh: Mesh):
    """Loss over a SLAB-SHARDED store: model parallelism for config 5.

    The store arrives as (d_k, Na/d_k, Nc, Nb) with its leading axis on
    the mesh brick axis — every device holds 1/d_k of the densities (the
    reference's DB range decomposition, NodeId.cpp:128-137 ranges +
    Channel.cpp:444-533 compositing, applied to TRAINING).  Per step and
    view each device:

    1. exchanges ONE boundary slice with each neighbor (``ppermute``
       halos — shear-warp planes interpolate between adjacent slices, so
       a plane range needs at most one slice beyond its own shard; the
       halo exchange transposes to a reverse-permute gradient exchange
       under AD automatically);
    2. sweeps its GLOBAL plane range against the extended slab with a
       fresh carry through the fused custom-VJP renderer (13-float view
       vector carrying [k0, a_base]);
    3. segments fold with the over operator in plane order OUTSIDE
       shard_map (plain differentiable jnp; GSPMD inserts the gather).

    With early exit disabled under grad, the fold is bit-identical to
    the monolithic sweep, so losses AND gradients match the replicated
    trainer while the store (and its Adam moments) scale 1/d_k per
    device.  All views must share one major axis AND one march sign.
    """
    from libre.parallel.compositing import fold_over

    V, U = problem.inter_size
    n_views = len(problem.views)
    views_arr = jnp.asarray(problem.views, jnp.float32)
    d_k = mesh.shape[BRICK_AXIS]
    d_v = mesh.shape[RAY_AXIS]
    na = problem.na_real
    if problem.na_store != problem.na_real:
        raise ValueError("slab mode requires an unpadded store "
                         f"(na_store={problem.na_store} != na={na})")
    if n_views and len({float(v[9]) for v in problem.views}) != 1:
        raise ValueError("slab mode: all views must share one march sign")
    sign = float(problem.views[0][9]) if n_views else 1.0
    if na % d_k or problem.k_planes % d_k or V % d_v:
        raise ValueError(
            f"na={na} K={problem.k_planes} V={V} must divide mesh "
            f"axes {d_k}x{d_v}"
        )
    if problem.k_planes < na:
        # One halo slice suffices only when planes are at least as
        # dense as slices; sparser planes can need slice (kd+1)·na_l+1,
        # which the a1 clamp would silently redirect (advisor r4).
        raise ValueError(
            f"slab mode requires k_planes >= na ({problem.k_planes} < {na})"
        )
    na_l = na // d_k
    k_l = problem.k_planes // d_k
    v_l = V // d_v
    static_l = swg.static_view(
        na_store=na_l + 2,
        na_real=na,
        nc_real=problem.nc_real,
        nb_real=problem.nb_real,
        k_planes=k_l,
        v_size=v_l,
        u_size=U,
        world_min=problem.world_min,
        world_max=problem.world_max,
        axis=problem.axis,
        early_exit=1.1,  # disabled under grad
        kc=problem.kc,
        diff_tf=problem.diff_tf,
        k_total=problem.k_planes,
    )
    fwd_perm = [(i, (i + 1) % d_k) for i in range(d_k)]
    bwd_perm = [(i, (i - 1) % d_k) for i in range(d_k)]

    def seg_body(slab_l, tf_l, vs_l):
        kd = jax.lax.axis_index(BRICK_AXIS)
        vd = jax.lax.axis_index(RAY_AXIS)
        own = slab_l[0]  # (na_l, Nc, Nb)
        halo_prev = jax.lax.ppermute(
            own[-1:], BRICK_AXIS, fwd_perm
        )  # previous device's last slice (cyclic wrap never indexed)
        halo_next = jax.lax.ppermute(own[:1], BRICK_AXIS, bwd_perm)
        ext = jnp.concatenate([halo_prev, own, halo_next], axis=0)
        vs = vs_l.at[8].add(vd.astype(jnp.float32) * (v_l * vs_l[5]))
        if sign > 0:
            k0 = kd * k_l
        else:
            k0 = (d_k - 1 - kd) * k_l
        abase = kd * na_l - 1
        vs13 = jnp.concatenate(
            [
                vs,
                jnp.stack(
                    [k0.astype(jnp.float32), abase.astype(jnp.float32)]
                ),
            ]
        )
        seg = swg.render_store_grid_diff(ext, tf_l, vs13, static_l)
        return seg[None]  # (1, v_l, U, 4)

    fn = shard_map(
        seg_body,
        mesh=mesh,
        in_specs=(P(BRICK_AXIS), P(), P()),
        out_specs=P(BRICK_AXIS, RAY_AXIS),
        check_vma=False,
    )
    denom = float(n_views * V * U * 4)

    def loss_fn(store_sh, tf, targets):
        se = 0.0
        for i in range(n_views):
            parts = fn(store_sh, tf, views_arr[i])  # (d_k, V, U, 4)
            if sign < 0:
                parts = parts[::-1]  # fold in front-to-back plane order
            rgb, a = fold_over(parts[..., :3], parts[..., 3])
            img = jnp.concatenate([rgb, a[..., None]], axis=-1)
            se = se + jnp.sum((img - targets[i]) ** 2)
        return se / denom

    return loss_fn


def make_train_step(
    problem: StoreProblem,
    optimizer: optax.GradientTransformation,
    mesh: Optional[Mesh] = None,
):
    """jitted (params, opt_state, targets) → (params, opt_state, loss).

    params = {"store": (Na, Nc, Nb), "tf": (256, 4)}; gradients flow
    through the fused forward + batched-recompute backward, psum-reduced
    across the mesh by shard_map's transpose.  The update clamps
    densities/TF to [0, 1] and pins uncovered voxels at SENTINEL.
    """
    loss_fn = make_loss_fn(problem, mesh)

    @jax.jit
    def step(params, opt_state, targets):
        def f(p):
            return loss_fn(p["store"], p["tf"], targets)

        loss, grads = jax.value_and_grad(f)(params)
        if not problem.diff_tf:
            grads = dict(grads, tf=jnp.zeros_like(grads["tf"]))
        # Coverage is a property of the INITIAL store (SENTINEL marks
        # voxels no resident brick covers) — derive it from the
        # pre-update values so a large update that pushes a covered
        # voxel below the sentinel threshold cannot permanently convert
        # it to uncovered (advisor r3).
        covered = params["store"] > -0.5
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        params = {
            "store": jnp.where(
                covered, jnp.clip(params["store"], 0.0, 1.0), SENTINEL
            ),
            "tf": jnp.clip(params["tf"], 0.0, 1.0),
        }
        return params, opt_state, loss

    return step


def fit(
    problem: StoreProblem,
    targets: jnp.ndarray,  # (Nv, V, U, 4)
    init_store: jnp.ndarray,
    init_tf: jnp.ndarray,
    *,
    mesh: Optional[Mesh] = None,
    optimizer: Optional[optax.GradientTransformation] = None,
    steps: int = 100,
) -> Tuple[dict, List[float]]:
    """Run the optimization; returns (params, losses)."""
    optimizer = optimizer or optax.adam(3e-2)
    params = {"store": jnp.asarray(init_store), "tf": jnp.asarray(init_tf)}
    opt_state = optimizer.init(params)
    step = make_train_step(problem, optimizer, mesh)
    targets = jnp.asarray(targets)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, targets)
        losses.append(float(loss))
    return params, losses
