"""Multi-device bricked fast path: slope rows × plane slabs over the mesh.

The round-2 centerpiece (ops/shearwarp_bricked.py — the fused
post-classification plane sweep over the atlas-assembled density store)
gets the same two decomposition axes as every other renderer in the
framework (SURVEY.md §2.12):

  * **ray axis** — sort-first: each device sweeps a contiguous block of
    slope-grid rows (V).  Zero communication; the per-device kernel is
    identical except for its runtime ``v0`` offset (the Equalizer
    per-channel viewport split, livre/eq/Channel.cpp:444-533 2D path).
  * **brick axis** — sort-last/DB: the GLOBAL plane grid is split into
    contiguous front-to-back plane ranges; each device sweeps its range
    with a fresh (rgb, t) carry and the partial segments fold with the
    over operator in rank order (eq::Compositor::blendFrames +
    orderFrames, Channel.cpp:444-533,535-586).  Because the plane grid
    is global (the step-grid-alignment property,
    fragRaycast.glsl:152-158 generalized), a device's plane range sees
    the exact sample set of the monolithic sweep, so the fold equals the
    single-device image up to fp regrouping — and each device only needs
    the STORE SLICES its planes bracket (:func:`build_sharded_slabs`),
    scaling HBM 1/D on the brick axis.

Early termination stays local to a device's segment, as in the
reference's per-channel DB rendering: samples a monolithic march would
have skipped past the threshold are still composited, but they enter the
final image scaled by the upstream transmittance (< early_exit), so the
deviation is bounded by the threshold (~1e-3 at the default 0.999).
Disable early exit (``early_exit > 1``) for bit-grade parity.

The per-device body runs the SAME plane march as the single-device path
(shearwarp_bricked.default_march): every per-device quantity — plane
tables, view scalars, opacity correction — is computed in-trace from
``jax.lax.axis_index``, so one shard_map compilation serves every
camera.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from libre.ops import shearwarp_bricked as swb
from libre.parallel.compositing import composite_direct_send, fold_over
from libre.parallel.mesh import BRICK_AXIS, RAY_AXIS


def render_store_grid_sharded(
    mesh: Mesh,
    store: jnp.ndarray,  # replicated (Na, Nc, Nb) or slab-sharded
    #                      (d_brick, Na_slab, Nc, Nb) when a_base given
    tf: jnp.ndarray,  # (256, 4)
    fv: jnp.ndarray,  # (11,) view vector (shearwarp_grad.view_vector)
    *,
    na_real: int,
    nc_real: int,
    nb_real: int,
    k_planes: int,
    inter_size: Tuple[int, int],  # global (V, U)
    wb0: float,
    wb1: float,
    wc0: float,
    wc1: float,
    early_exit: float,
    clip: Optional[jnp.ndarray] = None,  # (MAX_CLIP, 4) clip rows
    n_clip: int = 0,
    a_base: Optional[jnp.ndarray] = None,  # (d_brick,) i32 slab offsets
    ray_axis: str = RAY_AXIS,
    brick_axis: str = BRICK_AXIS,
) -> jnp.ndarray:
    """→ (V, U, 4) slope-space image, rows sharded / plane-slabs folded.

    V must divide the ray-axis size and K the brick-axis size.  With
    ``a_base`` (slab mode) ``store`` is (d_brick, Na_slab, Nc, Nb)
    sharded on its leading axis — each device holds only its slab.
    """
    V, U = inter_size
    d_k = mesh.shape[brick_axis]
    d_v = mesh.shape[ray_axis]
    if V % d_v or k_planes % d_k:
        raise ValueError(
            f"V={V} K={k_planes} must divide mesh axes {d_v}x{d_k}"
        )
    V_l, K_l = V // d_v, k_planes // d_k
    slab_mode = a_base is not None
    na_store = int(store.shape[1] if slab_mode else store.shape[0])
    if clip is None:
        clip = jnp.zeros((swb.MAX_CLIP, 4), jnp.float32)
    if not slab_mode:
        a_base = jnp.zeros((d_k,), jnp.int32)
    geom = swb.MarchGeometry(
        nc=nc_real, nb=nb_real, wb0=wb0, wb1=wb1, wc0=wc0, wc1=wc1,
        early_exit=early_exit, n_clip=n_clip,
    )
    march = swb.default_march()

    # Tile-owned compositing (direct send): when each brick-axis device
    # can own V_l/d_k rows, the over-fold runs INSIDE shard_map on one
    # all_to_all (O(R) wire bytes) and the output rows come back
    # sharded (ray major, brick minor) — no D·R gather ever
    # materializes.  Falls back to the gather+fold form when the rows
    # don't divide.
    direct = d_k > 1 and V_l % d_k == 0

    def body(store_l, tf_l, fv_l, clip_l, abase_l):
        kd = jax.lax.axis_index(brick_axis)
        vd = jax.lax.axis_index(ray_axis)
        slab = store_l[0] if slab_mode else store_l
        # Device kd sweeps its contiguous front-to-back range of the
        # GLOBAL plane grid (k0 = kd·K_l) against a store whose slice 0
        # is global slice a_base; device vd's rows start at
        # v0 + vd·V_l·dv (sort-first).
        vs = fv_l[:11].at[8].add(vd.astype(jnp.float32) * (V_l * fv_l[5]))
        vs = jnp.concatenate([
            vs,
            jnp.stack([(kd * K_l).astype(jnp.float32),
                       abase_l[0].astype(jnp.float32)]),
        ])
        planes_i, planes_f, view = swb.plane_operands(
            vs, k_planes=K_l, na_real=na_real, na_store=na_store,
            k_total=k_planes,
        )
        carry = march(
            slab, planes_i, planes_f, view, tf_l, clip_l,
            swb.initial_carry(V_l, U), geom=geom,
        )
        inter = swb.carry_to_rgba(carry)
        if direct:
            rgb_t, a_t = composite_direct_send(
                inter[..., :3], inter[..., 3], brick_axis
            )
            return jnp.concatenate([rgb_t, a_t[..., None]], axis=-1)
        return inter[None]  # (1, V_l, U, 4) plane-range segment

    store_spec = P(brick_axis) if slab_mode else P()
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(store_spec, P(), P(), P(), P(brick_axis)),
        out_specs=P((ray_axis, brick_axis))
        if direct
        else P(brick_axis, ray_axis),
        # pallas_call outputs carry no varying-mesh-axes annotation, so
        # opt out of the check for this body.
        check_vma=False,
    )
    if direct:
        # Rows come back tile-owned: global row vd·V_l + kd·(V_l/d_k).
        return fn(store, tf, fv, clip, a_base)  # (V, U, 4)
    parts = fn(store, tf, fv, clip, a_base)  # (d_k, V, U, 4) in march order
    rgb, a = fold_over(parts[..., :3], parts[..., 3])
    return jnp.concatenate([rgb, a[..., None]], axis=-1)


def slab_ranges(
    fv: np.ndarray, na: int, k_planes: int, d_k: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-device store slice ranges bracketing each plane range.

    Returns (a_lo (d_k,), a_hi_incl (d_k,), slab_na) from the GLOBAL
    plane tables — the host half of the sort-last decomposition.
    """
    a0, a1 = swb.plane_slices(fv, k_planes=k_planes, na=na)
    K_l = k_planes // d_k
    lo = np.empty(d_k, np.int32)
    hi = np.empty(d_k, np.int32)
    for d in range(d_k):
        sl = slice(d * K_l, (d + 1) * K_l)
        lo[d] = min(a0[sl].min(), a1[sl].min())
        hi[d] = max(a0[sl].max(), a1[sl].max())
    slab_na = int((hi - lo).max()) + 1
    return lo, hi, slab_na


def build_sharded_slabs(
    atlas_data: jnp.ndarray,
    plan: "swb.AssemblyPlan",
    fv: np.ndarray,
    k_planes: int,
    d_k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Assemble each brick-axis device's store slab out of the atlas.

    Returns (slabs (d_k, slab_na, Nc, Nb), a_base (d_k,) i32) for
    :func:`render_store_grid_sharded`'s slab mode — device d holds only
    the slices its plane range brackets (~1/d_k of the store), the HBM
    scaling half of the sort-last decomposition (the reference's
    per-channel Range slicing the visible set,
    SelectVisibles.cpp:120-142).
    """
    na = plan.fine_dims[0]
    lo, hi, slab_na = slab_ranges(fv, na, k_planes, d_k)
    slabs = [
        swb.assemble_store(
            atlas_data, plan, int(lo[d]), int(hi[d]), out_slices=slab_na
        )
        for d in range(d_k)
    ]
    return jnp.stack(slabs), jnp.asarray(lo, jnp.int32)
