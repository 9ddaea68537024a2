"""Brick-atlas-native shear-warp: the out-of-core fast path.

It renders the mixed-LOD **rendering set** streamed through the device
brick atlas — the equivalent of the reference's per-brick GPU raycast
over a texture atlas (renderers/cudaRaycaster/cuda/Renderer.cu:95-230 +
TexturePool.cu:101-214, renderers/glRaycaster/GLRaycastRenderer.cpp:
431-464).

Pipeline per frame (all on device):

1. **Assembly** (:func:`assemble_store`): gather the slab's resident
   bricks of each LOD level out of the atlas (one ``jnp.take`` over
   slots per level), strip ghost voxels, tile them into the
   axis-permuted render-level grid; coarser levels are upsampled to the
   render grid with two-tap interpolation expressed as matmuls,
   blended seam-free by normalized convolution (value & coverage
   upsampled together), and composed under the per-level ownership
   masks of the rendering set (the RenderingSetGenerator
   ancestor-fallback result, RenderingSetGeneratorFilter.ipp:27-134).
   Output: a normalized DENSITY store (Na, Nc, Nb) — 1 channel;
   native-dtype bricks are dequantized on the fly (the dtype switch of
   livre/core/render/TexturePool.cpp:42-84).  Uncovered voxels carry a
   large negative sentinel.
2. **Plane march** (:func:`march_kernel` on the GPU, :func:`march_xla`
   elsewhere): front-to-back over the virtual axis planes.  Per plane
   each slope-grid ray gathers the 8 trilinear taps of its ray∩plane
   point from the two bracketing density slices, then **classifies the
   interpolated density** — the reference's classify-after-interpolation
   semantics (fragRaycast.glsl:188-205) — through the 256-entry transfer
   function, and composites.  The transfer function is a runtime
   operand: TF edits re-render without touching the volume, matching the
   reference's re-upload-256×4-texture flow (GLRaycastRenderer.cpp:
   175-193).  Clip planes are evaluated per sample as half-space masks —
   for a convex clip set this equals the ray-interval clamp of
   fragRaycast.glsl:162-174.
3. **Multipass**: the carry (rgb, transmittance) enters and leaves the
   march, so memory-bounded A-slab passes compose exactly like one
   monolithic sweep (GLRaycastPipeline.cpp:148-186; the plane grid is
   global, so the step-grid-alignment property of
   fragRaycast.glsl:152-158 holds across slab boundaries by
   construction — see test_bricked seam tests).

Parity oracle: ops/shearwarp.plane_oracle(classification="post") over
the inverse-permuted assembled store — same sample set, same opacity
correction, same early exit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from libre import backend
from libre.ops.reference import ALPHA_CLAMP, RenderParams
from libre.ops import shearwarp as sw

SENTINEL = -1024.0  # uncovered-voxel marker (normalized density is [0,1])
TF_SIZE = 256
MAX_CLIP = 8  # clip-plane rows carried by the march
# Slope-grid tile of one kernel program (V rows × U columns).  Triton
# blocks are powers of two; the viewport is padded up to whole tiles.
TILE = (16, 64)
VIEW_LEN = 16  # march view vector, see plane_operands


# ===================================================================== march
@dataclasses.dataclass(frozen=True)
class MarchGeometry:
    """Compile-time constants of one plane march over a (Na, nc, nb)
    density store: in-plane extents, world b/c bounds of the volume box,
    the early-exit threshold and the number of clip planes."""

    nc: int
    nb: int
    wb0: float
    wb1: float
    wc0: float
    wc1: float
    early_exit: float
    n_clip: int


def _taps(x, lo, hi, n):
    """Two-tap clamp-to-edge lerp of world coordinate ``x`` over ``n``
    voxels spanning [lo, hi): (i0, i1, w, inside) — the scalar form of
    shearwarp._lerp_matrix (half-voxel centers)."""
    inside = (x >= lo) & (x < hi)
    s = jnp.clip((x - lo) * (n / (hi - lo)) - 0.5, -0.5, n - 0.5)
    i0f = jnp.floor(jnp.clip(s, 0.0, float(n - 1)))
    w = jnp.clip(s - i0f, 0.0, 1.0)
    i0 = i0f.astype(jnp.int32)
    return i0, jnp.minimum(i0 + 1, n - 1), w, inside


def _ray_setup(ug, vg, view, geom: MarchGeometry):
    """Per-ray opacity-correction exponent and hit flag.

    ``corr`` is the Euclidean step dz·√(1+u²+v²) relative to the
    reference step (fragRaycast.glsl:104-111).  ``hit`` is 0 only when
    the slope ray provably never enters the volume's b/c extents on the
    a-range (xb/xc are monotone in the plane coordinate, so interval
    overlap at the endpoints bounds them): such rays keep t = 1 and
    sample nothing, so the early-exit test may ignore them."""
    eb, ec, cscale, d0, d1 = view[4], view[5], view[7], view[8], view[9]
    corr = cscale * jnp.sqrt(1.0 + ug * ug + vg * vg)
    xb0, xb1 = eb + ug * d0, eb + ug * d1
    hu = (jnp.minimum(xb0, xb1) <= geom.wb1) & (jnp.maximum(xb0, xb1) >= geom.wb0)
    xc0, xc1 = ec + vg * d0, ec + vg * d1
    hv = (jnp.minimum(xc0, xc1) <= geom.wc1) & (jnp.maximum(xc0, xc1) >= geom.wc0)
    return corr, (hu & hv).astype(jnp.float32)


def _plane_step(rgbt, load, load_tf, a0, a1, wa, dl, ug, vg, corr, view,
                clips, geom: MarchGeometry):
    """Composite one virtual plane onto the carry ``rgbt`` = (r, g, b, t).

    ``ug`` (1, U) and ``vg`` (V, 1) are the rays' slopes; ``load(idx)``
    gathers from the flat (Na·nc·nb) store and ``load_tf(idx)`` from the
    channel-major flat (4·256) transfer function.  Shared verbatim by
    the kernel and the XLA march, so the two differ only in where the
    loop and the carry live."""
    r, g, b, t = rgbt
    eb, ec, eye_a = view[4], view[5], view[6]
    nc, nb = geom.nc, geom.nb
    xb = eb + ug * dl
    xc = ec + vg * dl
    ib0, ib1, wb, in_b = _taps(xb, geom.wb0, geom.wb1, nb)
    ic0, ic1, wc, in_c = _taps(xc, geom.wc0, geom.wc1, nc)
    r0, r1 = ic0 * nb, ic1 * nb

    def bilerp(base):
        top = load(base + r0 + ib0) * (1.0 - wb) + load(base + r0 + ib1) * wb
        bot = load(base + r1 + ib0) * (1.0 - wb) + load(base + r1 + ib1) * wb
        return top * (1.0 - wc) + bot * wc

    slice_len = nc * nb
    dens = bilerp(a0 * slice_len) * (1.0 - wa) + bilerp(a1 * slice_len) * wa

    # Sample mask: inside the volume box, covered by a resident brick
    # (SENTINEL voxels pull interpolated density strongly negative),
    # not clipped.
    keep = in_b & in_c & (dens > -0.5)
    z = dl + eye_a
    for na_, nb_, nc_, d in clips:
        keep = keep & (na_ * z + nb_ * xb + nc_ * xc + d >= 0.0)

    # Post-classification: GL linear-filtered 256-entry lookup.
    s = jnp.clip(jnp.clip(dens, 0.0, 1.0) * TF_SIZE - 0.5, 0.0, TF_SIZE - 1.0)
    i0f = jnp.floor(s)
    wt = s - i0f
    i0 = i0f.astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, TF_SIZE - 1)

    def classify(ch):
        base = ch * TF_SIZE
        return load_tf(base + i0) * (1.0 - wt) + load_tf(base + i1) * wt

    alpha = jnp.where(keep, classify(3), 0.0)
    # Front-to-back composite with the exact early exit: a ray whose
    # accumulated opacity passed the threshold takes no more samples.
    a_corr = 1.0 - jnp.exp(corr * jnp.log(1.0 - jnp.minimum(alpha, ALPHA_CLAMP)))
    a_eff = jnp.where(1.0 - t <= geom.early_exit, a_corr, 0.0)
    w = a_eff * t
    return (
        r + w * classify(0),
        g + w * classify(1),
        b + w * classify(2),
        t * (1.0 - a_eff),
    )


def _keep_marching(t, hit, early_exit):
    """Some ray that can still sample is not saturated."""
    return jnp.max(t * hit) >= 1.0 - early_exit


def _clip_rows(clip, n_clip):
    return [tuple(clip[p, j] for j in range(4)) for p in range(n_clip)]


def march_xla(store, planes_i, planes_f, view, tf, clip, carry, *,
              geom: MarchGeometry):
    """Plain-XLA plane march: a ``lax.while_loop`` over planes whose body
    is :func:`_plane_step` on the whole (V, U) slope grid.  Stops once
    every hitting ray is saturated.  Operands as :func:`march_kernel`."""
    _, v_size, u_size = carry.shape
    k_planes = planes_i.shape[0]
    ug = view[0] + view[1] * jnp.arange(u_size, dtype=jnp.float32)[None, :]
    vg = view[3] + view[2] * jnp.arange(v_size, dtype=jnp.float32)[:, None]
    corr, hit = _ray_setup(ug, vg, view, geom)
    flat = store.reshape(-1)
    tf_flat = tf.T.reshape(-1)
    clips = _clip_rows(clip, geom.n_clip)

    def load(idx):
        return jnp.take(flat, idx, mode="clip")

    def load_tf(idx):
        return jnp.take(tf_flat, idx, mode="clip")

    def cond(state):
        k, rgbt = state
        return (k < k_planes) & _keep_marching(rgbt[3], hit, geom.early_exit)

    def body(state):
        k, rgbt = state
        step = functools.partial(
            _plane_step, rgbt, load, load_tf, planes_i[k, 0], planes_i[k, 1],
            planes_f[k, 0], planes_f[k, 1], ug, vg, corr, view, clips, geom,
        )
        return k + 1, jax.lax.cond(planes_i[k, 2] != 0, step, lambda: rgbt)

    _, rgbt = jax.lax.while_loop(
        cond, body, (jnp.int32(0), tuple(carry[i] for i in range(4)))
    )
    return jnp.stack(rgbt)


def _march_kernel_body(pi_ref, pf_ref, view_ref, clip_ref, tf_ref, store_ref,
                       carry_ref, out_ref, *, geom, k_planes, v_size, u_size):
    """One program: a TILE of slope-grid rays marched over all planes with
    the (r, g, b, t) carry in registers.  The tile stops as soon as all
    of its hitting rays are saturated (early exit per tile, not per
    whole plane); planes whose slices hold no resident brick
    (``act`` = 0) are skipped."""
    tv, tu = TILE
    rows = pl.program_id(0) * tv + jax.lax.broadcasted_iota(jnp.int32, (tv, 1), 0)
    cols = pl.program_id(1) * tu + jax.lax.broadcasted_iota(jnp.int32, (1, tu), 1)
    view = [view_ref[i] for i in range(VIEW_LEN)]
    ug = view[0] + view[1] * cols.astype(jnp.float32)
    vg = view[3] + view[2] * rows.astype(jnp.float32)
    corr, hit = _ray_setup(ug, vg, view, geom)
    # Padding rays past the viewport never hold a tile open.
    hit = jnp.where((rows < v_size) & (cols < u_size), hit, 0.0)
    clips = [
        tuple(clip_ref[p, j] for j in range(4)) for p in range(geom.n_clip)
    ]

    def load(idx):
        return store_ref[idx]

    def load_tf(idx):
        return tf_ref[idx]

    def cond(state):
        k, rgbt = state
        return (k < k_planes) & _keep_marching(rgbt[3], hit, geom.early_exit)

    def body(state):
        k, rgbt = state
        step = functools.partial(
            _plane_step, rgbt, load, load_tf, pi_ref[k, 0], pi_ref[k, 1],
            pf_ref[k, 0], pf_ref[k, 1], ug, vg, corr, view, clips, geom,
        )
        return k + 1, jax.lax.cond(pi_ref[k, 2] != 0, step, lambda: rgbt)

    rgbt = tuple(carry_ref[i] for i in range(4))
    _, rgbt = jax.lax.while_loop(cond, body, (jnp.int32(0), rgbt))
    for i in range(4):
        out_ref[i] = rgbt[i]


def march_kernel(store, planes_i, planes_f, view, tf, clip, carry, *,
                 geom: MarchGeometry, interpret: bool = False):
    """Hopper plane march: a Pallas kernel through Triton.

    store (Na, nc, nb) f32 normalized density; planes_i (K, 3) i32 rows
    [a0, a1, act] (slice indices into ``store``); planes_f (K, 2) f32
    rows [wa, z − eye_a]; view (VIEW_LEN,) f32 (:func:`plane_operands`);
    tf (256, 4); clip (MAX_CLIP, 4) rows [n_a, n_b, n_c, d]; carry
    (4, V, U) = [r, g, b, t] → the carry after the K planes.

    The grid runs over TILE-sized blocks of the slope grid; each program
    loops over the K planes inside the block with its carry in
    registers, so the march moves the carry through device memory once
    per pass instead of once per plane.  ``interpret=True`` runs it in
    the Pallas interpreter (tests on the CPU)."""
    na, nc, nb = store.shape
    if na * nc * nb >= 2**31:
        raise ValueError(f"store {store.shape} exceeds int32 gather indices")
    _, v_size, u_size = carry.shape
    tv, tu = TILE
    v_pad, u_pad = -(-v_size // tv) * tv, -(-u_size // tu) * tu
    carry_p = jnp.pad(
        carry, ((0, 0), (0, v_pad - v_size), (0, u_pad - u_size)),
        constant_values=1.0,
    )
    whole = pl.BlockSpec()
    tile_spec = pl.BlockSpec((4, tv, tu), lambda i, j: (0, i, j))
    kernel = functools.partial(
        _march_kernel_body, geom=geom, k_planes=planes_i.shape[0],
        v_size=v_size, u_size=u_size,
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(carry_p.shape, jnp.float32),
        grid=(v_pad // tv, u_pad // tu),
        in_specs=[whole] * 6 + [tile_spec],
        out_specs=tile_spec,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="bricked_march",
    )(
        planes_i, planes_f, view, clip, tf.T.reshape(-1), store.reshape(-1),
        carry_p,
    )
    return out[:, :v_size, :u_size]


def default_march():
    """The march for this backend: the kernel where it compiles for the
    card, plain XLA on the CPU."""
    return march_kernel if backend.use_gpu_kernels() else march_xla


def plane_operands(vs, *, k_planes, na_real, na_store, content=None,
                   k_total=None):
    """Device-side march operands from the view vector ``vs``
    [wa0, wa1, eye_a, u0, du, dv, eb, ec, v0, sign, msr(, k0, a_base)].

    The plane grid is GLOBAL: plane k of this call is global plane
    k0 + k of ``k_total`` (default ``k_planes``), and slice indices are
    localized to a store whose slice 0 is global slice ``a_base`` — so
    slab segments fold bit-identically to the monolithic sweep (the
    generalized step-grid alignment of fragRaycast.glsl:152-158).  a1
    carries the GLOBAL clamp at the volume edge.

    Returns (planes_i (K, 3) i32 [a0, a1, act], planes_f (K, 2) f32
    [wa, z − eye_a], view (VIEW_LEN,) f32 [u0, du, dv, v0, eb, ec,
    eye_a, msr·dz, wa0 − eye_a, wa1 − eye_a, 0…])."""
    wa0, wa1, eye_a = vs[0], vs[1], vs[2]
    u0, du, dv = vs[3], vs[4], vs[5]
    eb, ec, v0, sign, msr = vs[6], vs[7], vs[8], vs[9], vs[10]
    ext = int(vs.shape[0]) > 11
    k0 = vs[11] if ext else jnp.float32(0.0)
    ab = vs[12] if ext else jnp.float32(0.0)
    kt = k_total if k_total is not None else k_planes
    k = k0 + jnp.arange(k_planes, dtype=jnp.float32)
    dz = (wa1 - wa0) / kt
    z = jnp.where(sign > 0, wa0 + (k + 0.5) * dz, wa1 - (k + 0.5) * dz)
    sa = jnp.clip((z - wa0) / (wa1 - wa0) * na_real - 0.5, -0.5, na_real - 0.5)
    i0 = jnp.floor(jnp.clip(sa, 0.0, float(na_real - 1)))
    wa = jnp.clip(sa - i0, 0.0, 1.0)
    a0 = jnp.clip(i0 - ab, 0.0, float(na_store - 1)).astype(jnp.int32)
    a1 = jnp.clip(
        jnp.minimum(i0 + 1.0, float(na_real - 1)) - ab, 0.0, float(na_store - 1)
    ).astype(jnp.int32)
    if content is None:
        act = jnp.ones((k_planes,), jnp.int32)
    else:
        act = jnp.take(content, a0) | jnp.take(content, a1)
    view = jnp.zeros((VIEW_LEN,), jnp.float32).at[:10].set(jnp.stack([
        u0, du, dv, v0, eb, ec, eye_a, msr * dz, wa0 - eye_a, wa1 - eye_a,
    ]))
    return (
        jnp.stack([a0, a1, act], axis=1),
        jnp.stack([wa, z - eye_a], axis=1),
        view,
    )


def initial_carry(v_size: int, u_size: int) -> jnp.ndarray:
    """(4, V, U) march carry before the first plane: rgb 0, t 1."""
    return jnp.zeros((4, v_size, u_size), jnp.float32).at[3].set(1.0)


def carry_to_rgba(carry: jnp.ndarray) -> jnp.ndarray:
    """(4, V, U) [r, g, b, t] carry → (V, U, 4) premultiplied rgba."""
    return jnp.stack([carry[0], carry[1], carry[2], 1.0 - carry[3]], axis=-1)


def clip_matrix(
    clip_planes_world: Optional[np.ndarray], axis: int
) -> Tuple[np.ndarray, int]:
    """(MAX_CLIP, 4) clip-plane rows [n_a, n_b, n_c, d] reordered for
    the major axis; returns (matrix, n_clip).  Plane convention: keep
    the half-space n·x + d ≥ 0 (core/clip_planes.py)."""
    m = np.zeros((MAX_CLIP, 4), np.float32)
    if clip_planes_world is None or len(clip_planes_world) == 0:
        return m, 0
    b_axis, c_axis = sw._BC_AXES[axis]
    cp = np.asarray(clip_planes_world, np.float32).reshape(-1, 4)
    n = min(len(cp), MAX_CLIP)
    for i in range(n):
        nvec = cp[i, :3]
        m[i] = (nvec[axis], nvec[b_axis], nvec[c_axis], cp[i, 3])
    return m, n


# ================================================================= host plan
@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """One A-slab pass: store slice range plus its plane sub-range."""

    a_lo: int  # first render-level slice assembled for this pass
    a_hi_incl: int  # last slice assembled (includes +1 lerp boundary)
    k_lo: int  # first global plane index of this pass
    k_hi: int  # one past the last plane


def view_vector(
    *,
    world_min,
    world_max,
    axis: int,
    eye,
    sign: float,
    slope_bounds: Tuple[float, float, float, float],
    inter_size: Tuple[int, int],
    max_samples_per_ray: float,
) -> np.ndarray:
    """The 11-float view vector [wa0, wa1, eye_a, u0, du, dv, eb, ec, v0,
    sign, msr] that :func:`plane_operands` expands on the device."""
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    b_axis, c_axis = sw._BC_AXES[axis]
    eye = np.asarray(eye, np.float32)
    u0, u1, v0, v1 = slope_bounds
    v_size, u_size = inter_size
    return np.float32([
        wmin[axis], wmax[axis], eye[axis],
        u0, (u1 - u0) / (u_size - 1), (v1 - v0) / (v_size - 1),
        eye[b_axis], eye[c_axis], v0, sign,
        max_samples_per_ray,
    ])


@functools.partial(jax.jit, static_argnames=("k_planes", "na"))
def _global_slices(vs, *, k_planes, na):
    planes_i, _, _ = plane_operands(
        vs, k_planes=k_planes, na_real=na, na_store=na
    )
    return planes_i[:, :2]


def plane_slices(vs, *, k_planes: int, na: int):
    """Global bracketing slice indices (a0, a1) of every plane, as numpy,
    for the host's slab planning.  They come from the march's own
    :func:`plane_operands`, so a slab always holds the slices its
    planes read, and the multipass composite equals the one-pass one."""
    a = np.asarray(_global_slices(
        jnp.asarray(np.asarray(vs, np.float32)[:11]), k_planes=k_planes, na=na
    ))
    return a[:, 0], a[:, 1]


def make_slab_plans(
    a0: np.ndarray, na: int, max_slices: int
) -> List[SlabPlan]:
    """Partition the march into A-slab passes of ≤ max_slices assembled
    slices each, covering all planes in march order.  Consecutive
    planes share slices, so slab boundaries repeat one slice — the
    assembled values are identical both times (pure function of the
    rendering set), keeping the composite bit-equal to one pass."""
    k_total = len(a0)
    if na <= max_slices:
        return [SlabPlan(0, na - 1, 0, k_total)]
    plans: List[SlabPlan] = []
    k = 0
    width = max(2, max_slices)
    while k < k_total:
        lo = int(a0[k])
        if int(a0[k_total - 1]) >= lo:  # marching toward +A
            s_lo, s_hi = lo, min(lo + width - 1, na - 1)
        else:  # marching toward -A: a0 decreasing
            s_hi, s_lo = min(lo + 1, na - 1), max(0, lo + 1 - (width - 1))
        tail = a0[k:]
        need_hi = np.minimum(tail + 1, na - 1)
        in_slab = (tail >= s_lo) & (need_hi <= s_hi)
        run = int(np.argmin(in_slab)) if not in_slab.all() else len(in_slab)
        run = max(run, 1)
        plans.append(SlabPlan(s_lo, s_hi, k, k + run))
        k += run
    return plans


# ================================================================== assembly
@dataclasses.dataclass(frozen=True)
class LevelTables:
    """Per-level assembly tables in permuted (A, C, B) tile order."""

    level: int
    factor: int  # 2^(render_level − level)
    slots: np.ndarray  # (ta, tc, tb) i32 atlas slot per tile (0 if absent)
    resident: np.ndarray  # (ta, tc, tb) f32 1 = brick resident
    own: np.ndarray  # (ta, tc, tb) f32 1 = rendering set assigns this level
    dims: Tuple[int, int, int]  # level voxel dims (A_l, C_l, B_l)


@dataclasses.dataclass(frozen=True)
class AssemblyPlan:
    """Static-per-(dataset, axis, level-set) assembly description."""

    axis: int
    render_level: int
    fine_dims: Tuple[int, int, int]  # (Na, Nc, Nb) render-level grid
    block: Tuple[int, int, int]  # interior block (ba, bc, bb) permuted
    padded_zyx: Tuple[int, int, int]  # padded brick (BZ, BY, BX) array order
    overlap: Tuple[int, int, int]  # (oa, oc, ob) permuted
    levels: Tuple[LevelTables, ...]
    lo: float  # data_source_range normalization
    hi: float


def _permute_xyz(t_xyz, perm):
    """World-axis-ordered (x, y, z) triple → permuted array order
    (a, c, b): volume arrays are (Z, Y, X), perm maps array dims."""
    zyx = (t_xyz[2], t_xyz[1], t_xyz[0])
    return tuple(zyx[p] for p in perm)


def build_assembly_plan(
    datasource,
    rendering_set: Sequence,  # NodeIds
    axis: int,
    slot_of,  # NodeId -> atlas slot (must be resident)
    data_source_range: Tuple[float, float],
    render_level: Optional[int] = None,
) -> AssemblyPlan:
    """Host-side planning: group the rendering set by level, build full
    tile-grid slot/resident/ownership tables in permuted (A, C, B)
    order.  Table shapes depend only on (dataset, levels present), so
    the jitted assembler does not retrace on camera motion."""
    info = datasource.volume_info
    perm = sw._PERM[axis]
    depth = info.root_node.depth
    by_level: Dict[int, list] = {}
    for n in rendering_set:
        by_level.setdefault(n.level, []).append(n)
    if render_level is None:
        render_level = max(by_level)

    shift = depth - 1 - render_level
    fine_xyz = tuple(max(1, d >> shift) for d in info.voxels)
    fine_dims = _permute_xyz(fine_xyz, perm)
    block = _permute_xyz(info.block_size, perm)
    overlap = _permute_xyz(info.overlap, perm)
    mbs = info.maximum_block_size  # (x, y, z)
    padded_zyx = (mbs[2], mbs[1], mbs[0])
    bx, by_, bz = info.block_size

    levels = []
    for level in sorted(by_level):
        lshift = depth - 1 - level
        lvx, lvy, lvz = (max(1, d >> lshift) for d in info.voxels)
        tx, ty, tz = (-(-lvx // bx), -(-lvy // by_), -(-lvz // bz))
        ta, tc, tb = _permute_xyz((tx, ty, tz), perm)
        slots = np.zeros((ta, tc, tb), np.int32)
        resident = np.zeros((ta, tc, tb), np.float32)
        own = np.zeros((ta, tc, tb), np.float32)
        for node in by_level[level]:
            pa, pc, pb = _permute_xyz(node.position, perm)
            slots[pa, pc, pb] = slot_of(node)
            resident[pa, pc, pb] = 1.0
            own[pa, pc, pb] = 1.0
        levels.append(
            LevelTables(
                level=level,
                factor=1 << (render_level - level),
                slots=slots,
                resident=resident,
                own=own,
                dims=_permute_xyz((lvx, lvy, lvz), perm),
            )
        )
    lo, hi = data_source_range
    return AssemblyPlan(
        axis=axis,
        render_level=render_level,
        fine_dims=fine_dims,
        block=block,
        padded_zyx=padded_zyx,
        overlap=overlap,
        levels=tuple(levels),
        lo=float(lo),
        hi=float(hi),
    )


def _upsample_matrix(
    n_fine: int,
    n_coarse: int,
    f_lo: int,
    f_hi_incl: int,
    c_base: int,
    c_count: int,
) -> np.ndarray:
    """(fine rows f_lo..f_hi_incl, c_count) two-tap matrix sampling the
    coarse grid (rows c_base..c_base+c_count of the full coarse axis) at
    fine voxel centers, clamp-to-edge against the FULL coarse axis."""
    j = np.arange(f_lo, f_hi_incl + 1, dtype=np.float64)
    s = (j + 0.5) * (n_coarse / n_fine) - 0.5
    s = np.clip(s, 0.0, n_coarse - 1.0)
    i0 = np.floor(s).astype(np.int64)
    w = s - i0
    i1 = np.minimum(i0 + 1, n_coarse - 1)
    m = np.zeros((len(j), c_count), np.float32)
    rows = np.arange(len(j))
    m[rows, np.clip(i0 - c_base, 0, c_count - 1)] += (1.0 - w).astype(
        np.float32
    )
    m[rows, np.clip(i1 - c_base, 0, c_count - 1)] += w.astype(np.float32)
    return m


@functools.lru_cache(maxsize=64)
def _compiled_assembler(
    *,
    perm: Tuple[int, int, int],
    padded_zyx: Tuple[int, int, int],
    overlap_acb: Tuple[int, int, int],
    block_acb: Tuple[int, int, int],
    level_shapes: Tuple,  # ((layers, tc, tb, factor, dc, db, s_rows), ...)
    fine_nc: int,
    fine_nb: int,
    out_slices: int,
    lo: float,
    hi: float,
):
    """Jitted multi-level slab assembler.

    All runtime operands are either device-resident (the atlas) or TINY
    (per-level tile tables of a few KB + two-tap A matrices): ownership
    and coverage masks expand to voxel granularity ON DEVICE, so a slab
    assembly moves a handful of kilobytes host→device."""
    oa, oc, ob = overlap_acb
    ba, bc, bb = block_acb

    @jax.jit
    def assemble(atlas, level_ops):
        num = None
        den = None
        for (layers, tc, tb, factor, dc, db, s_rows), ops in zip(
            level_shapes, level_ops
        ):
            slots = ops["isr"][0].reshape(-1)
            rows = jnp.take(atlas, slots, axis=0)  # (n, voxels)
            bricks = rows.reshape(
                (-1,) + padded_zyx
            ).astype(jnp.float32)
            # (n, BZ, BY, BX) → (n, pa, pc, pb) permuted brick dims.
            bricks = jnp.transpose(
                bricks, (0,) + tuple(p + 1 for p in perm)
            )
            cores = bricks[:, oa : oa + ba, oc : oc + bc, ob : ob + bb]
            resident = ops["isr"][1].reshape(-1, 1, 1, 1)
            vals = cores * resident
            grid = vals.reshape(layers, tc, tb, ba, bc, bb)
            grid = jnp.transpose(grid, (0, 3, 1, 4, 2, 5)).reshape(
                layers * ba, tc * bc, tb * bb
            )[:, :dc, :db]
            cov = jnp.broadcast_to(
                ops["isr"][1][:, None, :, None, :, None],
                (layers, ba, tc, bc, tb, bb),
            ).reshape(layers * ba, tc * bc, tb * bb)[:, :dc, :db]

            if factor == 1:
                v_up = jax.lax.dynamic_slice(
                    grid, (ops["a_off"], 0, 0), (s_rows, dc, db)
                )
                c_up = jax.lax.dynamic_slice(
                    cov, (ops["a_off"], 0, 0), (s_rows, dc, db)
                )
            else:
                da = layers * ba

                def up(x):
                    # precision=HIGHEST: a default-precision f32
                    # matmul may run in TF32 (~1e-3 error) — the
                    # upsample must be exact so mixed-LOD assembly
                    # matches the trilinear oracle.
                    hp = jax.lax.Precision.HIGHEST
                    x = jnp.dot(
                        ops["amat"], x.reshape(da, dc * db),
                        preferred_element_type=jnp.float32,
                        precision=hp,
                    ).reshape(-1, dc, db)
                    x = jnp.einsum(
                        "fc,scb->sfb", ops["cmat"], x,
                        preferred_element_type=jnp.float32,
                        precision=hp,
                    )
                    x = jnp.einsum(
                        "gb,sfb->sfg", ops["bmat"], x,
                        preferred_element_type=jnp.float32,
                        precision=hp,
                    )
                    return x

                v_up = up(grid)
                c_up = up(cov)

            # Ownership at render-level granularity, expanded on device:
            # slab row i belongs to tile layer (a_lo+i)//(ba·f) − l_lo.
            fa = factor * ba
            row_idx = (
                ops["own_row0"]
                + jax.lax.broadcasted_iota(jnp.int32, (s_rows, 1), 0)[:, 0]
            ) // fa - ops["own_l0"]
            own = jnp.take(ops["isr"][2], row_idx, axis=0)  # (S, tc, tb)
            own = jnp.repeat(own, factor * bc, axis=1)[:, :fine_nc]
            own = jnp.repeat(own, factor * bb, axis=2)[:, :, :fine_nb]
            v_up = v_up * own
            c_up = c_up * own
            num = v_up if num is None else num + v_up
            den = c_up if den is None else den + c_up

        covered = den > 0.01
        dens = jnp.where(covered, num / jnp.maximum(den, 1e-6), 0.0)
        dens = jnp.clip((dens - lo) / (hi - lo), 0.0, 1.0)
        dens = jnp.where(covered, dens, SENTINEL)
        out = jnp.full((out_slices, fine_nc, fine_nb), SENTINEL, jnp.float32)
        return jax.lax.dynamic_update_slice(out, dens, (0, 0, 0))

    return assemble


@functools.lru_cache(maxsize=512)
def _upsample_matrix_dev(n_fine, n_coarse, lo, hi, base, span):
    """Device-resident two-tap upsample matrix, cached per geometry —
    these are pure functions of static ints and identical every frame,
    so re-uploading them per slab was pure transfer latency."""
    return jnp.asarray(_upsample_matrix(n_fine, n_coarse, lo, hi, base, span))


def assemble_store(
    atlas_data: jnp.ndarray,
    plan: AssemblyPlan,
    a_lo: int = 0,
    a_hi_incl: Optional[int] = None,
    out_slices: Optional[int] = None,
) -> jnp.ndarray:
    """Assemble render-level slices [a_lo, a_hi_incl] from the atlas →
    (out_slices, Nc, Nb) normalized density (SENTINEL outside
    coverage).  Per-level traffic is restricted to the tile layers the
    slab touches (+1 guard layer for upsample taps)."""
    na, nc, nb = plan.fine_dims
    if a_hi_incl is None:
        a_hi_incl = na - 1
    a_hi_incl = min(a_hi_incl, na - 1)
    s_count = a_hi_incl - a_lo + 1
    if out_slices is None:
        out_slices = s_count
    perm = sw._PERM[plan.axis]
    ba = plan.block[0]

    level_shapes = []
    level_ops = []
    for lt in plan.levels:
        da_l, dc_l, db_l = lt.dims
        f = lt.factor
        # Tile layers of this level touched by fine rows [a_lo, a_hi_incl]
        # (+1 coarse-voxel guard for the upsample taps).
        c_lo_vox = max(0, int(np.floor((a_lo + 0.5) / f - 0.5)) - 1)
        c_hi_vox = min(
            da_l - 1, int(np.ceil((a_hi_incl + 0.5) / f - 0.5)) + 1
        )
        l_lo = c_lo_vox // ba
        l_hi = c_hi_vox // ba  # inclusive
        layers = l_hi - l_lo + 1
        c_base = l_lo * ba
        sl = slice(l_lo, l_hi + 1)
        if f == 1:
            amat = np.zeros((1, 1), np.float32)  # unused placeholder
            a_off = a_lo - c_base
        else:
            # Columns span the sliced layer range; taps are globally
            # clamped to da_l−1 by construction, so edge-partial layers
            # never contribute junk rows.
            amat = _upsample_matrix(
                na, da_l, a_lo, a_hi_incl, c_base, layers * ba
            )
            a_off = 0
        # ONE packed i32 transfer per level for the residency-varying
        # tables (slots/resident/own), instead of three small
        # device_puts.
        ops = {
            "isr": jnp.asarray(
                np.stack(
                    [
                        lt.slots[sl],
                        lt.resident[sl].astype(lt.slots.dtype),
                        lt.own[sl].astype(lt.slots.dtype),
                    ]
                )
            ),
            "amat": jnp.asarray(amat)
            if f == 1
            else _upsample_matrix_dev(
                na, da_l, a_lo, a_hi_incl, c_base, layers * ba
            ),
            "a_off": jnp.int32(a_off),
            "own_row0": jnp.int32(a_lo),
            "own_l0": jnp.int32(l_lo),
        }
        if f != 1:
            ops["cmat"] = _upsample_matrix_dev(nc, dc_l, 0, nc - 1, 0, dc_l)
            ops["bmat"] = _upsample_matrix_dev(nb, db_l, 0, nb - 1, 0, db_l)
        level_shapes.append(
            (
                layers, lt.slots.shape[1], lt.slots.shape[2], f, dc_l,
                db_l, s_count,
            )
        )
        level_ops.append(ops)

    fn = _compiled_assembler(
        perm=perm,
        padded_zyx=plan.padded_zyx,
        overlap_acb=plan.overlap,
        block_acb=plan.block,
        level_shapes=tuple(level_shapes),
        fine_nc=nc,
        fine_nb=nb,
        out_slices=int(out_slices),
        lo=plan.lo,
        hi=plan.hi,
    )
    return fn(atlas_data, level_ops)


# =================================================== single-dispatch frames
def march_geometry(
    *, nc: int, nb: int, world_min, world_max, axis: int, early_exit: float,
    n_clip: int = 0,
) -> MarchGeometry:
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    b_axis, c_axis = sw._BC_AXES[axis]
    return MarchGeometry(
        nc=int(nc), nb=int(nb),
        wb0=float(wmin[b_axis]), wb1=float(wmax[b_axis]),
        wc0=float(wmin[c_axis]), wc1=float(wmax[c_axis]),
        early_exit=float(early_exit), n_clip=int(n_clip),
    )


@functools.lru_cache(maxsize=128)
def _compiled_store_frame(
    *,
    march,
    geom: MarchGeometry,
    na_store: int,  # store A extent (may exceed na_real with padding)
    na_real: int,  # real render-level slice count (plane-table clamp)
    k_planes: int,
    v_size: int,
    u_size: int,
    with_content: bool,
    axis: int,
    viewport: Optional[Tuple[int, int, int, int]],  # None = slope grid out
    emit_transmittance: bool = False,  # also return the final t carry
    k_total: int = None,  # slab mode: GLOBAL plane count (k_planes local)
    vs_len: int = 11,  # 13 in slab mode: vs appends [k0, a_base]
):
    """ONE jitted dispatch per steady-state frame: device-side plane
    tables derived from the view vector, the plane march, and (with a
    viewport) the camera→screen warp.  Host→device per frame = one
    43-float vector."""

    @jax.jit
    def run(store, tf, fv, clip, content):
        # fv (43,): [vs(11) | inv_proj.ravel()(16) | inv_mv.ravel()(16)];
        # vs = [wa0, wa1, eye_a, u0, du, dv, eb, ec, v0, sign, msr].
        vs = fv[:vs_len]
        planes_i, planes_f, view = plane_operands(
            vs, k_planes=k_planes, na_real=na_real, na_store=na_store,
            content=content if with_content else None, k_total=k_total,
        )
        carry = march(
            store, planes_i, planes_f, view, tf, clip,
            initial_carry(v_size, u_size), geom=geom,
        )
        inter = carry_to_rgba(carry)
        if emit_transmittance:
            return inter, carry[3]
        if viewport is None:
            return inter
        return _warp(
            inter, fv, axis=axis, viewport=viewport, v_size=v_size,
            u_size=u_size,
        )

    return run


def frame_vector(camera, vs) -> np.ndarray:
    """The 43-float frame vector [vs (11) | inv_proj (16) | inv_mv (16)]."""
    fv = np.empty(43, np.float32)
    fv[:11] = np.asarray(vs, np.float32)[:11]
    fv[11:27] = np.asarray(camera.inv_proj, np.float32).ravel()
    fv[27:43] = np.asarray(camera.inv_mv, np.float32).ravel()
    return fv


def _warp(inter, fv, *, axis, viewport, v_size, u_size):
    """Slope grid (V, U, 4) → screen, from the frame vector ``fv``."""
    u0, du, dv, v0, sign = (fv[i] for i in (3, 4, 5, 8, 9))
    return sw.warp_frame_device(
        inter, fv[11:27].reshape(4, 4), fv[27:43].reshape(4, 4),
        u0, du, dv, v0, sign,
        axis=axis, viewport=viewport, v_size=v_size, u_size=u_size,
    )


# The multipass frame's warp: the same code as the one-dispatch frame's,
# with the view as a runtime operand in both, so the two agree.
warp_to_screen = jax.jit(
    _warp, static_argnames=("axis", "viewport", "v_size", "u_size")
)


class StoreFrameRunner:
    """Per-frame host fast path for steady-state interactive frames.

    A runner hoists everything camera-INDEPENDENT out of the frame loop
    (compiled dispatch, clip matrix, geometry); per frame only the
    43-float view vector is rebuilt (camera matrices + slope-grid
    params) and the single jitted dispatch issued — the host analog of
    the reference keeping its GL pipeline objects across frames
    (GLRaycastPipeline.cpp:56-90)."""

    __slots__ = (
        "run", "clip_j", "content", "axis", "wmin", "wmax", "u_size",
        "v_size", "max_spr", "slope_margin",
    )

    def __init__(
        self, store, plan, *, params, swp, world_min, world_max,
        clip_planes_world=None, content=None, viewport=None,
    ):
        wmin = np.asarray(world_min, np.float32)
        wmax = np.asarray(world_max, np.float32)
        axis = plan.axis
        self.axis = axis
        na, nc, nb = plan.fine_dims
        clip_m, n_clip = clip_matrix(clip_planes_world, axis)
        self.clip_j = jnp.asarray(clip_m)
        self.v_size, self.u_size = swp.inter_size
        self.wmin, self.wmax = wmin, wmax
        self.max_spr = float(params.max_samples_per_ray)
        self.slope_margin = swp.slope_margin
        self.content = (
            content if content is not None else jnp.zeros((1,), jnp.int32)
        )
        self.run = _compiled_store_frame(
            march=default_march(),
            geom=march_geometry(
                nc=nc, nb=nb, world_min=wmin, world_max=wmax, axis=axis,
                early_exit=params.early_exit, n_clip=n_clip,
            ),
            na_store=store.shape[0],
            na_real=na,
            k_planes=swp.n_planes,
            v_size=self.v_size,
            u_size=self.u_size,
            with_content=content is not None,
            axis=axis,
            viewport=tuple(int(x) for x in viewport)
            if viewport is not None
            else None,
        )

    def view_vector(self, camera, sw_plan) -> np.ndarray:
        return frame_vector(camera, view_vector(
            world_min=self.wmin, world_max=self.wmax, axis=self.axis,
            eye=sw_plan.eye, sign=sw_plan.sign, slope_bounds=sw_plan.bounds,
            inter_size=(self.v_size, self.u_size),
            max_samples_per_ray=self.max_spr,
        ))

    def __call__(self, store, tf, camera, sw_plan=None):
        if sw_plan is None:
            sw_plan = sw.make_view_plan(camera, self.slope_margin)
        assert sw_plan.axis == self.axis
        fv = self.view_vector(camera, sw_plan)
        return self.run(store, tf, jnp.asarray(fv), self.clip_j,
                        self.content)


def render_store_frame(
    store: jnp.ndarray,  # (Na_store, Nc, Nb) from assemble_store
    plan: AssemblyPlan,
    tf: jnp.ndarray,  # (256, 4) device-resident transfer function
    camera,
    *,
    params: RenderParams,
    swp: sw.ShearWarpParams,
    world_min,
    world_max,
    clip_planes_world: Optional[np.ndarray] = None,
    content: Optional[jnp.ndarray] = None,
    to_screen: bool = True,
) -> jnp.ndarray:
    """Steady-state interactive frame from a cached assembled store:
    camera → (H, W, 4) screen image (or the (V, U, 4) slope grid with
    ``to_screen=False``) in ONE device dispatch.  TF edits and camera
    motion are runtime operands — no recompilation, no reassembly
    (≤3 compilations per store geometry, one per major axis)."""
    runner = StoreFrameRunner(
        store, plan, params=params, swp=swp, world_min=world_min,
        world_max=world_max, clip_planes_world=clip_planes_world,
        content=content,
        viewport=camera.viewport if to_screen else None,
    )
    return runner(store, tf, camera)


def store_content(store: jnp.ndarray, na_real: int) -> jnp.ndarray:
    """(Na_store,) int32 per-slice coverage flags for bit-exact
    empty-space skipping: a plane whose bracketing slices are both fully
    uncovered interpolates to SENTINEL everywhere, masks to zero alpha,
    and its composite step is the identity."""
    cov = (store > -0.5).astype(jnp.int32)
    c = (jnp.max(cov, axis=(1, 2)) > 0).astype(jnp.int32)
    return c.at[na_real:].set(0)


# ==================================================================== driver
@functools.lru_cache(maxsize=64)
def _compiled_slab_pass(
    *, march, geom: MarchGeometry, k_pass: int, k_total: int, na_real: int,
    na_store: int,
):
    """One A-slab pass: planes k0 … k0 + k_pass − 1 of the global grid
    (the first ``n_active`` of them real) against a slab whose slice 0
    is global slice ``a_base`` (both appended to ``vs``)."""

    @jax.jit
    def run(slab, vs, n_active, tf, clip, carry):
        planes_i, planes_f, view = plane_operands(
            vs, k_planes=k_pass, na_real=na_real, na_store=na_store,
            k_total=k_total,
        )
        act = (jnp.arange(k_pass) < n_active).astype(jnp.int32)
        return march(
            slab, planes_i.at[:, 2].set(act), planes_f, view, tf, clip,
            carry, geom=geom,
        )

    return run


@dataclasses.dataclass
class SlabSweep:
    """Per-frame slab-pass runner: the view vector, TF and clip rows
    plus the GLOBAL plane-to-slice table; ``run_pass`` executes one
    memory-bounded A-slab against the carried (rgb, transmittance) —
    the multipass accumulation texture of GLRaycastPipeline.cpp:148-186.
    Each pass derives its planes on the device exactly as the one-pass
    frame does, so passes compose to the same sample set as one sweep
    (fragRaycast.glsl:152-158 generalized), equal up to how the compiler
    contracts each program's float ops."""

    geom: MarchGeometry
    plans: List[SlabPlan]
    k_pass: int  # planes per pass (the longest pass; shorter ones pad)
    k_total: int
    na_real: int
    v_size: int
    u_size: int
    vs: np.ndarray
    tf: jnp.ndarray
    clip_j: jnp.ndarray

    def initial_carry(self):
        return initial_carry(self.v_size, self.u_size)

    def run_pass(self, slab, sp: SlabPlan, a_base: int, carry):
        run = _compiled_slab_pass(
            march=default_march(), geom=self.geom, k_pass=self.k_pass,
            k_total=self.k_total, na_real=self.na_real,
            na_store=int(slab.shape[0]),
        )
        vs = np.concatenate([self.vs, np.float32([sp.k_lo, a_base])])
        return run(
            slab, jnp.asarray(vs), jnp.int32(sp.k_hi - sp.k_lo), self.tf,
            self.clip_j, carry,
        )

    def finish(self, carry) -> jnp.ndarray:
        return carry_to_rgba(carry)


def make_slab_sweep(
    tf: jnp.ndarray,
    *,
    fine_dims: Tuple[int, int, int],
    eye,
    sign: float,
    slope_bounds: Tuple[float, float, float, float],
    axis: int,
    world_min,
    world_max,
    params: RenderParams,
    swp: sw.ShearWarpParams,
    clip_planes_world: Optional[np.ndarray] = None,
    max_slices: Optional[int] = None,
) -> SlabSweep:
    """The sweep of one frame in A-slab passes of at most ``max_slices``
    store slices each (None: one pass over the whole store)."""
    na, nc, nb = fine_dims
    k_total = swp.n_planes
    vs = view_vector(
        world_min=world_min, world_max=world_max, axis=axis, eye=eye,
        sign=sign, slope_bounds=slope_bounds, inter_size=swp.inter_size,
        max_samples_per_ray=params.max_samples_per_ray,
    )
    if max_slices is None or na <= max_slices:
        plans = [SlabPlan(0, na - 1, 0, k_total)]
    else:
        a0, _a1 = plane_slices(vs, k_planes=k_total, na=na)
        plans = make_slab_plans(a0, na, max_slices)
    clip_m, n_clip = clip_matrix(clip_planes_world, axis)
    v_size, u_size = swp.inter_size
    return SlabSweep(
        geom=march_geometry(
            nc=nc, nb=nb, world_min=world_min, world_max=world_max,
            axis=axis, early_exit=params.early_exit, n_clip=n_clip,
        ),
        plans=plans,
        k_pass=max(p.k_hi - p.k_lo for p in plans),
        k_total=k_total,
        na_real=na,
        v_size=v_size,
        u_size=u_size,
        vs=vs,
        tf=jnp.asarray(tf, jnp.float32),
        clip_j=jnp.asarray(clip_m),
    )


def render_bricked_slope_grid(
    atlas_data: jnp.ndarray,
    plan: AssemblyPlan,
    tf: jnp.ndarray,  # (256, 4)
    *,
    eye,
    sign: float,
    slope_bounds: Tuple[float, float, float, float],
    world_min,
    world_max,
    params: RenderParams,
    swp: sw.ShearWarpParams,
    clip_planes_world: Optional[np.ndarray] = None,
    max_slab_slices: Optional[int] = None,
    store: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Full slope-space render of the rendering set → (V, U, 4).

    Assembles the density store in A-slab passes (≤ ``max_slab_slices``
    assembled slices each) and marches each with the compositing carry
    threaded through — the memory-bounded multipass of
    GLRaycastPipeline.cpp:148-186.  Pass a prebuilt full-range ``store``
    (from :func:`assemble_store`) to skip assembly (the engine's
    steady-state cache)."""
    sweep = make_slab_sweep(
        tf,
        fine_dims=plan.fine_dims,
        eye=eye,
        sign=sign,
        slope_bounds=slope_bounds,
        axis=plan.axis,
        world_min=world_min,
        world_max=world_max,
        params=params,
        swp=swp,
        clip_planes_world=clip_planes_world,
        max_slices=None if store is not None else max_slab_slices,
    )
    carry = sweep.initial_carry()
    slab_na = max(p.a_hi_incl - p.a_lo + 1 for p in sweep.plans)
    for sp in sweep.plans:
        if store is None:
            slab = assemble_store(
                atlas_data, plan, sp.a_lo, sp.a_hi_incl, out_slices=slab_na
            )
            a_base = sp.a_lo
        else:
            slab = store
            a_base = 0
        carry = sweep.run_pass(slab, sp, a_base, carry)
    return sweep.finish(carry)
