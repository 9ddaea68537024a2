"""Differentiable store rendering: plane-march forward + batched
recompute backward.

``render_store_grid_diff(store, tf, view)`` renders the (V, U, 4) slope
grid from a normalized density store with POST-classification — the
semantics of the ops/shearwarp_bricked plane march — under a
``jax.custom_vjp``:

* **Forward**: the bricked plane march (zero extra residual cost beyond
  the final transmittance, which the march already carries).
* **Backward**: two batched recompute sweeps over plane CHUNKS in plain
  XLA:

  - phase A re-runs the transmittance recurrence per chunk to recover
    the per-chunk carry boundaries (t, and the prefix of
    w·⟨g, rgb⟩ needed by the suffix trick);
  - phase B recomputes each chunk's planes and distributes gradients:
    front-to-back compositing inverts with the total-minus-prefix
    identity ∂L/∂a_k = t_k·D_k − (TOT − P_k)/(1−a_k) + g_a·t_K/(1−a_k)
    (the standard NeRF-style inversion; TOT = ⟨g, out_rgb⟩ needs no
    extra sweep), the two in-plane resampling matmuls transpose, the
    axis lerp transposes into ONE (Na, K)·(K, Nc·Nb) matmul, and the
    transfer-function gradient runs as a chunked one-hot matmul.

  Early-exit masks and coverage masks are comparisons — zero-gradient
  pass-throughs, exactly as in jnp autodiff of the plane oracle, so
  gradients match ``jax.grad`` of shearwarp.plane_oracle(post) (the
  parity test).  Every matmul runs at ``Precision.HIGHEST``: a default
  f32 product may run in TF32 on the GPU, and the composite inversion
  divides by (1 − α).

The reference has no autodiff anywhere (differentiability is this
framework's north-star addition, SURVEY.md §7 stage 2); the forward
semantics being differentiated are fragRaycast.glsl:113-215's
march/classify/composite loop.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np

from libre.ops import shearwarp_bricked as swb
from libre.ops.reference import ALPHA_CLAMP
from libre.ops.shearwarp_bricked import TF_SIZE

HP = jax.lax.Precision.HIGHEST


def _plane_geometry(
    vs, k_planes, na, nc, nb, v_size, u_size, bounds,
    *, k_total=None, na_store=None,
):
    """Device-side per-plane tables + interpolation scalars for the
    backward recompute — the march's own tables
    (shearwarp_bricked.plane_operands), so the recompute sees the
    forward's exact sample set, slab mode included (a 13-float ``vs``
    appends [k0, a_base])."""
    wb0, wb1, wc0, wc1 = bounds
    planes_i, planes_f, view = swb.plane_operands(
        vs, k_planes=k_planes, na_real=na,
        na_store=na_store if na_store is not None else na, k_total=k_total,
    )
    ug = view[0] + view[1] * jnp.arange(u_size, dtype=jnp.float32)
    vg = view[3] + view[2] * jnp.arange(v_size, dtype=jnp.float32)
    length = jnp.sqrt(1.0 + ug[None, :] ** 2 + vg[:, None] ** 2)
    return dict(
        a0=planes_i[:, 0], a1=planes_i[:, 1], wa=planes_f[:, 0],
        dl=planes_f[:, 1], corr=view[7] * length,  # (V, U)
        eb=view[4], ec=view[5], ug=ug, vg=vg,
        sb_scale=nb / (wb1 - wb0), sc_scale=nc / (wc1 - wc0),
    )


def _interp_mats(geo, dl_c, nb, nc, bounds):
    """Batched (Kc, ·, ·) in-plane two-tap interpolation matrices for a
    plane chunk: the march's gathered taps written as matrices, whose
    transposes carry the density gradient."""
    wb0, wb1, wc0, wc1 = bounds

    def two_tap(x, lo, hi, scale, n):
        inside = ((x >= lo) & (x < hi)).astype(jnp.float32)
        s = jnp.clip((x - lo) * scale - 0.5, -0.5, n - 0.5)
        i0 = jnp.floor(jnp.clip(s, 0.0, float(n - 1)))
        w = jnp.clip(s - i0, 0.0, 1.0)
        i1 = jnp.minimum(i0 + 1.0, float(n - 1))
        rows = jnp.arange(n, dtype=jnp.float32)
        # (Kc, n, X): rows along the new axis
        m = (
            (rows[None, :, None] == i0[:, None, :]) * (1.0 - w)[:, None, :]
            + (rows[None, :, None] == i1[:, None, :]) * w[:, None, :]
        )
        return m * inside[:, None, :]

    xb = geo["eb"] + geo["ug"][None, :] * dl_c[:, None]  # (Kc, U)
    mb = two_tap(xb, wb0, wb1, geo["sb_scale"], nb)
    xc = geo["ec"] + geo["vg"][None, :] * dl_c[:, None]  # (Kc, V)
    mct = two_tap(xc, wc0, wc1, geo["sc_scale"], nc)
    # mb: (Kc, Nb, U); mct: (Kc, Nc, V) -> transpose to (Kc, V, Nc)
    return mb, jnp.swapaxes(mct, 1, 2)


def _chunk_forward(store, tf, geo, sl, mb, mct):
    """Recompute one chunk's planes: density, rgba, opacity-corrected
    alpha (pre early-exit) — shared by both backward phases."""
    a0_c = geo["a0"][sl]
    a1_c = geo["a1"][sl]
    wa_c = geo["wa"][sl]
    lo = jnp.take(store, a0_c, axis=0)
    hi = jnp.take(store, a1_c, axis=0)
    vs = lo * (1.0 - wa_c)[:, None, None] + hi * wa_c[:, None, None]
    s1 = jnp.einsum("kcb,kbu->kcu", vs, mb, precision=HP)
    dens = jnp.einsum("kvc,kcu->kvu", mct, s1, precision=HP)

    inside_u = (jnp.abs(mb).sum(axis=1) > 0).astype(jnp.float32)  # (Kc,Up)
    inside_v = (jnp.abs(mct).sum(axis=2) > 0).astype(jnp.float32)  # (Kc,Vp)
    mask = (
        inside_v[:, :, None]
        * inside_u[:, None, :]
        * (dens > -0.5).astype(jnp.float32)
    )

    s = jnp.clip(dens, 0.0, 1.0) * TF_SIZE - 0.5
    s = jnp.clip(s, 0.0, float(TF_SIZE - 1))
    i0f = jnp.floor(s)
    wt = s - i0f
    i0 = i0f.astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, TF_SIZE - 1)
    rgba = jnp.take(tf, i0, axis=0) * (1.0 - wt)[..., None] + jnp.take(
        tf, i1, axis=0
    ) * wt[..., None]  # (Kc, Vp, Up, 4)
    a_v = rgba[..., 3] * mask
    a_clamped = jnp.minimum(a_v, ALPHA_CLAMP)
    a_corr = 1.0 - jnp.power(1.0 - a_clamped, geo["corr"][None])
    return dict(
        vs=vs, s1=s1, dens=dens, mask=mask, s=s, wt=wt, i0=i0, i1=i1,
        rgba=rgba, a_v=a_v, a_clamped=a_clamped, a_corr=a_corr,
    )


def _alpha_chain(a_corr, t_in, early_exit):
    """Intra-chunk transmittance recurrence with the march's exact
    early exit.  The per-ray mask m is applied at EVERY plane here while
    the forward march also stops a tile once all of its rays are
    saturated — both are exact, because a saturated ray has m = 0, and
    an m = 0 plane contributes nothing (and receives zero gradient)
    under either scheme."""

    def step(t, a):
        m = ((1.0 - t) <= early_exit).astype(jnp.float32)
        a_eff = a * m
        w = a_eff * t
        t_next = t * (1.0 - a_eff)
        return t_next, (a_eff, w, t)

    t_out, (a_eff, w, t_at) = jax.lax.scan(step, t_in, a_corr)
    return t_out, a_eff, w, t_at


def _tf_scatter(i0, i1, wt, drgba, chunk=1 << 19):
    """dtf via a rank-16 ⊗ rank-16 decomposition of the one-hot scatter.

    Write the TF index as idx = 16·hi + lo; then
    ``dtf[16·hi+lo, c] = Σ_s Ehi[s, hi] · F[s, 4·lo + c]`` with
    ``F = Elo ⊗ (w·g)`` — ONE (S, 16)ᵀ·(S, 64) matmul per chunk.
    The materialized one-hot traffic drops from S×256 floats (the naive
    E·g form, which is HBM-bound at ~34 GB for a 256²×512 frame) to
    S×(16+64) — the dominant backward cost when the TF is optimized.
    Both interpolation taps ride the same stream (2S samples)."""
    flat_n = int(np.prod(i0.shape))
    # Clamp the chunk to the workload so small frames don't pad up to
    # half a million samples of redundant one-hot matmul work per call.
    chunk = min(chunk, 2 * flat_n)
    idx = jnp.concatenate([i0.reshape(-1), i1.reshape(-1)])
    w = jnp.concatenate([(1.0 - wt).reshape(-1), wt.reshape(-1)])
    g4 = drgba.reshape(-1, 4)
    g = jnp.concatenate([g4, g4])
    n = 2 * flat_n
    pad_n = -(-n // chunk) * chunk
    idx = jnp.pad(idx, (0, pad_n - n))
    w = jnp.pad(w, (0, pad_n - n))  # pad weight 0 ⇒ no contribution
    g = jnp.pad(g, ((0, pad_n - n), (0, 0)))
    cols16 = jnp.arange(16, dtype=jnp.int32)

    def body(args):
        ic, wc, gc = args
        ehi = (cols16[None, :] == (ic >> 4)[:, None]).astype(jnp.float32)
        elo = (cols16[None, :] == (ic & 15)[:, None]).astype(jnp.float32)
        f = ((elo * wc[:, None])[:, :, None] * gc[:, None, :]).reshape(
            -1, 64
        )
        return jax.lax.dot_general(
            ehi, f, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=HP,
        )  # (16, 64) = dtf[16·hi+lo, c] tiles

    parts = jax.lax.map(
        body,
        (idx.reshape(-1, chunk), w.reshape(-1, chunk),
         g.reshape(-1, chunk, 4)),
    )
    return parts.sum(axis=0).reshape(TF_SIZE, 4)


@functools.lru_cache(maxsize=64)
def _compiled_bwd(
    *,
    na_store: int,
    na_real: int,
    nc_real: int,
    nb_real: int,
    k_planes: int,
    v_size: int,
    u_size: int,
    wb0: float,
    wb1: float,
    wc0: float,
    wc1: float,
    early_exit: float,
    kc: int,
    diff_tf: bool,
    k_total: int = None,
):
    n_chunks = -(-k_planes // kc)
    k_pad = n_chunks * kc
    bounds = (wb0, wb1, wc0, wc1)

    @jax.jit
    def bwd(store, tf, vs, out, t_final, g):
        geo = _plane_geometry(
            vs, k_planes, na_real, nc_real, nb_real, v_size, u_size, bounds,
            k_total=k_total, na_store=na_store,
        )
        # Pad the plane tables to whole chunks; the padding planes are
        # computed like real ones and zeroed by a (K,) validity mask.
        valid_k = (
            jnp.arange(k_pad, dtype=jnp.int32) < k_planes
        ).astype(jnp.float32)

        def padk(x):
            return jnp.pad(x, (0, k_pad - k_planes))

        geo = dict(
            geo,
            a0=padk(geo["a0"]),
            a1=padk(geo["a1"]),
            wa=padk(geo["wa"]),
            dl=padk(geo["dl"]),
        )

        gr = g[..., :3]  # (V, U, 3) cotangent on the slope grid
        ga = g[..., 3]
        tot = jnp.einsum("vuc,vuc->vu", gr, out[..., :3], precision=HP)
        t_k_final = t_final  # (V, U) from the forward march

        # ---- phase A: per-chunk carry boundaries (t, prefix P) ----
        def phase_a(t_in, ci):
            sl = jax.lax.dynamic_slice_in_dim(
                jnp.arange(k_pad), ci * kc, kc
            )
            mb, mct = _interp_mats(geo, geo["dl"][sl], nb_real, nc_real, bounds)
            fwd = _chunk_forward(store, tf, geo, sl, mb, mct)
            a_corr = fwd["a_corr"] * valid_k[sl][:, None, None]
            t_out, a_eff, w, _t_at = _alpha_chain(a_corr, t_in, early_exit)
            d_k = jnp.einsum(
                "kvuc,vuc->kvu", fwd["rgba"][..., :3], gr, precision=HP
            )
            q_c = jnp.einsum("kvu,kvu->vu", w, d_k, precision=HP)
            return t_out, (t_in, q_c)

        t_end, (t_bounds, q_chunks) = jax.lax.scan(
            phase_a, jnp.ones((v_size, u_size), jnp.float32),
            jnp.arange(n_chunks),
        )
        # Exclusive prefix of chunk sums → P boundary per chunk.
        p_bounds = jnp.concatenate(
            [
                jnp.zeros((1, v_size, u_size), jnp.float32),
                jnp.cumsum(q_chunks, axis=0)[:-1],
            ]
        )

        # ---- phase B: distribute gradients per chunk ----
        def phase_b(carry, args):
            d_store, dtf = carry
            ci, t_in, p_in = args
            sl = jax.lax.dynamic_slice_in_dim(
                jnp.arange(k_pad), ci * kc, kc
            )
            dl_c = geo["dl"][sl]
            mb, mct = _interp_mats(geo, dl_c, nb_real, nc_real, bounds)
            fwd = _chunk_forward(store, tf, geo, sl, mb, mct)
            a_corr = fwd["a_corr"] * valid_k[sl][:, None, None]
            _t_out, a_eff, w, t_at = _alpha_chain(
                a_corr, t_in, early_exit
            )
            d_k = jnp.einsum(
                "kvuc,vuc->kvu", fwd["rgba"][..., :3], gr, precision=HP
            )
            q = w * d_k
            p_incl = p_in[None] + jnp.cumsum(q, axis=0)  # inclusive
            one_m_a = jnp.maximum(1.0 - a_eff, 1e-12)
            da_eff = (
                t_at * d_k
                - (tot[None] - p_incl) / one_m_a
                + ga[None] * t_k_final[None] / one_m_a
            )
            # a_eff = m·a_corr_valid; m and valid are constants.
            m = ((1.0 - t_at) <= early_exit).astype(jnp.float32)
            da_corr = da_eff * m * valid_k[sl][:, None, None]
            # a_corr = 1 − (1 − a_cl)^corr
            da_cl = (
                da_corr
                * geo["corr"][None]
                * jnp.power(
                    jnp.maximum(1.0 - fwd["a_clamped"], 1e-12),
                    geo["corr"][None] - 1.0,
                )
            )
            da_v = da_cl * (fwd["a_v"] < ALPHA_CLAMP).astype(jnp.float32)
            drgba = jnp.concatenate(
                [
                    (w * 1.0)[..., None] * gr[None],
                    (da_v * fwd["mask"])[..., None],
                ],
                axis=-1,
            )  # (Kc, Vp, Up, 4)
            # TF gradient (one-hot matmul scatter); skipped when the TF is
            # frozen (volume-only optimization) — the dominant backward
            # cost at large K·V·U.
            if diff_tf:
                dtf = dtf + _tf_scatter(
                    fwd["i0"], fwd["i1"], fwd["wt"], drgba
                )
            # density gradient through the two-tap lookup
            tf_d = jnp.take(tf, fwd["i1"], axis=0) - jnp.take(
                tf, fwd["i0"], axis=0
            )
            ds_ddens = (
                TF_SIZE
                * ((fwd["dens"] > 0.0) & (fwd["dens"] < 1.0)).astype(
                    jnp.float32
                )
                * (
                    (fwd["s"] > 0.0) & (fwd["s"] < float(TF_SIZE - 1))
                ).astype(jnp.float32)
            )
            ddens = (
                jnp.einsum("kvuc,kvuc->kvu", drgba, tf_d, precision=HP)
                * ds_ddens
            )
            # transpose resampling matmuls
            ds1 = jnp.einsum("kvc,kvu->kcu", mct, ddens, precision=HP)
            dvs = jnp.einsum("kcu,kbu->kcb", ds1, mb, precision=HP)
            # axis-lerp transpose: accumulate into store slices via ONE
            # (Na, Kc) @ (Kc, Nc·Nb) matmul
            wa_c = geo["wa"][sl]
            rows = jnp.arange(na_store, dtype=jnp.int32)
            wmat = (
                (rows[:, None] == geo["a0"][sl][None, :])
                * (1.0 - wa_c)[None, :]
                + (rows[:, None] == geo["a1"][sl][None, :])
                * wa_c[None, :]
            ) * valid_k[sl][None, :]
            d_store = d_store + jnp.einsum(
                "nk,kcb->ncb", wmat, dvs, precision=HP
            )
            return (d_store, dtf), None

        d_store0 = jnp.zeros((na_store, nc_real, nb_real), jnp.float32)
        dtf0 = jnp.zeros((TF_SIZE, 4), jnp.float32)
        (d_store, dtf), _ = jax.lax.scan(
            phase_b,
            (d_store0, dtf0),
            (jnp.arange(n_chunks), t_bounds, p_bounds),
        )
        return d_store, dtf

    return bwd


class _StaticView(dict):
    """Hashable static view/geometry bundle for custom_vjp nondiff args."""

    def __hash__(self):
        return hash(tuple(sorted(self.items())))

    def __eq__(self, other):
        return isinstance(other, dict) and dict.__eq__(self, other)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def render_store_grid_diff(store, tf, vs, static):
    """Differentiable slope-grid render from a (Na, Nc, Nb) normalized
    density store and a (256, 4) TF → (V, U, 4).

    ``vs`` is the 11-float view vector
    [wa0, wa1, eye_a, u0, du, dv, eb, ec, v0, sign, msr] (see
    :func:`view_vector`); ``static`` a _StaticView of the compile-time
    geometry (from :func:`static_view`)."""
    out, _t = _forward(store, tf, vs, static)
    return out


def _forward(store, tf, vs, static):
    """(V, U, 4) image and (V, U) final transmittance."""
    run = swb._compiled_store_frame(
        march=swb.default_march(),
        geom=swb.MarchGeometry(
            nc=static["nc_real"], nb=static["nb_real"],
            wb0=static["wb0"], wb1=static["wb1"],
            wc0=static["wc0"], wc1=static["wc1"],
            early_exit=static["early_exit"], n_clip=0,
        ),
        na_store=static["na_store"],
        na_real=static["na_real"],
        k_planes=static["k_planes"],
        v_size=static["v_size"],
        u_size=static["u_size"],
        with_content=False,
        axis=0,
        viewport=None,
        emit_transmittance=True,
        k_total=static.get("k_total"),
        vs_len=int(vs.shape[0]),
    )
    clip = jnp.zeros((swb.MAX_CLIP, 4), jnp.float32)
    content = jnp.zeros((1,), jnp.int32)
    return run(store, tf, vs, clip, content)


def _fwd(store, tf, vs, static):
    inter, t_final = _forward(store, tf, vs, static)
    return inter, (store, tf, vs, inter, t_final)


def _bwd(static, res, g):
    store, tf, vs, inter, t_final = res
    bwd = _compiled_bwd(
        na_store=static["na_store"],
        na_real=static["na_real"],
        nc_real=static["nc_real"],
        nb_real=static["nb_real"],
        k_planes=static["k_planes"],
        v_size=static["v_size"],
        u_size=static["u_size"],
        wb0=static["wb0"],
        wb1=static["wb1"],
        wc0=static["wc0"],
        wc1=static["wc1"],
        early_exit=static["early_exit"],
        kc=static["kc"],
        diff_tf=static["diff_tf"],
        k_total=static.get("k_total"),
    )
    d_store, dtf = bwd(store, tf, vs, inter, t_final, g)
    return d_store, dtf, None


render_store_grid_diff.defvjp(_fwd, _bwd)


def static_view(
    *,
    na_store: int,
    na_real: int,
    nc_real: int,
    nb_real: int,
    k_planes: int,
    v_size: int,
    u_size: int,
    world_min,
    world_max,
    axis: int,
    early_exit: float,
    kc: int = 32,
    diff_tf: bool = True,
    k_total: int = None,  # slab mode: GLOBAL plane count (vs 13 floats)
) -> _StaticView:
    from libre.ops import shearwarp as sw

    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    b_axis, c_axis = sw._BC_AXES[axis]
    return _StaticView(
        na_store=na_store,
        na_real=na_real,
        nc_real=nc_real,
        nb_real=nb_real,
        k_planes=k_planes,
        v_size=v_size,
        u_size=u_size,
        wb0=float(wmin[b_axis]),
        wb1=float(wmax[b_axis]),
        wc0=float(wmin[c_axis]),
        wc1=float(wmax[c_axis]),
        early_exit=float(early_exit),
        kc=int(kc),
        diff_tf=bool(diff_tf),
        k_total=None if k_total is None else int(k_total),
    )


# The 11-float view vector of render_store_grid_diff.
view_vector = swb.view_vector
