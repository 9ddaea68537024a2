"""The over operator on partial ray segments, and ordered reductions.

Front-to-back emission-absorption compositing is associative: two adjacent
ray segments with premultiplied (rgb, a) states compose as

    over((rgb_f, a_f), (rgb_b, a_b)) = (rgb_f + (1-a_f)·rgb_b,
                                        a_f  + (1-a_f)·a_b)

— the exact operation eq::Compositor::blendFrames performs on the
view-ordered partial images of a DB (sort-last) decomposition
(livre/eq/Channel.cpp:444-533, orderFrames :535-586).  Associativity is
what lets ray segments be marched independently per device and reduced
along a mesh axis, structurally identical to blockwise/ring-attention
partial-state combination (SURVEY.md §5.7).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Segment = Tuple[jnp.ndarray, jnp.ndarray]  # rgb (..., 3), a (...)


def over(front: Segment, back: Segment) -> Segment:
    """Compose two ray segments, ``front`` nearer to the eye."""
    rgb_f, a_f = front
    rgb_b, a_b = back
    t = 1.0 - a_f
    return rgb_f + t[..., None] * rgb_b, a_f + t * a_b


def fold_over(rgb_parts: jnp.ndarray, a_parts: jnp.ndarray) -> Segment:
    """Fold (D, R, 3)/(D, R) partials in index order (index 0 frontmost).

    Uses a balanced associative reduction so the depth is log D and XLA
    can fuse the small combine stages.
    """
    d = rgb_parts.shape[0]
    if d == 1:
        return rgb_parts[0], a_parts[0]
    segs = [(rgb_parts[i], a_parts[i]) for i in range(d)]
    while len(segs) > 1:
        nxt = []
        for i in range(0, len(segs) - 1, 2):
            nxt.append(over(segs[i], segs[i + 1]))
        if len(segs) % 2:
            nxt.append(segs[-1])
        segs = nxt
    return segs[0]


def _pshift(x: jnp.ndarray, axis_name: str, shift: int, d: int, fill):
    """Receive ``x`` from device i - shift along the axis (devices with
    no source get ``fill`` — ppermute zero-fills unmatched targets, so
    an identity element must be patched in for products)."""
    perm = [(i, i + shift) for i in range(d - shift)]
    got = jax.lax.ppermute(x, axis_name, perm)
    flag = jax.lax.ppermute(jnp.ones((), x.dtype), axis_name, perm)
    return got + (1.0 - flag) * fill


def composite_along_axis(
    rgb: jnp.ndarray, a: jnp.ndarray, axis_name: str
) -> Segment:
    """Ordered over-reduce of per-device partial segments along a mesh axis.

    Must be called inside shard_map with ``axis_name`` mapped.  Device i's
    segment is assumed frontmost for the lowest axis index (the caller
    assigns brick ranges in front-to-back order, the analog of
    Channel::orderFrames' view-dependent frame ordering).  The result is
    replicated along the axis.

    O(R·log D) per device: the over operator factors through the
    per-device transmittance prefix product,

        rgb_out = Σ_i P_i · rgb_i,   1 - a_out = Π_i t_i,
        P_i = Π_{j<i} t_j,  t_j = 1 - a_j,

    so the reduce is a log-step ppermute prefix scan of t (Hillis-
    Steele) followed by TWO psums of premultiplied terms (the alpha psum
    uses the telescoping identity Σ P_i·a_i = 1 - Π t).  An
    eq-Compositor-style gather (all_gather + fold) moves O(D·R) bytes
    per device; this moves O(R·log D) and reduces on the wire — the
    form that scales to large meshes.
    """
    d = jax.lax.axis_size(axis_name)
    t = 1.0 - a
    # Inclusive prefix product of t along the axis.
    incl = t
    shift = 1
    while shift < d:
        incl = incl * _pshift(incl, axis_name, shift, d, 1.0)
        shift *= 2
    excl = _pshift(incl, axis_name, 1, d, 1.0)
    rgb_out = jax.lax.psum(excl[..., None] * rgb, axis_name)
    a_out = jax.lax.psum(excl * a, axis_name)
    return rgb_out, a_out


def composite_along_axis_gather(
    rgb: jnp.ndarray, a: jnp.ndarray, axis_name: str
) -> Segment:
    """Reference implementation: all_gather + log-depth fold (O(D·R))."""
    rgb_parts = jax.lax.all_gather(rgb, axis_name)  # (D, R, 3)
    a_parts = jax.lax.all_gather(a, axis_name)  # (D, R)
    return fold_over(rgb_parts, a_parts)


def composite_direct_send(
    rgb: jnp.ndarray, a: jnp.ndarray, axis_name: str
) -> Segment:
    """Tile-owned ordered composite: ONE all_to_all, O(R) on the wire.

    Direct-send sort-last compositing (the scheme Equalizer's DB
    compositing approximates with per-channel readbacks,
    Channel.cpp:444-533): the leading (ray) axis is split into D
    subtiles, device i OWNS subtile i; every device sends each
    segment-subtile to its owner in one all_to_all (4·R·(D−1)/D bytes
    per device — vs (8 + log D)·R for the replicated psum form,
    VERDICT r4 weak 4), and the owner folds its D received segments in
    rank (march) order locally.

    Returns each device's OWNED (R/D, ...) tile — NOT replicated along
    the axis; reassemble with an out_spec that shards the ray dimension
    by ``axis_name`` (minor to any sort-first ray axis).  Requires
    ``rgb.shape[0] % D == 0``.
    """
    d = jax.lax.axis_size(axis_name)
    n = rgb.shape[0]
    if n % d:
        raise ValueError(f"ray tile {n} must divide the axis size {d}")
    rgba = jnp.concatenate([rgb, a[..., None]], axis=-1)  # (n, ..., 4)
    # Block s of the leading axis is the subtile owned by device s;
    # tiled all_to_all swaps: received block j = segment j's values at
    # MY subtile, in rank order — exactly the fold order.
    recv = jax.lax.all_to_all(
        rgba, axis_name, split_axis=0, concat_axis=0, tiled=True
    )
    segs = recv.reshape((d, n // d) + rgba.shape[1:])
    rgb_t, a_t = fold_over(segs[..., :3], segs[..., 3])
    return rgb_t, a_t
