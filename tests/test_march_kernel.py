"""The bricked plane march (ops/shearwarp_bricked.py): the Pallas-Triton
kernel, run here in the Pallas interpreter, against the plane oracle
(ops/shearwarp.plane_oracle, post-classification, SENTINEL coverage
mask) and against the plain-XLA march on the same operands.

The compiled kernel needs an NVIDIA card: ``test_compiled_kernel_*``
carries the ``gpu`` marker and skips here; ``python chip_smoke.py`` runs
the same comparison on the card at full size."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libre.ops import shearwarp as sw
from libre.ops import shearwarp_bricked as swb
from libre.ops import transfer_function as tf_ops
from libre.ops.reference import RenderParams

GMIN = np.float32([-0.5] * 3)
GMAX = np.float32([0.5] * 3)
BOUNDS = (-0.42, 0.38, -0.4, 0.36)
K = 24
SHAPE_ZYX = (10, 12, 14)  # distinct extents catch axis mix-ups
PARAMS = RenderParams(
    n_samples_per_ray=K, data_source_range=(0.0, 1.0),
    filter_mode="trilinear",
)
KERNEL = functools.partial(swb.march_kernel, interpret=True)
ATOL = 2e-5  # f32, same sample set; only the sum order differs


def make_volume(seed=0):
    rng = np.random.default_rng(seed)
    vol = rng.random(SHAPE_ZYX).astype(np.float32)
    for ax in range(3):
        vol = (vol + np.roll(vol, 1, ax) + np.roll(vol, -1, ax)) / 3.0
    return vol


def eye_for(axis, sign):
    """An eye on the -sign side of the major axis, slightly off-center."""
    eye = np.float32([0.07, -0.05, 0.04])
    eye[axis] = -1.4 * sign
    return eye


def view(axis, sign, inter_size, eye=None):
    return swb.view_vector(
        world_min=GMIN, world_max=GMAX, axis=axis,
        eye=eye_for(axis, sign) if eye is None else eye, sign=sign,
        slope_bounds=BOUNDS, inter_size=inter_size,
        max_samples_per_ray=PARAMS.max_samples_per_ray,
    )


def march(fn, volume, tf, *, axis, sign, inter_size=(12, 20), clip=None,
          carry=None, k0=None, k_planes=K, content=None, early_exit=None,
          eye=None):
    """(V, U, 4) slope grid of ``fn`` (a march) over ``volume`` (Z, Y, X)."""
    store = jnp.asarray(np.transpose(volume, sw._PERM[axis]))
    na, nc, nb = store.shape
    vs = view(axis, sign, inter_size, eye)
    kw = {}
    if k0 is not None:  # slab mode: planes k0 … k0+k_planes of K
        vs = np.concatenate([vs, np.float32([k0, 0.0])])
        kw["k_total"] = K
    planes_i, planes_f, view_ops = swb.plane_operands(
        jnp.asarray(vs), k_planes=k_planes, na_real=na, na_store=na,
        content=content, **kw,
    )
    clip_m, n_clip = swb.clip_matrix(clip, axis)
    geom = swb.march_geometry(
        nc=nc, nb=nb, world_min=GMIN, world_max=GMAX, axis=axis,
        early_exit=PARAMS.early_exit if early_exit is None else early_exit,
        n_clip=n_clip,
    )
    if carry is None:
        carry = swb.initial_carry(*inter_size)
    return fn(
        store, planes_i, planes_f, view_ops, jnp.asarray(tf),
        jnp.asarray(clip_m), carry, geom=geom,
    )


def oracle(volume, tf, *, axis, sign, inter_size=(12, 20), clip=None,
           eye=None):
    v_size, u_size = inter_size
    vs = view(axis, sign, inter_size, eye)
    u = vs[3] + vs[4] * np.arange(u_size, dtype=np.float32)
    v = vs[8] + vs[5] * np.arange(v_size, dtype=np.float32)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    out = sw.plane_oracle(
        jnp.asarray(volume), jnp.asarray(tf),
        eye_for(axis, sign) if eye is None else eye, axis, sign,
        (jnp.asarray(uu.reshape(-1)), jnp.asarray(vv.reshape(-1))),
        GMIN, GMAX, PARAMS, K, classification="post",
        clip_planes_world=clip, sentinel_mask=True,
    )
    return np.asarray(out).reshape(v_size, u_size, 4)


def grid(carry):
    return np.asarray(swb.carry_to_rgba(carry))


TF = np.asarray(tf_ops.default_color_map(256))


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_matches_oracle(axis, sign):
    vol = make_volume(axis)
    got = grid(march(KERNEL, vol, TF, axis=axis, sign=sign))
    want = oracle(vol, TF, axis=axis, sign=sign)
    assert want[..., 3].max() > 0.1  # the view sees the volume
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_kernel_clip_planes():
    vol = make_volume(3)
    clip = np.float32([[1.0, 0.0, 0.0, 0.1], [0.0, -1.0, 0.5, 0.2]])
    got = grid(march(KERNEL, vol, TF, axis=2, sign=1.0, clip=clip))
    want = oracle(vol, TF, axis=2, sign=1.0, clip=clip)
    np.testing.assert_allclose(got, want, atol=ATOL)
    unclipped = oracle(vol, TF, axis=2, sign=1.0)
    assert np.abs(want - unclipped).max() > 1e-2  # the clip removes samples


def test_kernel_saturated_early_exit():
    """An opaque TF saturates every ray well before the last plane: the
    tiles stop early and still equal the oracle and the XLA march."""
    vol = make_volume(4)
    tf = np.clip(TF * 8.0, 0.0, 1.0)
    got = grid(march(KERNEL, vol, tf, axis=1, sign=-1.0))
    want = oracle(vol, tf, axis=1, sign=-1.0)
    assert want[..., 3].max() > PARAMS.early_exit
    np.testing.assert_allclose(got, want, atol=ATOL)
    xla = grid(march(swb.march_xla, vol, tf, axis=1, sign=-1.0))
    np.testing.assert_allclose(got, xla, atol=1e-6)


def test_kernel_slab_carry_composes():
    """Two passes over the two halves of the plane grid, the carry
    threaded through, equal one pass over all planes (A-slab
    multipass)."""
    vol = make_volume(5)
    whole = march(KERNEL, vol, TF, axis=0, sign=1.0)
    half = K // 2
    first = march(KERNEL, vol, TF, axis=0, sign=1.0, k0=0, k_planes=half)
    both = march(
        KERNEL, vol, TF, axis=0, sign=1.0, k0=half, k_planes=K - half,
        carry=first,
    )
    np.testing.assert_array_equal(np.asarray(both), np.asarray(whole))


def test_kernel_sentinel_coverage():
    """Uncovered voxels (SENTINEL) drop the samples that touch them."""
    vol = make_volume(6)
    vol[:, :5, :] = swb.SENTINEL
    vol[7:, :, 9:] = swb.SENTINEL
    got = grid(march(KERNEL, vol, TF, axis=2, sign=-1.0))
    want = oracle(vol, TF, axis=2, sign=-1.0)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (want[..., 3] == 0).any() and (want[..., 3] > 0.1).any()


def test_kernel_tf_edit():
    """The TF is a runtime operand: an edited table re-renders through
    the same kernel and matches the oracle under the new table."""
    vol = make_volume(7)
    edited = np.roll(TF, 40, axis=0)
    edited[:, 3] = np.clip(edited[:, 3] * 1.5, 0.0, 1.0)
    before = grid(march(KERNEL, vol, TF, axis=2, sign=1.0))
    after = grid(march(KERNEL, vol, edited, axis=2, sign=1.0))
    np.testing.assert_allclose(
        after, oracle(vol, edited, axis=2, sign=1.0), atol=ATOL
    )
    assert np.abs(after - before).max() > 1e-2


@pytest.mark.parametrize("inter_size", [(2, 3), (17, 65), (33, 7)])
def test_kernel_viewport_not_whole_tiles(inter_size):
    """Viewports that are not a multiple of the kernel tile: the padded
    rays are cut away and never hold a tile open."""
    assert inter_size[0] % swb.TILE[0] or inter_size[1] % swb.TILE[1]
    vol = make_volume(8)
    got = march(KERNEL, vol, TF, axis=2, sign=-1.0, inter_size=inter_size)
    assert got.shape == (4,) + inter_size
    xla = march(swb.march_xla, vol, TF, axis=2, sign=-1.0,
                inter_size=inter_size)
    np.testing.assert_allclose(np.asarray(got), np.asarray(xla), atol=1e-6)


def test_kernel_content_skipping_exact():
    """Planes whose bracketing slices hold no resident brick are skipped;
    their composite step is the identity, so skipping is bit-exact."""
    vol = make_volume(9)
    vol[:, :, :6] = swb.SENTINEL  # with axis 0 the store's slices 0..5
    store = np.transpose(vol, sw._PERM[0])
    content = swb.store_content(jnp.asarray(store), store.shape[0])
    assert int(content.sum()) < store.shape[0]
    skipped = march(KERNEL, vol, TF, axis=0, sign=1.0, content=content)
    dense = march(KERNEL, vol, TF, axis=0, sign=1.0)
    np.testing.assert_array_equal(np.asarray(skipped), np.asarray(dense))


def test_kernel_rejects_store_beyond_int32_indices():
    big = jax.ShapeDtypeStruct((2048, 1024, 1024), jnp.float32)
    with pytest.raises(ValueError, match="int32"):
        swb.march_kernel(big, None, None, None, None, None,
                         jnp.zeros((4, 2, 2)), geom=None)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_march(gpu_device):
    vol = make_volume(10)
    with jax.default_device(gpu_device):
        got = grid(march(swb.march_kernel, vol, TF, axis=2, sign=-1.0,
                         inter_size=(40, 70)))
        want = grid(march(swb.march_xla, vol, TF, axis=2, sign=-1.0,
                          inter_size=(40, 70)))
    np.testing.assert_allclose(got, want, atol=1e-5)
