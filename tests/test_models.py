"""VolumeScene model: parameter pytree round-trip, single-device vs
sharded render parity, and gradient flow through the scene parameters."""

import jax
import jax.numpy as jnp
import numpy as np

from libre.models import VolumeScene
from libre.ops.reference import RenderParams
from libre.parallel import make_mesh
from tests.test_reference_marcher import CAMERA, make_volume

PARAMS = RenderParams(
    n_samples_per_ray=32, data_source_range=(0.0, 1.0), filter_mode="trilinear"
)


def test_parameters_roundtrip():
    scene = VolumeScene.from_volume(make_volume(16), params=PARAMS)
    p = scene.parameters
    assert set(p) == {"density", "tf"}
    p2 = {"density": p["density"] * 2.0, "tf": p["tf"] * 0.5}
    scene2 = scene.with_parameters(p2)
    np.testing.assert_allclose(
        np.asarray(scene2.bricks.data), np.asarray(p["density"]) * 2.0
    )


def test_render_and_sharded_parity():
    scene = VolumeScene.from_volume(make_volume(16, seed=2), params=PARAMS)
    img = scene.render(CAMERA)
    assert img.shape == (24, 24, 4)
    mesh = make_mesh(n_brick=1)
    img_sharded = scene.render_sharded(mesh, CAMERA)
    np.testing.assert_allclose(
        np.asarray(img_sharded), np.asarray(img), atol=1e-5
    )


def test_gradient_through_scene():
    scene = VolumeScene.from_volume(make_volume(16, seed=4), params=PARAMS)

    def loss(params):
        img = scene.with_parameters(params).render(CAMERA)
        return jnp.mean(img ** 2)

    grads = jax.grad(loss)(scene.parameters)
    assert float(jnp.abs(grads["density"]).sum()) > 0
    assert float(jnp.abs(grads["tf"]).sum()) > 0
