"""Configuration / parameters / settings / frame-utils golden tests,
mirroring the reference suites tests/core/frameUtils.cpp,
tests/lib/rendererParameters.cpp, tests/eq/settings/cameraSettings.cpp,
tests/core/signalledVariable.cpp."""

import numpy as np
import pytest

from libre.core.config import (
    ApplicationParameters,
    Configuration,
    ConfigurationError,
    RendererParameters,
)
from libre.core.frame_utils import INVALID_TIMESTEP, FrameUtils
from libre.core.settings import CameraSettings, FrameData
from libre.core.signalled import SignalledVariable


def test_configuration_parse():
    c = Configuration()
    c.add_option("alpha", "a float", 1.5)
    c.add_option("name", "a string", "x")
    c.add_option("flag", "a bool", False)
    c.add_option("pair", "two ints", None, type=int, n_args=2)
    rest = c.parse_args(
        ["--alpha", "2.5", "--flag", "--pair", "3", "4", "--unknown", "v"]
    )
    assert c.get("alpha") == 2.5
    assert c.get("flag") is True
    assert c.get("pair") == [3, 4]
    assert rest == ["--unknown", "v"]
    with pytest.raises(ConfigurationError):
        c.get("nope")


def test_configuration_file(tmp_path):
    c = Configuration()
    c.add_option("alpha", "a float", 1.5)
    c.add_option("name", "a string", "x")
    p = tmp_path / "conf.ini"
    p.write_text("alpha = 3.5  # comment\nname = hello\n")
    c.parse_file(str(p))
    assert c.get("alpha") == 3.5 and c.get("name") == "hello"


def test_renderer_parameters_defaults_and_argv():
    """Defaults from rendererParameters.fbs:3-12; argv parsing as in
    tests/lib/rendererParameters.cpp."""
    p = RendererParameters()
    assert p.screen_space_error == 4.0
    assert p.max_gpu_cache_memory_mb == 3072
    assert p.max_cpu_cache_memory_mb == 8192
    assert p.samples_per_ray == 0 and p.samples_per_pixel == 1
    assert p.min_lod == 0 and p.max_lod == 15
    assert not p.synchronous_mode

    p = RendererParameters(
        ["--sse", "1.0", "--gpu-cache-mem", "512", "--synchronous"]
    )
    assert p.screen_space_error == 1.0
    assert p.max_gpu_cache_memory_mb == 512
    assert p.synchronous_mode


def test_application_parameters():
    p = ApplicationParameters(
        [
            "--volume",
            "mem://#64,64,64,16",
            "--frames",
            "5",
            "20",
            "--camera-position",
            "1",
            "2",
            "3",
            "--animation",
        ]
    )
    assert p.data_file_name == "mem://#64,64,64,16"
    assert p.frames == (5, 20)
    assert p.camera_position == (1.0, 2.0, 3.0)
    assert p.animation == 1


def test_frame_utils():
    """tests/core/frameUtils.cpp semantics: clamping, wrap, latest mode."""
    fu = FrameUtils((5, 20), (0, 15))
    assert fu.frame_range == (5, 15)
    assert fu.get_current(0) == 5
    assert fu.get_current(50) == 14
    assert fu.get_current(0, latest_always=True) == 14
    assert fu.get_next(14, 1) == 5  # wraps to start
    assert fu.get_next(5, -1) == 14  # reverse wraps to end
    assert fu.get_next(7, 3) == 10

    invalid = FrameUtils((20, 30), (0, 10))
    assert not invalid.is_valid
    assert invalid.get_current(0) == INVALID_TIMESTEP


def test_signalled_variable():
    seen = []
    v = SignalledVariable(1, seen.append)
    v.set(2)
    v.set(3)
    assert seen == [2, 3] and v.get() == 3


def test_camera_settings_spin_move():
    """tests/eq/settings/cameraSettings.cpp behaviors: translation survives
    spin; move accumulates; lookAt builds a valid modelview."""
    cam = CameraSettings()
    cam.set_camera_position([1.0, 2.0, 3.0])
    mv0 = cam.get_modelview_matrix().copy()
    cam.spin_model(0.3, 0.2)
    mv1 = cam.get_modelview_matrix()
    np.testing.assert_allclose(mv1[:3, 3], mv0[:3, 3])  # translation kept
    assert not np.allclose(mv1[:3, :3], mv0[:3, :3])  # rotated
    # Rotation block stays orthonormal.
    r = mv1[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)

    cam.move_camera(0.5, 0.0, -0.5)
    np.testing.assert_allclose(
        cam.get_modelview_matrix()[:3, 3], mv0[:3, 3] + [0.5, 0, -0.5]
    )

    notified = []
    cam.on_changed(lambda m: notified.append(m.copy()))
    cam.set_camera_look_at([0.0, 0.0, 0.0])
    assert len(notified) == 1


def test_frame_data_pytree_roundtrip():
    fd = FrameData()
    fd.camera_settings.set_camera_position([1, 2, 3])
    fd.frame_settings.frame_number = 7
    fd.volume_settings.uri = "mem://#32,32,32,16"
    tree = fd.as_pytree()

    fd2 = FrameData()
    fd2.update_pytree(tree)
    np.testing.assert_allclose(
        fd2.camera_settings.get_modelview_matrix(),
        fd.camera_settings.get_modelview_matrix(),
    )
    assert fd2.frame_settings.frame_number == 7
    assert fd2.volume_settings.uri == "mem://#32,32,32,16"
