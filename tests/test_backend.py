"""libre.backend: the one module that looks at the platform, and owns
the compile cache; and chip_smoke.py's refusal to run without a GPU."""

import inspect
import os
import pathlib
import shutil
import subprocess
import sys
import types

import jax
import pytest

from libre import backend
from libre.ops import shearwarp_bricked as swb
from libre.ops import shearwarp_grad as swg
from libre.train import store_trainer as st

REPO = pathlib.Path(__file__).resolve().parent.parent


def fake_platform(monkeypatch, name):
    dev = types.SimpleNamespace(platform=name)
    monkeypatch.setattr(backend.jax, "devices", lambda *a: [dev])


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_platform_supported(monkeypatch, name):
    fake_platform(monkeypatch, name)
    assert backend.platform() == name
    assert backend.use_gpu_kernels() is (name == "gpu")


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_platform_other_raises(monkeypatch, name):
    """No interpreter fallback and no silent switch to the CPU."""
    fake_platform(monkeypatch, name)
    with pytest.raises(ValueError, match="unsupported JAX platform"):
        backend.platform()


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_default_march_follows_platform(monkeypatch, name):
    fake_platform(monkeypatch, name)
    want = swb.march_kernel if name == "gpu" else swb.march_xla
    assert swb.default_march() is want


def test_interpret_only_when_asked():
    """Interpret mode is an explicit argument of the kernel wrapper only,
    off by default, and no field of the trainers' or engine's options."""
    sig = inspect.signature(swb.march_kernel)
    assert sig.parameters["interpret"].default is False
    assert "interpret" not in inspect.signature(swg.static_view).parameters
    fields = st.StoreProblem.__dataclass_fields__
    assert "interpret" not in fields


def test_no_platform_checks_outside_backend():
    """Only libre/backend.py reads the platform, and no module picks
    interpret mode for itself."""
    offenders = []
    for path in (REPO / "libre").rglob("*.py"):
        if path.name == "backend.py":
            continue
        text = path.read_text()
        for needle in (".platform", "interpret = "):
            if needle in text:
                offenders.append(f"{path.relative_to(REPO)}: {needle}")
    assert offenders == []


def test_compile_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_inside_checkout(monkeypatch):
    """Without the variable: a fixed directory inside the checkout that
    git ignores — never a temporary name, a PID or a time."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = pathlib.Path(backend.compile_cache_dir())
    assert path == REPO / ".jax_cache"
    assert backend.compile_cache_dir() == str(path)  # stable
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_setup_compile_cache_points_jax_there(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert backend.setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    out = run_smoke(REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_program(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
