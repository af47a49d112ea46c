"""The chip smoke test's own logic, checked on the CPU: the device check,
the compile-cache choice, and the on-card checks (which skip here and run
on the card through `python chip_smoke.py`)."""

import os
import subprocess
import sys

import jax
import pytest

from corbslam import checks, compile_cache
from corbslam.config import KITTI_STEREO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(SystemExit, match="no GPU"):
        checks.require_gpu(jax.devices("cpu"))
    with pytest.raises(SystemExit, match="no GPU"):
        checks.require_gpu([])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No accelerator, or no package beside the script: a non-zero exit and
    no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("environ,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir(environ, want):
    assert compile_cache.cache_dir(environ) == want


def test_compile_cache_configure_leaves_env_choice(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.chip
def test_frontend_agrees_with_cpu_on_card(gpu):
    from corbslam.place import vocab

    checks.frontend_agreement(checks.KITTI_CAM, KITTI_STEREO.orb,
                              vocab.load_default())


@pytest.mark.chip
def test_global_ba_on_card(gpu):
    checks.gba_check(checks.KITTI_CAM, KITTI_STEREO,
                     *checks.GBA_SIZE.values())
