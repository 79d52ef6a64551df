"""What the program decides from its platform: the compute path per scene,
where the compile cache lives, and that the GPU smoke test refuses to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from torrey.ops.megakernel import MEGAKERNEL_MAX_PRIMS
from torrey.render.renderer import render_mode
from torrey.utils import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,prims,mode", [
    ("gpu", 4, "megakernel"),                       # scene1
    ("gpu", 36, "megakernel"),                      # cbox
    ("gpu", MEGAKERNEL_MAX_PRIMS, "megakernel"),
    ("gpu", MEGAKERNEL_MAX_PRIMS + 1, "xla"),
    ("gpu", 144046, "xla"),                         # bunny stand-in
    ("cpu", 36, "xla"),                             # the test platform
    ("cpu", 144046, "xla"),
])
def test_render_mode(platform, prims, mode):
    assert render_mode(prims, platform) == mode


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_compile_cache_in_checkout_by_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert config.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")
    calls = _record_updates(monkeypatch)
    config.setup_jax()
    assert calls["jax_compilation_cache_dir"] == os.path.join(ROOT,
                                                              ".jax_cache")


def test_compile_cache_left_to_jax_when_variable_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() is None
    calls = _record_updates(monkeypatch)
    config.setup_jax()
    assert "jax_compilation_cache_dir" not in calls


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_gpu():
    proc = _run_smoke(ROOT, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_needs_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
