"""Run-time plumbing: the compile-cache helper, the native IO build, and the
GPU-only refusal of ``chip_smoke.py`` and ``bench.py``."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra=None, cwd=ROOT, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    for key in drop:
        env.pop(key, None)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=cwd)


_CACHE_PROBE = (
    "import jax\n"
    "from opticalflow_ri.compile import configure_compile_cache\n"
    "print(configure_compile_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def test_compile_cache_honours_env(tmp_path):
    out = _run(["-c", _CACHE_PROBE],
               {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_compile_cache_defaults_to_fixed_checkout_dir():
    from opticalflow_ri.compile import DEFAULT_COMPILE_CACHE_DIR

    out = _run(["-c", _CACHE_PROBE], drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [DEFAULT_COMPILE_CACHE_DIR] * 2
    assert DEFAULT_COMPILE_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    ignored = subprocess.run(
        ["git", "check-ignore", "-q",
         os.path.join(DEFAULT_COMPILE_CACHE_DIR, "entry")], cwd=ROOT)
    assert ignored.returncode == 0, ".jax_cache/ must be git-ignored"


def test_native_lib_builds_from_source_into_ignored_dir(tmp_path):
    import ctypes

    if shutil.which("g++") is None:
        pytest.skip("needs g++")

    from opticalflow_ri.utils import native

    assert native.LIB_PATH == os.path.join(ROOT, "build", "native",
                                           "libofri_io.so")
    rel = os.path.relpath(native.LIB_PATH, ROOT)
    ignored = subprocess.run(["git", "check-ignore", "-q", rel], cwd=ROOT)
    assert ignored.returncode == 0, "the native build dir must be ignored"
    out = tmp_path / "libofri_io.so"
    native.build_library(str(out))
    assert ctypes.CDLL(str(out)).ofri_save_flow is not None
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_refuse_cpu(script):
    out = _run([os.path.join(ROOT, script)])
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout and '"metric"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot run."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
               drop=("PYTHONPATH",))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_needs_no_pillow():
    """The machine with the card may lack Pillow: the main path and
    chip_smoke.py import nothing that needs it."""
    probe = (
        "import sys\n"
        "sys.modules['PIL'] = None  # any import of PIL now raises\n"
        "import chip_smoke\n"
        "import opticalflow_ri.utils.envcheck as e\n"
        "assert e.report()['pillow'] is None\n"
        "print('NO_PIL_OK')\n"
    )
    out = _run(["-c", probe])
    assert out.returncode == 0, out.stderr
    assert "NO_PIL_OK" in out.stdout
