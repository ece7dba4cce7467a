"""Device-path setup (utils/device): the compile-cache rule and the
``--device`` CLIs naming the device they run on, with no host
fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest

from minnow_tpu.formats import minh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_minh(path):
    cols = [minh.Column(type=minh.Int),
            minh.Column(type=minh.Float, low=0.0, high=250.0, dx=0.001)]
    w = minh.create(path)
    w.header(["id", "x"], "device test", cols)
    w.geometry(250.0, 0, 0)
    w.block([np.arange(100, dtype=np.int64),
             np.linspace(0, 249, 100).astype(np.float32)])
    w.close()


def _cpu_env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    return env


def test_compile_cache_threshold_is_zero(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache goes to
    <checkout>/.jax_cache with no minimum compile time (the codec's
    many small per-width graphs each compile in under a second)."""
    import jax

    from minnow_tpu.utils import device

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        device.ensure_compile_cache()
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            REPO, ".jax_cache")
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", old_min)


def test_env_cache_dir_is_left_to_jax(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, ensure_compile_cache sets
    nothing in code."""
    import jax

    from minnow_tpu.utils import device

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        device.ensure_compile_cache()
        assert jax.config.jax_compilation_cache_dir is None
        assert jax.config.jax_persistent_cache_min_compile_time_secs \
            == old_min
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_captures_entries(tmp_path, env_set):
    """End-to-end: a BlockEncoder compile lands serialized executables
    where the rule says -- in JAX_COMPILATION_CACHE_DIR when set, else
    in <checkout>/.jax_cache.  Runs in a child so the cache config is
    fresh (with the env var the threshold is JAX's own, so the child
    lowers it the same way); the default-path case points the child at
    a copy of the package so the real checkout's cache is untouched."""
    if env_set:
        root, cache = REPO, tmp_path / "jc"
        env = _cpu_env(JAX_COMPILATION_CACHE_DIR=str(cache),
                       JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    else:
        import shutil

        root = tmp_path / "checkout"
        shutil.copytree(os.path.join(REPO, "minnow_tpu"),
                        root / "minnow_tpu",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cache = root / ".jax_cache"
        env = _cpu_env()
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np\n"
        "from minnow_tpu.parallel import BlockEncoder\n"
        "enc = BlockEncoder().encode_int_blocks(\n"
        "    np.arange(64, dtype=np.int64).reshape(2, 32))\n"
        "print(enc.bits.tolist())\n" % str(root))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    entries = [f for f in os.listdir(cache) if not f.startswith(".")]
    assert entries, "no persistent-cache entry written by a real compile"


def test_cli_device_names_the_device(tmp_path):
    """--device runs on the backend JAX brings up and says which one on
    stderr; stdout equals the host run's."""
    fname = str(tmp_path / "d.minh")
    _write_minh(fname)
    p = subprocess.run(
        [sys.executable, "-m", "minnow_tpu.cli.inspect_minh",
         "--device", fname],
        env=_cpu_env(), cwd=REPO, capture_output=True, text=True,
        timeout=180)
    assert p.returncode == 0, p.stderr
    assert "inspect_minh: --device on cpu (cpu)" in p.stderr
    q = subprocess.run(
        [sys.executable, "-m", "minnow_tpu.cli.inspect_minh", fname],
        env=_cpu_env(), cwd=REPO, capture_output=True, text=True,
        timeout=180)
    assert q.returncode == 0, q.stderr
    assert p.stdout == q.stdout


def test_cli_device_fails_loudly_without_backend(tmp_path):
    """--device with a backend that cannot come up fails; it never
    falls back to the host path."""
    fname = str(tmp_path / "d.minh")
    _write_minh(fname)
    p = subprocess.run(
        [sys.executable, "-m", "minnow_tpu.cli.inspect_minh",
         "--device", fname],
        env=_cpu_env(JAX_PLATFORMS="cuda"), cwd=REPO,
        capture_output=True, text=True, timeout=180)
    assert p.returncode != 0
    assert "--device on" not in p.stderr
