"""Platform-facing behaviour: the compile-cache location, the gen4 flag,
the engine's auto router, the native-library requirement, the zstd
guard, and chip_smoke.py refusing to run without a GPU."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE_PROBE = ("import qatzip_tpu, jax; "
                "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir_in_fresh_process(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env_var(tmp_path):
    want = str(tmp_path / "jaxcache")
    assert _cache_dir_in_fresh_process(want) == want


def test_compile_cache_default_inside_checkout():
    got = _cache_dir_in_fresh_process(None)
    assert got == os.path.join(REPO, ".jax_cache")


class _FakeDevice:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


@pytest.mark.parametrize("platform,kind,gen4",
                         [("gpu", "NVIDIA H100 80GB HBM3", True),
                          ("cpu", "cpu", False)])
def test_gen4_follows_platform(platform, kind, gen4):
    """Any accelerator backend is gen4-class (levels 10-12); the CPU
    backend is not."""
    from qatzip_tpu.runtime import Runtime

    rt = Runtime()
    rt._adopt([_FakeDevice(platform, kind)])
    assert rt.hw_available and rt.gen4 is gen4


@pytest.mark.parametrize("static,route", [(True, "_compress_device_packed"),
                                          (False, "_tokenize_tiles")])
def test_auto_router(monkeypatch, static, route):
    """QZTPU_DEVICE_PACK=auto sends static sessions to the device pack and
    dynamic sessions to the token path, decided from the session alone."""
    import jax
    from qatzip_tpu.parallel import dispatch as D

    monkeypatch.delenv("QZTPU_DEVICE_PACK", raising=False)
    calls = []

    def packed(self, chunks, *a, **k):
        calls.append("_compress_device_packed")
        return [(b"", 0)] * len(chunks)

    def tiles(self, chunks, *a, **k):
        calls.append("_tokenize_tiles")
        return iter(())

    monkeypatch.setattr(D.DeviceEngine, "_compress_device_packed", packed)
    monkeypatch.setattr(D.DeviceEngine, "_tokenize_tiles", tiles)
    eng = D.DeviceEngine([jax.devices()[0]], "deflate")
    eng.compress_chunks([b"route me " * 100], level=1,
                        huffman_static=static)
    assert calls == [route]


def test_device_engine_requires_native(monkeypatch):
    """No silent host bypass: without the native library the device
    engine refuses to exist and reports why."""
    import jax
    from qatzip_tpu import native
    from qatzip_tpu.parallel.dispatch import DeviceEngine

    monkeypatch.setattr(native, "lib", None)
    monkeypatch.setattr(native, "build_error", "native build failed: boom")
    with pytest.raises(RuntimeError, match="boom"):
        DeviceEngine([jax.devices()[0]], "deflate")


def test_zstd_unavailable_is_loud(monkeypatch):
    from qatzip_tpu import native

    if native.lib is None:
        pytest.skip("native lib unavailable")
    monkeypatch.setattr(native.lib, "have_zstd", False)
    with pytest.raises(RuntimeError, match="zstd is unavailable"):
        native.lib.zstd_compress(b"abc")


def test_chip_smoke_refuses_cpu():
    """On a host without a GPU chip_smoke.py exits non-zero before any
    compile and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert "[phase]" not in r.stdout
