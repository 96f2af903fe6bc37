"""On-device LZ4 block packing — cross-verified against the native LZ4
decoder, plus frame-level e2e through the engine router.

The device emits final LZ4 block bytes (ops/lz4_pack.py); chunks whose
literal runs exceed the per-emission budget fall back to the host coder
(the ok flag — see the module docstring for the format constraint)."""

import numpy as np
import pytest

import jax.numpy as jnp

from qatzip_tpu import native
from qatzip_tpu.ops.lz4_pack import lz4_pack_device
from tests.corpus import text_like

pytestmark = pytest.mark.skipif(native.lib is None,
                                reason="native lib unavailable")


def _pack(rows, n):
    b = len(rows)
    data = np.zeros((b, n), np.uint8)
    lens = np.zeros(b, np.int32)
    for i, r in enumerate(rows):
        a = np.frombuffer(r, np.uint8)
        data[i, : len(a)] = a
        lens[i] = len(a)
    words, nbytes, ok = lz4_pack_device(jnp.asarray(data),
                                        jnp.asarray(lens), n=n)
    return np.asarray(words), np.asarray(nbytes), np.asarray(ok)


def test_lz4_device_pack_roundtrips():
    rng = np.random.default_rng(4)
    n = 16384
    rows = [
        text_like(n),
        b"A" * n,                       # zero-literal 273-match chains
        rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes(),
        b"hello",                       # tiny: all-literal final sequence
        bytes(rng.integers(0, 256, 270, dtype=np.uint8)) * 2 + b"Z" * 100,
        ((b"abcd" * 2000
          + rng.integers(0, 256, 200, dtype=np.uint8).tobytes()) * 2)[:n],
        b"",                            # empty row
    ]
    words, nbytes, ok = _pack(rows, n)
    for i, r in enumerate(rows):
        if not r:
            continue                    # empty chunks route to the host
        assert ok[i], f"row {i} unexpectedly fell back"
        payload = words[i][: (int(nbytes[i]) + 3) // 4].tobytes()
        payload = payload[: int(nbytes[i])]
        assert native.lib.lz4_decompress_block(payload, len(r)) == r


def test_lz4_device_pack_long_run_falls_back():
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()]
    _w, _n, ok = _pack(rows, 8192)
    assert not ok[0]                    # literal run > 270 -> host coder


def test_lz4_device_pack_engine_path(monkeypatch):
    """Drive _compress_lz4_device itself (the suite's 8-virtual-device
    mesh routes the session path away from it): a single-device engine
    must mix device-packed and host-fallback chunks, bucketed-fetch the
    words, and honor CnV."""
    monkeypatch.setenv("QZTPU_DEVICE_PACK", "1")
    monkeypatch.setenv("QZTPU_CNV", "1")
    import jax
    from qatzip_tpu.parallel.dispatch import DeviceEngine
    rng = np.random.default_rng(8)
    eng = DeviceEngine([jax.devices()[0]], "lz4")
    chunks = [
        b"engine path " * 3000,
        rng.integers(0, 256, 50000, dtype=np.uint8).tobytes(),  # fallback
        b"R" * 40000,
        b"",
    ]
    results = eng.compress_chunks(chunks, level=1, algorithm="lz4")
    import zlib as _z
    for chunk, (payload, crc) in zip(chunks, results):
        assert crc == (_z.crc32(chunk) & 0xFFFFFFFF)
        if chunk:
            assert native.lib.lz4_decompress_block(payload,
                                                   len(chunk)) == chunk


def test_lz4_device_pack_engine_frame_e2e(monkeypatch):
    """LZ4 frame round trip with QZTPU_DEVICE_PACK=1: device-packed and
    host-fallback chunks mix inside one frame."""
    monkeypatch.setenv("QZTPU_DEVICE_PACK", "1")
    import qatzip_tpu as qz
    from qatzip_tpu.runtime import get_runtime
    if not get_runtime().hw_available:
        pytest.skip("no engine backend")
    rng = np.random.default_rng(6)
    data = (b"frame body " * 8000                  # device-packable
            + rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()  # not
            + b"Z" * 50000)                        # RLE chains
    s = qz.QzSession()
    s.setup_lz4()
    blob = s.compress(data)
    s2 = qz.QzSession()
    s2.setup_lz4()
    assert s2.decompress(blob) == data
