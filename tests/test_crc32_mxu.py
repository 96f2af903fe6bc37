"""Device-side CRC32 (GF(2) matmul on the MXU) tests."""

import zlib

import numpy as np
import pytest


def test_mxu_crc32_matches_zlib():
    from qatzip_tpu.ops.crc32_mxu import crc32_batch_device

    rng = np.random.default_rng(7)
    n = 2048
    data = rng.integers(0, 256, (6, n), dtype=np.uint8)
    data[3] = 0          # all zeros
    data[4, :] = 0xFF    # all ones
    crcs = np.asarray(crc32_batch_device(data, n=n))
    for i in range(6):
        assert int(crcs[i]) == (zlib.crc32(data[i].tobytes()) & 0xFFFFFFFF)


def test_engine_with_device_crc(monkeypatch):
    import jax
    from qatzip_tpu.parallel.dispatch import DeviceEngine

    monkeypatch.setenv("QZTPU_DEVICE_CRC", "1")
    chunks = [bytes(np.random.default_rng(i).integers(
        0, 256, 4096, dtype=np.uint8)) for i in range(3)]
    chunks.append(b"ragged tail chunk")  # short row -> host crc path
    eng = DeviceEngine(jax.devices(), "deflate")
    res = eng.compress_chunks(chunks, level=1, algorithm="deflate")
    for (payload, crc), c in zip(res, chunks):
        assert crc == (zlib.crc32(c) & 0xFFFFFFFF)
        assert zlib.decompressobj(-15).decompress(payload) == c
