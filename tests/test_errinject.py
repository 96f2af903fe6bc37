"""Error injection → CnV fallback.

The reference declares ERR_INJECTION hooks (include/qatzip.h:493-497) and
recovers from CnV failures with stored blocks (src/qatzip.c:1774-1806).
Here the injected fault is a corrupted packer output; the engine's
decode-verify (CnV) must detect it and re-encode via the software codec.
"""

import zlib

import numpy as np
import pytest

from qatzip_tpu import native


def test_cnv_detects_injected_corruption(monkeypatch):
    if native.lib is None:
        pytest.skip("native lib unavailable")
    import jax
    from qatzip_tpu.parallel.dispatch import DeviceEngine

    chunks = [(b"inject %d " % i) * 400 for i in range(4)]
    real_pack = native.lib.deflate_pack
    calls = {"n": 0}

    def corrupt_pack(src, toks, ntok, final=True, mode=0):
        out = bytearray(real_pack(src, toks, ntok, final=final, mode=mode))
        calls["n"] += 1
        if calls["n"] % 2 == 1 and len(out) > 8:
            out[5] ^= 0xFF  # flip bits inside the stream
        return bytes(out)

    monkeypatch.setattr(native.lib, "deflate_pack", corrupt_pack)
    eng = DeviceEngine(jax.devices(), "deflate")
    res = eng.compress_chunks(chunks, level=1, algorithm="deflate", cnv=True)
    for (payload, crc), c in zip(res, chunks):
        # every returned payload must decode correctly — corrupted ones
        # were replaced by the software fallback
        assert zlib.decompressobj(-15).decompress(payload) == c
        assert crc == (zlib.crc32(c) & 0xFFFFFFFF)


def test_cnv_off_passes_through(monkeypatch):
    """Without CnV the engine trusts the packer (documents the contract)."""
    if native.lib is None:
        pytest.skip("native lib unavailable")
    import jax
    from qatzip_tpu.parallel.dispatch import DeviceEngine

    chunks = [b"trust " * 500]
    eng = DeviceEngine(jax.devices(), "deflate")
    res = eng.compress_chunks(chunks, level=1, algorithm="deflate", cnv=False)
    assert zlib.decompressobj(-15).decompress(res[0][0]) == chunks[0]
