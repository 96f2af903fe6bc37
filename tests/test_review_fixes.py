"""Regression tests for code-review findings."""

import zlib

import numpy as np
import pytest


def test_large_hw_buff_session_on_engine():
    """hw_buff_sz > 64 KiB must work on the accelerated path (chunks are
    split into device rows and payloads joined into one raw stream)."""
    import jax
    from qatzip_tpu import QzSession, params as P
    from qatzip_tpu.parallel.dispatch import DeviceEngine

    rng = np.random.default_rng(5)
    blob = (b"large chunk config " * 9000
            + bytes(rng.integers(0, 256, 30000, dtype=np.uint8)))  # ~200KB
    params = P.get_defaults("deflate")
    params.common.hw_buff_sz = 131072
    sess = QzSession()
    sess.setup_deflate(params)
    sess._engine = DeviceEngine(jax.devices(), "deflate")
    out = sess.compress(blob)
    # stock zlib multi-member decode
    pieces, pos = [], 0
    while pos < len(out):
        do = zlib.decompressobj(31)
        pieces.append(do.decompress(out[pos:]) + do.flush())
        used = len(out) - pos - len(do.unused_data)
        assert used > 0
        pos += used
    assert b"".join(pieces) == blob
    d = QzSession()
    d.setup_deflate(P.get_defaults("deflate"))
    assert d.decompress(out) == blob


def test_auto_select_best_lz4s_mini_match():
    """QZ_AUTO_SELECT_BEST must re-encode LZ4s with the session's
    mini_match (4), not the default 3."""
    from qatzip_tpu import QzSession, params as P
    from qatzip_tpu.constants import QZ_AUTO_SELECT_BEST
    from qatzip_tpu import native

    if native.lib is None:
        pytest.skip("native lib unavailable")
    data = b"mini match four " * 2000
    params = P.get_defaults("lz4s")
    params.lz4s_mini_match = 4
    params.common.sw_backup = QZ_AUTO_SELECT_BEST
    sess = QzSession()
    sess.setup_lz4s(params)
    out = sess.compress(data)
    # decode the lz4s block stream with mini_match=4 — wrong base would
    # corrupt the reconstruction
    import struct
    pos = 0
    rec = bytearray()
    while pos + 4 <= len(out):
        (blk,) = struct.unpack_from("<I", out, pos)
        pos += 4
        ll, mm, oo = native.lib.lz4s_decode_block(out[pos:pos + blk], 4)
        for li, mi, oi in zip(ll.tolist(), mm.tolist(), oo.tolist()):
            rec += data[len(rec):len(rec) + li]
            if mi:
                st = len(rec) - oi
                for k in range(mi):
                    rec.append(rec[st + k])
        pos += blk
    assert bytes(rec) == data


def test_qzip_recursive_zst_suffix_skip(tmp_path):
    """qzip -R must not re-compress .zst outputs and must decompress
    them on -R -d."""
    from qatzip_tpu.cli import qzip as cli

    d = tmp_path / "t"
    d.mkdir()
    (d / "x.txt").write_bytes(b"zst suffix " * 2000)
    assert cli.main(["-A", "zstd", "-R", "-k", str(d)]) == 0
    assert (d / "x.txt.zst").exists()
    assert not (d / "x.txt.zst.gz").exists()
    # second recursive compress run must skip the .zst entirely
    (d / "x.txt").unlink()
    assert cli.main(["-A", "zstd", "-R", "-k", str(d)]) == 0
    assert not (d / "x.txt.zst.zst").exists()
    assert not (d / "x.txt.zst.gz").exists()
    assert cli.main(["-R", "-d", "-f", str(d)]) == 0
    assert (d / "x.txt").read_bytes() == b"zst suffix " * 2000


def test_aqzip_decompress_multi_member(tmp_path):
    """aqzip -d must handle .gz files whose members straddle any chunk
    size (whole-file decompress requests)."""
    from qatzip_tpu.cli import aqzip as cli
    import os

    rng = np.random.default_rng(11)
    data = bytes(rng.integers(0, 256, 300000, dtype=np.uint8))  # incompressible
    p = tmp_path / "big.dat"
    p.write_bytes(data)
    assert cli.main(["-k", "-C", "65536", str(p)]) == 0
    gz = tmp_path / "big.dat.gz"
    assert gz.exists() and gz.stat().st_size > 150000  # many large members
    p.unlink()
    assert cli.main(["-d", "-k", "-C", "65536", str(gz)]) == 0
    assert p.read_bytes() == data
    # unknown suffix in decompress mode is refused, not inverted to .gz
    bad = tmp_path / "notgz.bin"
    bad.write_bytes(b"x")
    assert cli.main(["-d", str(bad)]) == 1


def test_trace_utility_captures_profile(tmp_path):
    """qz_trace wraps jax.profiler; stage() feeds the service counters
    (the reference's QZ_DEBUG timers + dumpCounters analog, SURVEY §5)."""
    import os
    import qatzip_tpu as qz
    from qatzip_tpu.utils.trace import qz_trace, stage
    from qatzip_tpu.utils.debug import get_counters

    d = tmp_path / "prof"
    data = b"trace me " * 5000
    with qz_trace(str(d)):
        with stage("unit_compress"):
            s = qz.QzSession()
            s.setup_deflate()
            blob = s.compress(data)
    assert s.decompress(blob) == data
    # a profile artifact was produced
    found = []
    for root, _dirs, files in os.walk(d):
        found.extend(files)
    assert found, "no trace files written"
    snap = get_counters().snapshot()
    total = {}
    for c in snap.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    assert total.get("stage_unit_compress", 0) >= 1
    assert total.get("stage_unit_compress_us", 0) > 0


def test_nonpow2_search_seg_roundtrip():
    """Round-3 review: the segmented-search unsort masked dist with
    (W-1), which corrupts distances when search_seg is not a power of
    two — the mask must be (1 << pbits) - 1."""
    import jax.numpy as jnp
    from qatzip_tpu.ops.lz77 import lz77_tokenize, tokens_to_bytes

    rng = np.random.default_rng(0)
    base = bytes(rng.integers(97, 102, 3000, dtype=np.uint8))
    data = (base * 8)[:16384]
    arr = jnp.array(np.frombuffer(data, np.uint8)[None, :].copy())
    lens = jnp.array([len(data)], jnp.int32)
    for ss in (6144, 8192):
        toks, ntok = lz77_tokenize(arr, lens, n=len(data), search_seg=ss)
        out = tokens_to_bytes(np.asarray(toks[0]), np.asarray(ntok[0]), data)
        assert out == data, f"search_seg={ss}"


def test_segmented_fallback_unsort_roundtrip():
    """ADVICE r4 (high): the probe accumulator packed dist in pbits bits
    whenever segmented, but the segmented-to-full-row unsort fallback
    (taken when 2*pbits+5 > 31 or ctx_bytes > 31) unpacks at fixed 15
    bits — search_seg=16384 (pbits=14) biased distances by +16384 and
    ctx_words=8 silently dropped every match. dbits must be derived from
    the unsort path actually taken."""
    import jax.numpy as jnp
    from qatzip_tpu.ops.lz77 import lz77_tokenize, tokens_to_bytes

    rng = np.random.default_rng(3)
    base = bytes(rng.integers(97, 102, 5000, dtype=np.uint8))
    data = (base * 8)[:32768]
    arr = jnp.array(np.frombuffer(data, np.uint8)[None, :].copy())
    lens = jnp.array([len(data)], jnp.int32)
    for kw in (dict(search_seg=16384),            # pbits=14: 33 bits
               dict(search_seg=8192, ctx_words=8)):  # ml field overflow
        toks, ntok = lz77_tokenize(arr, lens, n=len(data), **kw)
        out = tokens_to_bytes(np.asarray(toks[0]), np.asarray(ntok[0]),
                              data)
        assert out == data, f"{kw}"
        # matches must actually be found (ctx_words=8 regression dropped
        # them all: ratio collapse without a round-trip failure)
        t = np.asarray(toks[0])[: int(ntok[0])]
        assert (t >> 31).any(), f"no matches emitted: {kw}"


def test_small_chunk_full_reach_keeps_ctx4(monkeypatch):
    """ADVICE r4 (low): for n <= search_seg the search runs full-reach;
    ctx/probes must then be the full-reach values (4/6), not the
    windowed-search ones (3/7)."""
    from qatzip_tpu.parallel.dispatch import _tok_knobs

    for var in ("QZTPU_SEARCH_SEG", "QZTPU_CTX_WORDS", "QZTPU_PROBES"):
        monkeypatch.delenv(var, raising=False)
    ss, _ov, _cs, ctx, probes = _tok_knobs(1, 8192)
    assert ss == 0 and ctx == 4 and probes == 6
    ss, _ov, _cs, ctx, probes = _tok_knobs(1, 65536)
    assert ss == 8192 and ctx == 3 and probes == 7


def test_crc32_combine_zero_len_zlib_semantics():
    """Round-3 review: crc32_combine(crc1, crc2, 0) must return crc1
    (zlib's degenerate case) so the Python fallback and the native
    crc32_combine_many fold agree regardless of member count."""
    from qatzip_tpu.ops.checksum import crc32_combine, crc32_combine_many

    assert crc32_combine(0x12345678, 0xDEADBEEF, 0) == 0x12345678
    crcs = [zlib.crc32(b"abc"), 0xDEADBEEF, zlib.crc32(b"xyz")]
    lens = [3, 0, 3]
    # <=4 members: Python fold; >4: native fold — results must agree
    py = crc32_combine_many(crcs, lens)
    assert py == zlib.crc32(b"abcxyz")
    ext_crcs = crcs + [zlib.crc32(b"q")] * 3
    ext_lens = lens + [1, 1, 1]
    acc = 0
    for c, l in zip(ext_crcs, ext_lens):
        acc = crc32_combine(acc, c, l)
    assert crc32_combine_many(ext_crcs, ext_lens) == acc


def test_k4_histogram_small_n_routes_to_strip(monkeypatch):
    """Round-3 review: a small row (n=512) must histogram through the
    strip reduce, counting every emitted symbol."""
    import jax.numpy as jnp
    from qatzip_tpu.ops.deflate_pack import deflate_analyze_hist

    rng = np.random.default_rng(1)
    data = jnp.array(rng.integers(65, 70, (2, 512), dtype=np.uint8))
    lens = jnp.array([512, 300], jnp.int32)
    hist, ml, dist, taken, lit = deflate_analyze_hist(
        data, lens, n=512, parse_seg=512, ctx_words=4, probes=6,
        search_seg=0, search_overlap=1024)
    assert hist.shape == (2, 316)
    emitted = np.asarray(taken[0]) | np.asarray(lit[0])
    assert int(np.asarray(hist)[0, :286].sum()) == int(emitted.sum())
