"""Smoke run of the compress engine on NVIDIA GPUs, through the entry points
a user calls, at the product's default width (deflate L1, 64 KB
``hw_buff_sz``, 256-chunk tiles).

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --four-gpu  # only the 4-GPU dp-mesh path

Phases (each prints one line with its wall and compile seconds):

  1. environment: the card, the native library, the runtime and the engine
  2. default dynamic session on a 64 MB mixed corpus (one 4-tile scan group)
  3. static-Huffman session (device pack) on 16 MB
  4. QZTPU_DEVICE_PACK=1 dynamic device pack and LZ4 device pack, 16 MB each
  5. level-12 session (full-reach search) on 16 MB
  6. one 32 x 64 KB tile on the GPU against JAX's CPU backend in the same
     process: tokens and packed words bit-identical, device crc32 == zlib
  7. QzStream and AQzSession requests

Every compressed stream is decoded with stock zlib (or the native LZ4
decoder) and compared byte for byte. Any failure exits non-zero; the last
line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import zlib

MB = 1 << 20
ROW = 64 * 1024


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class _Phases:
    """Wall and compile seconds per phase. Compile time is the sum of
    JAX's own trace/lower/compile duration events inside the phase."""

    def __init__(self, jax):
        self._lock = threading.Lock()
        self._compile_s = 0.0

        def on_duration(event, duration_secs, **_kw):
            if event.startswith("/jax/core/compile/"):
                with self._lock:
                    self._compile_s += duration_secs

        jax.monitoring.register_event_duration_secs_listener(on_duration)

    @contextlib.contextmanager
    def phase(self, name: str):
        notes = []
        t0, c0 = time.perf_counter(), self._compile_s
        yield notes
        wall = time.perf_counter() - t0
        comp = self._compile_s - c0
        extra = (" " + " ".join(notes)) if notes else ""
        print(f"[phase] {name}: ok wall_s={wall:.3f} compile_s={comp:.3f}"
              f"{extra}", flush=True)


def _gunzip_members(blob: bytes) -> bytes:
    """Stock-zlib decode of a multi-member gzip stream."""
    out, pos = [], 0
    while pos < len(blob):
        d = zlib.decompressobj(31)
        out.append(d.decompress(blob[pos:]) + d.flush())
        used = len(blob) - pos - len(d.unused_data)
        if used <= 0 or not d.eof:
            raise ValueError(f"truncated gzip member at offset {pos}")
        pos += used
    return b"".join(out)


def _load_corpus_module():
    """tests/corpus.py by path: ``tests`` is a namespace package here, and a
    regular ``tests`` package installed elsewhere would shadow it."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "corpus.py")
    spec = importlib.util.spec_from_file_location("qz_test_corpus", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _peak_mem_gb(dev) -> str:
    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "n/a" if peak is None else f"{peak / 1e9:.3f}"


def _count_routes(dispatch):
    """Count calls into each DeviceEngine compress route, so each phase
    can show it ran the device path it names."""
    calls = collections.Counter()
    for name in ("_tokenize_tiles", "_compress_device_packed",
                 "_compress_lz4_device", "_dyn_pass2"):
        orig = getattr(dispatch.DeviceEngine, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(self, *a, **k)

        setattr(dispatch.DeviceEngine, name, wrapped)
    return calls


@contextlib.contextmanager
def _device_pack(mode: str):
    old = os.environ.get("QZTPU_DEVICE_PACK")
    os.environ["QZTPU_DEVICE_PACK"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("QZTPU_DEVICE_PACK", None)
        else:
            os.environ["QZTPU_DEVICE_PACK"] = old


def _deflate_session(qz, *, static: bool = False, level: int = 1):
    from qatzip_tpu import params as P
    from qatzip_tpu.constants import QZ_OK, HuffmanHdr

    params = P.get_defaults("deflate")
    params.common.comp_lvl = level
    if static:
        params.huffman_hdr = HuffmanHdr.STATIC_HDR
    sess = qz.QzSession()
    rc = sess.setup_deflate(params)
    _check(rc == QZ_OK, f"setup_deflate(level={level}) rc={rc}")
    return sess


def _roundtrip_deflate(sess, data: bytes, notes) -> bytes:
    out = sess.compress(data)
    _check(_gunzip_members(out) == data, "stock zlib decode mismatch")
    _check(sess.decompress(out) == data, "session decompress mismatch")
    notes.append(f"mb={len(data) / MB:g} ratio={len(data) / len(out):.4f}")
    return out


def _tile_outputs(dev, data, lengths, knobs):
    """Run every device kernel of the compress path on one tile placed on
    ``dev``. Returns host copies of the outputs, and the device-resident
    pass-1 planes for the dynamic pack."""
    import jax
    import numpy as np

    from qatzip_tpu.ops.deflate_pack import (deflate_analyze_hist,
                                             deflate_pack_device)
    from qatzip_tpu.ops.lz4_pack import lz4_pack_device
    from qatzip_tpu.ops.lz77 import lz77_tokenize

    ss, ov, cs, ctx, probes = knobs
    n = data.shape[1]
    d = jax.device_put(data, dev)
    ln = jax.device_put(lengths, dev)
    skw = dict(search_seg=ss, search_overlap=ov, ctx_words=ctx, probes=probes)
    out = {}
    out["tokens"], out["ntok"] = lz77_tokenize(d, ln, n=n, compact_seg=cs,
                                               **skw)
    out["static_words"], out["static_nbits"] = deflate_pack_device(
        d, ln, n=n, **skw)
    out["hist"], *planes = deflate_analyze_hist(d, ln, n=n, **skw)
    out["lz4_words"], out["lz4_nbytes"], out["lz4_ok"] = lz4_pack_device(
        d, ln, n=n)
    return {k: np.asarray(v) for k, v in out.items()}, (d, *planes)


def _dyn_outputs(dev, planes, plan):
    import jax
    import numpy as np

    from qatzip_tpu.ops.deflate_pack import deflate_pack_dynamic

    packs, dpacks, hbits = (jax.device_put(a, dev) for a in plan)
    words, nbits = deflate_pack_dynamic(*planes, packs, dpacks, hbits,
                                        n=planes[0].shape[1])
    return {"dyn_words": np.asarray(words), "dyn_nbits": np.asarray(nbits)}


def _dyn_plan(native, hist):
    """Per-row Huffman plans from pass-1 histograms (as the engine's
    _dyn_pass2 builds them)."""
    import numpy as np

    b = hist.shape[0]
    packs = np.zeros((b, 286), np.uint16)
    dpacks = np.zeros((b, 30), np.uint16)
    hdrs, hbits = [], np.zeros(b, np.int32)
    for i in range(b):
        lf = hist[i, :286].astype(np.uint32)
        lf[256] += 1
        packs[i], dpacks[i], hdr, hbits[i] = native.lib.dyn_plan(
            lf, hist[i, 286:].astype(np.uint32))
        hdrs.append(hdr)
    return packs, dpacks, hdrs, hbits


def _phase_reference(ph, gpu, corpus):
    """GPU against JAX's CPU backend on one 32 x 64 KB tile."""
    import jax
    import numpy as np

    from qatzip_tpu import native
    from qatzip_tpu.ops.crc32_mxu import crc32_batch_device
    from qatzip_tpu.ops.deflate_pack import finish_stream, finish_stream_dynamic
    from qatzip_tpu.ops.lz77 import merge_segment_tokens, tokens_to_bytes
    from qatzip_tpu.parallel.dispatch import _tok_knobs

    with ph.phase("gpu_vs_cpu_reference") as notes:
        cpu = jax.devices("cpu")[0]
        b, n = 32, ROW
        data = np.frombuffer(corpus[:b * n], np.uint8).reshape(b, n).copy()
        lengths = np.full(b, n, np.int32)
        lengths[-1] = 40000                  # one ragged, zero-padded row
        data[-1, lengths[-1]:] = 0
        knobs = _tok_knobs(1, n)

        g, g_planes = _tile_outputs(gpu, data, lengths, knobs)
        c, c_planes = _tile_outputs(cpu, data, lengths, knobs)
        _check(np.array_equal(g["hist"], c["hist"]), "hist differs")
        packs, dpacks, hdrs, hbits = _dyn_plan(native, g["hist"])
        plan = (packs.astype(np.uint32), dpacks.astype(np.uint32), hbits)
        g.update(_dyn_outputs(gpu, g_planes, plan))
        c.update(_dyn_outputs(cpu, c_planes, plan))
        for k in sorted(g):
            _check(g[k].shape == c[k].shape and np.array_equal(g[k], c[k]),
                   f"{k}: GPU and CPU outputs differ")

        # the GPU outputs also decode to the source
        for i in range(b):
            src = data[i, :lengths[i]].tobytes()
            toks = merge_segment_tokens(g["tokens"][i], g["ntok"][i],
                                        knobs[2] or n)
            _check(tokens_to_bytes(toks, len(toks), src) == src,
                   f"row {i}: tokens do not rebuild the source")
            st = finish_stream(g["static_words"][i],
                               int(g["static_nbits"][i]), final=True)
            _check(zlib.decompressobj(-15).decompress(st) == src,
                   f"row {i}: static stream")
            dy = finish_stream_dynamic(g["dyn_words"][i],
                                       int(g["dyn_nbits"][i]), hdrs[i],
                                       int(packs[i][256]), final=True)
            _check(zlib.decompressobj(-15).decompress(dy) == src,
                   f"row {i}: dynamic stream")
            if g["lz4_ok"][i]:
                nb = int(g["lz4_nbytes"][i])
                blk = g["lz4_words"][i][:(nb + 3) // 4].tobytes()[:nb]
                _check(native.lib.lz4_decompress_block(blk, len(src)) == src,
                       f"row {i}: lz4 block")

        crc = np.asarray(crc32_batch_device(jax.device_put(data, gpu), n=n))
        full = [i for i in range(b) if lengths[i] == n]
        for i in full:
            _check(int(crc[i]) == zlib.crc32(data[i].tobytes()) & 0xFFFFFFFF,
                   f"row {i}: device crc32 != zlib.crc32")
        notes.append(f"tile={b}x{n} arrays_bit_identical={len(g)} "
                     f"tolerance=0 crc32_rows={len(full)}")


def run_one_gpu(jax, gpu) -> None:
    import qatzip_tpu as qz
    from qatzip_tpu import native
    from qatzip_tpu.parallel import dispatch
    from qatzip_tpu.runtime import get_runtime

    make_silesia_like = _load_corpus_module().make_silesia_like
    ph = _Phases(jax)
    routes = _count_routes(dispatch)

    with ph.phase("environment") as notes:
        _check(native.lib is not None,
               f"native library not loaded: {native.build_error}")
        rt = get_runtime()
        rt.init(0)
        _check(rt.hw_available and rt.platform == "gpu",
               f"runtime platform {rt.platform!r}: {rt.last_error}")
        _check(rt.gen4, "runtime did not mark the GPU gen4-class")
        sess = _deflate_session(qz)
        sess.compress(b"warm")
        _check(isinstance(sess._engine, dispatch.DeviceEngine),
               f"session engine is {sess._engine!r}, not the device engine")
        notes.append(f"devices={len(rt.devices)} engine={sess._engine.name} "
                     f"zstd={native.lib.have_zstd} "
                     f"tile_b={dispatch.TILE_B} "
                     f"scan_tiles={dispatch.SCAN_TILES}")

    corpus = make_silesia_like(64)

    with ph.phase("dynamic_session_64mb") as notes:
        before = routes["_tokenize_tiles"]
        _roundtrip_deflate(_deflate_session(qz), corpus, notes)
        _check(routes["_tokenize_tiles"] > before, "token path not taken")
        notes.append(f"peak_device_gb={_peak_mem_gb(gpu)}")

    data16 = corpus[:16 * MB]
    with ph.phase("static_session_16mb") as notes:
        before = routes["_compress_device_packed"]
        _roundtrip_deflate(_deflate_session(qz, static=True), data16, notes)
        _check(routes["_compress_device_packed"] > before,
               "static session did not take the device pack")

    with ph.phase("device_pack_dynamic_16mb") as notes, _device_pack("1"):
        before = routes["_dyn_pass2"]
        _roundtrip_deflate(_deflate_session(qz), data16, notes)
        _check(routes["_dyn_pass2"] > before, "dynamic device pack not taken")

    with ph.phase("lz4_device_pack_16mb") as notes, _device_pack("1"):
        before = routes["_compress_lz4_device"]
        s = qz.QzSession()
        s.setup_lz4()
        out = s.compress(data16)
        _check(routes["_compress_lz4_device"] > before,
               "LZ4 device pack not taken")
        d = qz.QzSession()
        d.setup_lz4()
        _check(d.decompress(out) == data16, "native LZ4 decode mismatch")
        notes.append(f"mb=16 ratio={len(data16) / len(out):.4f}")

    with ph.phase("level12_session_16mb") as notes:
        ss = dispatch._tok_knobs(12, ROW)[0]
        _check(ss == 0, "level 12 should search the full row")
        _roundtrip_deflate(_deflate_session(qz, level=12), data16, notes)
        notes.append(f"search=full_row_{ROW} "
                     f"peak_device_gb={_peak_mem_gb(gpu)}")

    _phase_reference(ph, gpu, corpus)

    with ph.phase("stream_and_async") as notes:
        from qatzip_tpu.async_engine import (AQZ_OK, AQzSession, aqz_init,
                                             aqz_stop)
        from qatzip_tpu.constants import QZ_OK
        from qatzip_tpu.stream import QzStream

        src = corpus[:4 * MB]
        sess = _deflate_session(qz)
        strm = QzStream(sess, strm_buff_sz=1 * MB)
        out = bytearray()
        for off in range(0, len(src), 512 * 1024):
            piece = src[off:off + 512 * 1024]
            out += strm.compress(piece, last=off + len(piece) >= len(src))
        strm.end()
        _check(_gunzip_members(bytes(out)) == src, "stream decode mismatch")

        _check(aqz_init(num_threads=2) == QZ_OK, "aqz_init failed")
        try:
            asess = AQzSession()
            asess.setup_deflate()
            reqs = [corpus[i * MB:(i + 1) * MB] for i in range(4)]
            results, done = {}, threading.Event()

            def cb(external, _src, dest, rc, crc):
                results[external] = (rc, dest, crc)
                if len(results) == len(reqs):
                    done.set()

            for i, r in enumerate(reqs):
                _check(asess.compress(r, cb, external=i) == AQZ_OK,
                       "async submit refused")
            _check(done.wait(timeout=600), "async requests timed out")
        finally:
            aqz_stop()
        for i, r in enumerate(reqs):
            rc, dest, crc = results[i]
            _check(rc == QZ_OK and crc == zlib.crc32(r) & 0xFFFFFFFF,
                   f"async request {i} rc={rc}")
            _check(_gunzip_members(dest) == r, f"async request {i} decode")
        notes.append(f"stream_mb=4 async_requests={len(reqs)}")


def run_four_gpu(jax, devs) -> None:
    """The dp-mesh path on 4 GPUs against the same sessions on one."""
    import qatzip_tpu as qz
    from qatzip_tpu.parallel.dispatch import DeviceEngine
    from qatzip_tpu.runtime import get_runtime

    make_silesia_like = _load_corpus_module().make_silesia_like
    ph = _Phases(jax)
    _check(len(devs) >= 4, f"--four-gpu needs 4 GPUs, found {len(devs)}")
    rt = get_runtime()
    rt.init(0)
    _check(len(rt.devices) == 4 and rt.platform == "gpu",
           f"runtime holds {len(rt.devices)} {rt.platform} devices")
    corpus = make_silesia_like(64)
    for label, mode, static in (("dynamic", "auto", False),
                                ("static", "auto", True),
                                ("device_pack_dynamic", "1", False)):
        with ph.phase(f"four_gpu_{label}_64mb") as notes, _device_pack(mode):
            mesh_sess = _deflate_session(qz, static=static)
            mesh_out = mesh_sess.compress(corpus)
            _check(len(mesh_sess._engine.devices) == 4,
                   "session engine does not span 4 GPUs")
            one_sess = _deflate_session(qz, static=static)
            one_sess._engine = DeviceEngine(devs[:1], "deflate")
            one_out = one_sess.compress(corpus)
            _check(mesh_out == one_out, "4-GPU output != 1-GPU output")
            _check(_gunzip_members(mesh_out) == corpus, "zlib decode")
            notes.append(f"mb=64 ratio={len(corpus) / len(mesh_out):.4f} "
                         "bytes_identical_to_1gpu=true")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpu", action="store_true",
                    help="run only the 4-GPU dp-mesh path")
    args = ap.parse_args()

    # the CPU backend stays reachable beside the GPU for the reference
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and plats != "cpu" and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:
        _fail(f"JAX found no accelerator: {e}")
    if devs[0].platform != "gpu":
        _fail(f"JAX found no GPU (default platform {devs[0].platform!r})")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        print(f"[gpu] {line.strip()}", flush=True)

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "qatzip_tpu")):
        _fail("qatzip_tpu package not found beside chip_smoke.py")
    sys.path.insert(0, here)

    if args.four_gpu:
        run_four_gpu(jax, devs)
    else:
        run_one_gpu(jax, devs[0])

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
