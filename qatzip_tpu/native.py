"""ctypes bindings to the native host runtime (csrc/qztpu_native.cpp).

Auto-builds the shared library with g++ on first import when it is missing
or stale. Every caller must tolerate ``lib is None`` (pure-Python fallback),
mirroring the reference's hardware-absent SW-fallback philosophy
(src/qatzip_sw.c is a first-class path, not an afterthought).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import sys
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "..", "csrc", "qztpu_native.cpp")
_SO = os.path.join(_DIR, "_qztpu_native.so")
# serializes builds across processes (pytest workers, pool children): a
# process must never load a library another one is still writing
_BUILD_LOCK = os.path.join(_DIR, ".native_build.lock")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64p = ctypes.POINTER(ctypes.c_int64)


# why the library is missing (None while it is loaded or not yet tried);
# the device engine reports it instead of silently running on the host
build_error: str | None = None


def _has_zstd() -> bool:
    """Does the compiler see zstd's header? Without it the library builds
    with the zstd bridge compiled out (csrc guards it with
    __has_include) and must not link -lzstd."""
    probe = subprocess.run(["g++", "-x", "c++", "-E", "-", "-o", os.devnull],
                           input="#include <zstd.h>\n", capture_output=True,
                           text=True, timeout=60)
    return probe.returncode == 0


def _compile_to(path: str, cmd: list, timeout: int):
    """Run a g++ command that writes ``path`` via a private temp file and
    an atomic rename, so a concurrent loader never sees a partial file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True,
                         timeout=timeout)
    if res.returncode == 0:
        os.replace(tmp, path)
    elif os.path.exists(tmp):
        os.unlink(tmp)
    return res


def _build() -> bool:
    global build_error
    try:
        cmd = [
            "g++", "-O3", "-fPIC", "-std=c++17", "-march=native", "-shared",
            _SRC,
        ]
        if _has_zstd():
            cmd.append("-lzstd")
        else:
            sys.stderr.write("qztpu_native: zstd.h not found — building "
                             "without the zstd bridge\n")
        res = _compile_to(_SO, cmd, timeout=180)
        if res.returncode != 0:
            build_error = "native build failed:\n" + res.stderr
            sys.stderr.write("qztpu_native build failed:\n" + res.stderr + "\n")
            return False
        return True
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"native build error: {e}"
        sys.stderr.write(f"qztpu_native build error: {e}\n")
        return False


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    try:
        return os.path.getmtime(_SO) < os.path.getmtime(_SRC)
    except OSError:
        return False


# -- optional CPython extension (zero-copy decode output) -------------------
_PYEXT_SRC = os.path.join(_DIR, "..", "csrc", "qztpu_pyext.c")
_PYEXT_SO = os.path.join(_DIR, "_qztpu_pyext.so")
pyext = None


def _build_pyext() -> bool:
    import sysconfig
    inc = sysconfig.get_paths().get("include")
    if not inc or not os.path.exists(os.path.join(inc, "Python.h")):
        return False
    try:
        # link by soname (-l:) not absolute path: an absolute path lands
        # verbatim in DT_NEEDED and breaks when the repo moves; with a
        # bare name the $ORIGIN rpath resolves it next to this .so
        cmd = ["g++", "-O2", "-fPIC", "-shared", "-I", inc, _PYEXT_SRC,
               "-L", os.path.dirname(_SO), "-l:" + os.path.basename(_SO),
               "-Wl,-rpath,$ORIGIN"]
        res = _compile_to(_PYEXT_SO, cmd, timeout=60)
        if res.returncode != 0:
            sys.stderr.write("qztpu_pyext build failed:\n" + res.stderr + "\n")
            return False
        return True
    except Exception as e:  # noqa: BLE001
        sys.stderr.write(f"qztpu_pyext build error: {e}\n")
        return False


def _load_pyext():
    global pyext
    try:
        stale = (not os.path.exists(_PYEXT_SO)
                 or os.path.getmtime(_PYEXT_SO) < os.path.getmtime(_PYEXT_SRC)
                 or os.path.getmtime(_PYEXT_SO) < os.path.getmtime(_SO))
    except OSError:
        stale = True
    if stale and not _build_pyext():
        return

    def _try_load():
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "qatzip_tpu._qztpu_pyext", _PYEXT_SO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    try:
        pyext = _try_load()
    except Exception:  # noqa: BLE001
        # a prebuilt .so from another checkout path may not resolve its
        # DT_NEEDED — rebuild in place once and retry before giving up
        try:
            if _build_pyext():
                pyext = _try_load()
        except Exception as e:  # noqa: BLE001
            sys.stderr.write(f"qztpu_pyext load failed: {e}\n")


class _NativeLib:
    """Typed wrappers over the C ABI."""

    def __init__(self, cdll: ctypes.CDLL):
        self._lib = cdll
        L = cdll
        L.qz_xxh32.restype = ctypes.c_uint32
        L.qz_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                               ctypes.c_uint32]
        _u64p = ctypes.POINTER(ctypes.c_uint64)
        L.qz_crc64_tables.restype = None
        L.qz_crc64_tables.argtypes = [ctypes.c_uint64, ctypes.c_int32, _u64p]
        L.qz_crc64.restype = ctypes.c_uint64
        L.qz_crc64.argtypes = [_u8p, ctypes.c_int64, _u64p, ctypes.c_uint64,
                               ctypes.c_int32]
        for name in ("qz_lz4_compress_block",):
            fn = getattr(L, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [_u8p, ctypes.c_int64, _u8p, ctypes.c_int64,
                           ctypes.c_int32]
        L.qz_lz4_decompress_block.restype = ctypes.c_int64
        L.qz_lz4_decompress_block.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                              ctypes.c_int64]
        L.qz_lz4s_compress_block.restype = ctypes.c_int64
        L.qz_lz4s_compress_block.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                             ctypes.c_int64, ctypes.c_int32,
                                             ctypes.c_int32]
        L.qz_lz4s_decode_block.restype = ctypes.c_int64
        L.qz_lz4s_decode_block.argtypes = [_u8p, ctypes.c_int64,
                                           ctypes.c_int32, _u32p, _u32p,
                                           _u32p, ctypes.c_int64]
        L.qz_zstd_post_process.restype = ctypes.c_int64
        L.qz_zstd_post_process.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                           ctypes.c_int64, ctypes.c_int32,
                                           _u8p, ctypes.c_int64,
                                           ctypes.c_int32]
        L.qz_zstd_compress.restype = ctypes.c_int64
        L.qz_zstd_compress.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                       ctypes.c_int64, ctypes.c_int32]
        L.qz_zstd_decompress.restype = ctypes.c_int64
        L.qz_zstd_decompress.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                         ctypes.c_int64]
        L.qz_zstd_compress_bound.restype = ctypes.c_uint64
        L.qz_zstd_compress_bound.argtypes = [ctypes.c_uint64]
        L.qz_have_zstd.restype = ctypes.c_int32
        L.qz_have_zstd.argtypes = []
        self.have_zstd = bool(L.qz_have_zstd())
        L.qz_deflate_static_block.restype = ctypes.c_int64
        L.qz_deflate_static_block.argtypes = [
            _u8p, ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64, _u8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, _i64p]
        L.qz_inflate_raw.restype = ctypes.c_int64
        L.qz_inflate_raw.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                     ctypes.c_int64]
        _i32p = ctypes.POINTER(ctypes.c_int32)
        L.qz_lz4_ref_block.restype = ctypes.c_int64
        L.qz_lz4_ref_block.argtypes = [_u8p, ctypes.c_int64, _i32p,
                                       ctypes.c_int64]
        _u16p = ctypes.POINTER(ctypes.c_uint16)
        L.qz_dyn_plan.restype = ctypes.c_int64
        L.qz_dyn_plan.argtypes = [_u32p, _u32p, ctypes.c_int32, _u16p,
                                  _u16p, _u8p, ctypes.c_int64]
        L.qz_crc32.restype = ctypes.c_uint32
        L.qz_crc32.argtypes = [_u8p, ctypes.c_int64, ctypes.c_uint32]
        L.qz_crc32_combine_many.restype = ctypes.c_uint32
        L.qz_crc32_combine_many.argtypes = [_u32p, _i64p, ctypes.c_int32,
                                            ctypes.c_uint32]
        L.qz_scan_gzipext.restype = ctypes.c_int64
        L.qz_scan_gzipext.argtypes = [_u8p, ctypes.c_int64, _i64p, _i64p,
                                      _i64p, _u32p, ctypes.c_int64, _i64p]
        L.qz_inflate_batch.restype = None
        L.qz_inflate_batch.argtypes = [_u8p, _i64p, _i64p, _u8p, _i64p,
                                       _i64p, _i64p, _u32p,
                                       ctypes.c_int32, ctypes.c_int32,
                                       _i64p]
        L.qz_lz4_decompress_batch.restype = None
        L.qz_lz4_decompress_batch.argtypes = [_u8p, _i64p, _i64p, _u8p,
                                              _i64p, _i64p, _i64p,
                                              ctypes.c_int32,
                                              ctypes.c_int32, _u32p]
        L.qz_deflate_pack.restype = ctypes.c_int64
        L.qz_deflate_pack.argtypes = [_u8p, ctypes.c_int64, _u32p,
                                      ctypes.c_int64, _u8p, ctypes.c_int64,
                                      ctypes.c_int32, ctypes.c_int32]
        L.qz_deflate_compress_batch.restype = None
        L.qz_deflate_compress_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), _i64p, _u8p, ctypes.c_int32,
            ctypes.c_int32, _u8p, _i64p, _i64p, _i64p, _u32p,
            ctypes.c_int32, ctypes.c_int32]
        L.qz_lz4_compress_batch.restype = None
        L.qz_lz4_compress_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), _i64p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _u8p, _i64p, _i64p, _i64p,
            _u32p, ctypes.c_int32, ctypes.c_int32]
        L.qz_lz77_host.restype = ctypes.c_int64
        L.qz_lz77_host.argtypes = [_u8p, ctypes.c_int64, _u32p,
                                   ctypes.c_int64, ctypes.c_int32]
        L.qz_lz4_pack.restype = ctypes.c_int64
        L.qz_lz4_pack.argtypes = [_u8p, ctypes.c_int64, _u32p,
                                  ctypes.c_int64, _u8p, ctypes.c_int64]
        L.qz_lz4s_pack.restype = ctypes.c_int64
        L.qz_lz4s_pack.argtypes = [_u8p, ctypes.c_int64, _u32p,
                                   ctypes.c_int64, _u8p, ctypes.c_int64,
                                   ctypes.c_int32]

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _as_u8p(arr: np.ndarray):
        return arr.ctypes.data_as(_u8p)

    def xxh32(self, data: bytes, seed: int = 0) -> int:
        return self._lib.qz_xxh32(data, len(data), seed & 0xFFFFFFFF)

    def crc64_tables(self, poly: int, reflected: bool) -> np.ndarray:
        """Build the 8x256 slicing tables for (poly, reflect_in)."""
        tbl = np.empty(8 * 256, np.uint64)
        self._lib.qz_crc64_tables(
            poly & 0xFFFFFFFFFFFFFFFF, 1 if reflected else 0,
            tbl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return tbl

    def dyn_plan(self, lfreq: np.ndarray, dfreq: np.ndarray,
                 limit: int = 12):
        """Build a dynamic-Huffman chunk plan from (286,) lit/len and
        (30,) distance histograms (both trees optimal, length-limited).

        Returns (lit_pack (286,) u16 = revcode|len<<12, dist_pack (30,)
        u16, header_bytes, header_nbits). Caller includes the EOB in
        lfreq[256]."""
        lf = np.ascontiguousarray(lfreq, np.uint32)
        df = np.ascontiguousarray(dfreq, np.uint32)
        if lf.shape != (286,) or df.shape != (30,):
            raise ValueError("dyn_plan expects (286,) lit/len and (30,) "
                             "dist histograms")
        lit_pack = np.empty(286, np.uint16)
        dist_pack = np.empty(30, np.uint16)
        hdr = np.zeros(512, np.uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        r = self._lib.qz_dyn_plan(
            lf.ctypes.data_as(_u32p), df.ctypes.data_as(_u32p), limit,
            lit_pack.ctypes.data_as(u16p), dist_pack.ctypes.data_as(u16p),
            self._as_u8p(hdr), len(hdr))
        if r < 0:
            raise RuntimeError("dyn plan failed")
        return lit_pack, dist_pack, hdr[: (int(r) + 7) // 8].tobytes(), int(r)

    def inflate_batch(self, data, in_offs, in_lens, out_sizes,
                      nthreads: int = 0):
        """Decode a member batch straight into one contiguous buffer with
        a native thread pool (GIL-free end to end).

        Returns (out: np.uint8 array of sum(out_sizes), member_crcs,
        member_lens, member_in_used). A malformed member has len -1;
        caller decides the fallback (the SW route, as the reference does
        per-member). ``in_used[i]`` = input bytes the decode consumed —
        a value short of the member's payload size means a footer-scan
        mislabeled trailing data (e.g. concatenated std-gzip members).
        """
        import os as _os
        n = len(in_offs)
        sa = (np.frombuffer(data, np.uint8)
              if not isinstance(data, np.ndarray) else data)
        in_offs = np.ascontiguousarray(in_offs, np.int64)
        in_lens = np.ascontiguousarray(in_lens, np.int64)
        caps = np.ascontiguousarray(out_sizes, np.int64)
        out_offs = np.zeros(n, np.int64)
        np.cumsum(caps[:-1], out=out_offs[1:])
        total = int(caps.sum())
        dst = np.empty(max(total, 1), np.uint8)
        out_lens = np.empty(n, np.int64)
        in_used = np.empty(n, np.int64)
        crcs = np.empty(n, np.uint32)
        if nthreads <= 0:
            # oversubscribe: crc32 and table-build phases leave bubbles
            # an extra wave fills (nt=4*cores measured +7% on 4 cores)
            nthreads = min(4 * (_os.cpu_count() or 4), 32)
        self._lib.qz_inflate_batch(
            self._as_u8p(sa) if len(sa) else self._as_u8p(
                np.empty(1, np.uint8)),
            in_offs.ctypes.data_as(_i64p), in_lens.ctypes.data_as(_i64p),
            self._as_u8p(dst), out_offs.ctypes.data_as(_i64p),
            caps.ctypes.data_as(_i64p), out_lens.ctypes.data_as(_i64p),
            crcs.ctypes.data_as(_u32p), n, nthreads,
            in_used.ctypes.data_as(_i64p))
        return dst[:total], crcs, out_lens, in_used

    def inflate_batch_bytes(self, data, in_offs, in_lens, out_sizes,
                            nthreads: int = 0):
        """Like inflate_batch but the output is a ``bytes`` the decoder
        wrote directly (zero copy, via the CPython extension). Falls back
        to the numpy path + one copy when the extension is unavailable.

        Returns (out: bytes, member_crcs: np.uint32, member_lens: np.int64,
        member_in_used: np.int64).
        """
        import os as _os
        if nthreads <= 0:
            # mild oversubscription: table-build phases leave bubbles an
            # extra wave fills. 2x cores measured best once the PCLMUL
            # crc shrank the per-member bubble (4x was +7% before, -5%
            # after — tools/decprof.py)
            nthreads = min(2 * (_os.cpu_count() or 4), 32)
        if pyext is not None:
            offs = np.ascontiguousarray(in_offs, np.int64)
            lens = np.ascontiguousarray(in_lens, np.int64)
            caps = np.ascontiguousarray(out_sizes, np.int64)
            out, lens_b, crcs_b, used_b = pyext.inflate_batch_bytes(
                data, offs, lens, caps, nthreads)
            return (out, np.frombuffer(crcs_b, np.uint32),
                    np.frombuffer(lens_b, np.int64),
                    np.frombuffer(used_b, np.int64))
        arr, crcs, out_lens, in_used = self.inflate_batch(
            data, in_offs, in_lens, out_sizes, nthreads)
        return arr.tobytes(), crcs, out_lens, in_used

    def lz4_batch_bytes(self, data, in_offs, in_lens, out_caps,
                        nthreads: int = 0, want_xxh: bool = False,
                        xxh_seed: int = 0):
        """Batched GIL-free LZ4 block decode into one bytes object
        (in_lens[i] < 0 = stored block of |len| verbatim bytes). Returns
        (out: bytes of sum(out_caps), out_lens: np.int64 — decoded size
        per block, -1 on a malformed block, crcs: np.uint32 — per-block
        crc32 computed cache-warm by the decode workers, xxh: XXH32 of
        the whole output computed by a trailing overlapped thread when
        ``want_xxh``, else/invalid None). The LZ4 mirror of
        inflate_batch_bytes."""
        import os as _os
        if nthreads <= 0:
            nthreads = min(2 * (_os.cpu_count() or 4), 32)
        offs = np.ascontiguousarray(in_offs, np.int64)
        lens = np.ascontiguousarray(in_lens, np.int64)
        caps = np.ascontiguousarray(out_caps, np.int64)
        if pyext is not None and hasattr(pyext, "lz4_batch_bytes"):
            out, lens_b, crcs_b, xh = pyext.lz4_batch_bytes(
                data, offs, lens, caps, nthreads, 1 if want_xxh else 0,
                xxh_seed & 0xFFFFFFFF)
            return (out, np.frombuffer(lens_b, np.int64),
                    np.frombuffer(crcs_b, np.uint32), xh)
        n = len(offs)
        sa = (np.frombuffer(data, np.uint8)
              if not isinstance(data, np.ndarray) else data)
        out_offs = np.zeros(n, np.int64)
        np.cumsum(caps[:-1], out=out_offs[1:])
        total = int(caps.sum())
        dst = np.empty(max(total, 1), np.uint8)
        out_lens = np.empty(n, np.int64)
        crcs = np.empty(n, np.uint32)
        xxh = np.array([xxh_seed & 0xFFFFFFFF, 0], np.uint32)
        self._lib.qz_lz4_decompress_batch(
            self._as_u8p(sa) if len(sa) else self._as_u8p(
                np.empty(1, np.uint8)),
            offs.ctypes.data_as(_i64p), lens.ctypes.data_as(_i64p),
            self._as_u8p(dst), out_offs.ctypes.data_as(_i64p),
            caps.ctypes.data_as(_i64p), out_lens.ctypes.data_as(_i64p),
            n, nthreads,
            crcs.ctypes.data_as(_u32p),
            xxh.ctypes.data_as(_u32p) if want_xxh else None)
        xh = int(xxh[0]) if want_xxh and xxh[1] else None
        return dst[:total].tobytes(), out_lens, crcs, xh

    @staticmethod
    def _stage_chunk_batch(chunks, caps_of):
        """Pointer-array staging shared by the batch compressors.
        Returns (srcs ptr array, lens, views keepalive, dst_off, caps,
        dst, out_len, crcs). ``dst`` comes from the BufferPool, padded
        to 1 MB buckets so steady-state requests reuse one staging
        buffer (qz_malloc pinned-ring analog; measured 6% faster than a
        fresh np.empty per request — refaulting 50+ MB of pages costs
        more than copying the payloads out). Caller must qz_free(dst).
        """
        from .memory import default_pool
        n = len(chunks)
        srcs = (ctypes.c_void_p * n)()
        lens = np.empty(n, np.int64)
        views = []           # keep buffers alive across the call
        for i, ch in enumerate(chunks):
            a = (np.frombuffer(ch, np.uint8)
                 if not isinstance(ch, np.ndarray) else ch)
            views.append(a)
            srcs[i] = a.ctypes.data
            lens[i] = len(a)
        caps = caps_of(lens)
        dst_off = np.zeros(n, np.int64)
        np.cumsum(caps[:-1], out=dst_off[1:])
        padded = max((int(caps.sum()) + (1 << 20) - 1) >> 20 << 20, 1)
        dst = default_pool.qz_malloc(padded)
        return (srcs, lens, views, dst_off, caps, dst,
                np.empty(n, np.int64), np.empty(n, np.uint32))

    def deflate_compress_batch(self, chunks, finals, chain: int = 4,
                               mode: int = 0, nthreads: int = 0):
        """One GIL-free native call compresses a whole chunk batch
        (matcher + packer + crc32 per chunk on a native thread pool) —
        the compress mirror of inflate_batch_bytes and the SW analog of
        the reference's N-process x M-thread harness model. Returns
        (payloads: list of bytes, crcs: np.uint32) or None when any
        chunk overflowed (caller falls back to the per-chunk path)."""
        import os as _os
        from .memory import default_pool
        n = len(chunks)
        if nthreads <= 0:
            nthreads = min(2 * (_os.cpu_count() or 4), 32)
        srcs, lens, _views, dst_off, caps, dst, out_len, crcs = \
            self._stage_chunk_batch(
                chunks, lambda ln: ln + (ln >> 3) + 1024)
        try:
            fin = np.ascontiguousarray(finals, np.uint8)
            self._lib.qz_deflate_compress_batch(
                srcs, lens.ctypes.data_as(_i64p), self._as_u8p(fin),
                chain, mode, self._as_u8p(dst),
                dst_off.ctypes.data_as(_i64p), caps.ctypes.data_as(_i64p),
                out_len.ctypes.data_as(_i64p), crcs.ctypes.data_as(_u32p),
                n, nthreads)
            if (out_len < 0).any():
                return None
            mv = memoryview(dst)
            payloads = [bytes(mv[int(dst_off[i]):
                                 int(dst_off[i] + out_len[i])])
                        for i in range(n)]
            del mv
            return payloads, crcs
        finally:
            default_pool.qz_free(dst)

    def lz4_compress_batch(self, chunks, fmt: str = "lz4",
                           mini_match: int = 3, max_distance: int = 32768,
                           nthreads: int = 0):
        """LZ4/LZ4s mirror of deflate_compress_batch: the whole chunk
        batch compresses in one GIL-free call. Returns (payloads: list
        of bytes, crcs) or None on any per-chunk failure."""
        import os as _os
        from .memory import default_pool
        n = len(chunks)
        if nthreads <= 0:
            nthreads = min(2 * (_os.cpu_count() or 4), 32)
        srcs, lens, _views, dst_off, caps, dst, out_len, crcs = \
            self._stage_chunk_batch(
                chunks, lambda ln: ln + ln // 255 + 64)
        try:
            self._lib.qz_lz4_compress_batch(
                srcs, lens.ctypes.data_as(_i64p),
                1 if fmt == "lz4s" else 0, mini_match, max_distance,
                self._as_u8p(dst), dst_off.ctypes.data_as(_i64p),
                caps.ctypes.data_as(_i64p), out_len.ctypes.data_as(_i64p),
                crcs.ctypes.data_as(_u32p), n, nthreads)
            if (out_len <= 0).any():
                return None
            mv = memoryview(dst)
            payloads = [bytes(mv[int(dst_off[i]):
                                 int(dst_off[i] + out_len[i])])
                        for i in range(n)]
            del mv
            return payloads, crcs
        finally:
            default_pool.qz_free(dst)

    def scan_gzipext(self, data):
        """Walk strict QZ-ext gzip members natively (the checkHeader
        analog specialized to the fixed 24-byte layout). Returns
        (pay_off, pay_len, src_sz, crcs, consumed) as arrays, or None if
        any member is not strict QZ-ext (caller uses the general walk)."""
        sa = (np.frombuffer(data, np.uint8)
              if not isinstance(data, np.ndarray) else data)
        n = len(sa)
        cap = max(n // 34, 1)          # 34 = minimum framed member size
        pay_off = np.empty(cap, np.int64)
        pay_len = np.empty(cap, np.int64)
        src_sz = np.empty(cap, np.int64)
        crcs = np.empty(cap, np.uint32)
        consumed = np.zeros(1, np.int64)
        cnt = self._lib.qz_scan_gzipext(
            self._as_u8p(sa) if n else self._as_u8p(np.empty(1, np.uint8)),
            n, pay_off.ctypes.data_as(_i64p), pay_len.ctypes.data_as(_i64p),
            src_sz.ctypes.data_as(_i64p), crcs.ctypes.data_as(_u32p), cap,
            consumed.ctypes.data_as(_i64p))
        if cnt < 0:
            return None
        c = int(cnt)
        return (pay_off[:c], pay_len[:c], src_sz[:c], crcs[:c],
                int(consumed[0]))

    def crc32_combine_many(self, crcs, lens, init: int = 0) -> int:
        """Fold per-member CRCs (in order) into the whole-buffer CRC —
        the GF(2) shift operator is built once per distinct member length
        (one matrix for the common uniform-chunk case)."""
        c = np.ascontiguousarray(crcs, np.uint32)
        ln = np.ascontiguousarray(lens, np.int64)
        return int(self._lib.qz_crc32_combine_many(
            c.ctypes.data_as(_u32p), ln.ctypes.data_as(_i64p), len(c),
            init & 0xFFFFFFFF))

    def crc32(self, data, crc: int = 0) -> int:
        sa = (np.frombuffer(data, np.uint8)
              if not isinstance(data, np.ndarray) else data)
        return int(self._lib.qz_crc32(
            self._as_u8p(sa) if len(sa) else self._as_u8p(
                np.empty(1, np.uint8)), len(sa), crc & 0xFFFFFFFF))

    def inflate_raw(self, src: bytes, out_cap: int):
        """Fast raw-deflate decode; returns bytes or None on malformed
        input (caller falls back to zlib for the error message)."""
        dst = np.empty(max(out_cap, 1), np.uint8)
        sa = np.frombuffer(src, np.uint8) if src else np.empty(1, np.uint8)
        r = self._lib.qz_inflate_raw(self._as_u8p(sa), len(src),
                                     self._as_u8p(dst), out_cap)
        if r < 0:
            return None
        return dst[:r].tobytes()

    def crc64(self, data, tbl: np.ndarray, crc: int, reflected: bool) -> int:
        sa = (np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray)
              else data)
        n = len(sa)
        return int(self._lib.qz_crc64(
            self._as_u8p(sa) if n else self._as_u8p(np.empty(1, np.uint8)),
            n, tbl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            crc & 0xFFFFFFFFFFFFFFFF, 1 if reflected else 0))

    def lz4_compress_block(self, src: bytes, max_distance: int = 65535) -> bytes:
        n = len(src)
        cap = n + n // 255 + 64
        dst = np.empty(cap, np.uint8)
        sa = np.frombuffer(src, np.uint8) if n else np.empty(0, np.uint8)
        r = self._lib.qz_lz4_compress_block(
            self._as_u8p(sa), n, self._as_u8p(dst), cap, max_distance)
        if r <= 0:
            raise RuntimeError(f"lz4 compress failed rc={r}")
        return dst[:r].tobytes()

    def lz4_decompress_block(self, src: bytes, out_cap: int) -> bytes:
        dst = np.empty(max(out_cap, 1), np.uint8)
        sa = np.frombuffer(src, np.uint8) if src else np.empty(0, np.uint8)
        r = self._lib.qz_lz4_decompress_block(
            self._as_u8p(sa), len(src), self._as_u8p(dst), out_cap)
        if r < 0:
            raise ValueError("malformed LZ4 block")
        return dst[:r].tobytes()

    def lz4s_compress_block(self, src: bytes, mini_match: int = 3,
                            max_distance: int = 32768) -> bytes:
        n = len(src)
        cap = n + n // 255 + 64
        dst = np.empty(cap, np.uint8)
        sa = np.frombuffer(src, np.uint8) if n else np.empty(0, np.uint8)
        r = self._lib.qz_lz4s_compress_block(
            self._as_u8p(sa), n, self._as_u8p(dst), cap, mini_match,
            max_distance)
        if r <= 0:
            raise RuntimeError(f"lz4s compress failed rc={r}")
        return dst[:r].tobytes()

    def lz4s_decode_block(self, src: bytes, mini_match: int = 3):
        """Returns (litlens, matchlens, offsets) uint32 arrays."""
        cap = len(src) + 16
        ll = np.empty(cap, np.uint32)
        mm = np.empty(cap, np.uint32)
        oo = np.empty(cap, np.uint32)
        sa = np.frombuffer(src, np.uint8) if src else np.empty(0, np.uint8)
        r = self._lib.qz_lz4s_decode_block(
            self._as_u8p(sa), len(src), mini_match,
            ll.ctypes.data_as(_u32p), mm.ctypes.data_as(_u32p),
            oo.ctypes.data_as(_u32p), cap)
        if r < 0:
            raise ValueError("malformed LZ4s block")
        return ll[:r].copy(), mm[:r].copy(), oo[:r].copy()

    def _need_zstd(self) -> None:
        if not self.have_zstd:
            raise RuntimeError("zstd is unavailable: the native library was "
                               "built without zstd.h")

    def zstd_post_process(self, src: bytes, lz4s_blocks: bytes,
                          mini_match: int = 3, level: int = 0) -> bytes:
        self._need_zstd()
        cap = int(self._lib.qz_zstd_compress_bound(len(src))) + 4096
        dst = np.empty(cap, np.uint8)
        sa = np.frombuffer(src, np.uint8) if src else np.empty(0, np.uint8)
        la = (np.frombuffer(lz4s_blocks, np.uint8)
              if lz4s_blocks else np.empty(0, np.uint8))
        r = self._lib.qz_zstd_post_process(
            self._as_u8p(sa), len(src), self._as_u8p(la), len(lz4s_blocks),
            mini_match, self._as_u8p(dst), cap, level)
        if r < 0:
            raise RuntimeError(f"zstd post-process failed rc={r}")
        return dst[:r].tobytes()

    def zstd_compress(self, src: bytes, level: int = 3) -> bytes:
        self._need_zstd()
        cap = int(self._lib.qz_zstd_compress_bound(len(src))) + 64
        dst = np.empty(cap, np.uint8)
        sa = np.frombuffer(src, np.uint8) if src else np.empty(0, np.uint8)
        r = self._lib.qz_zstd_compress(self._as_u8p(sa), len(src),
                                       self._as_u8p(dst), cap, level)
        if r < 0:
            raise RuntimeError(f"zstd compress failed rc={r}")
        return dst[:r].tobytes()

    def zstd_decompress(self, src: bytes, out_cap: int) -> bytes:
        self._need_zstd()
        dst = np.empty(max(out_cap, 1), np.uint8)
        sa = np.frombuffer(src, np.uint8) if src else np.empty(0, np.uint8)
        r = self._lib.qz_zstd_decompress(self._as_u8p(sa), len(src),
                                         self._as_u8p(dst), out_cap)
        if r < 0:
            raise RuntimeError(f"zstd decompress failed rc={r}")
        return dst[:r].tobytes()

    @staticmethod
    def _pool():
        from .memory import default_pool
        return default_pool

    def lz77_host(self, src, chain: int = 8) -> np.ndarray:
        """Host hash-chain LZ77 tokenizer (same packed-u32 token format
        as the device tokenizer, ops/lz77.py). The SW codec's fast
        matcher: qz_lz77_host + qz_deflate_pack(mode 0) replaces zlib on
        the software path (qzSWCompress analog) when it wins — measured
        per-core speed AND ratio above zlib L1 (see engines.py)."""
        n = len(src)
        sa = (np.frombuffer(src, np.uint8) if not isinstance(src, np.ndarray)
              else src)
        # worst case ~2 tokens per 5 bytes (1-literal run + 4-byte match
        # alternating) — n/2 + 64 is safely above it (same bound as the
        # C batch); n/3 could overflow on adversarial input and raise
        cap = n // 2 + 64
        toks = np.empty(cap, np.uint32)
        r = self._lib.qz_lz77_host(
            self._as_u8p(sa) if n else self._as_u8p(np.empty(1, np.uint8)),
            n, toks.ctypes.data_as(_u32p), cap, chain)
        if r < 0:
            raise RuntimeError("lz77_host token overflow")
        return toks[:int(r)]

    def deflate_pack(self, src, tokens: np.ndarray, ntok: int,
                     final: bool = True, mode: int = 0) -> bytes:
        """Pack packed-u32 device tokens into a raw deflate stream.

        mode: 0 = best of stored/static/dynamic, 1 = static, 2 = dynamic.
        The dst staging buffer is pooled (qz_malloc/qz_free) — this runs
        once per chunk, the per-instance-buffer-ring hot path.
        """
        n = len(src)
        sa = (np.frombuffer(src, np.uint8) if not isinstance(src, np.ndarray)
              else src)
        toks = np.ascontiguousarray(tokens[:ntok], np.uint32)
        cap = n + n // 8 + 1024
        pool = self._pool()
        dst = pool.qz_malloc(cap)
        try:
            r = self._lib.qz_deflate_pack(
                self._as_u8p(sa) if n else self._as_u8p(np.empty(1, np.uint8)),
                n, toks.ctypes.data_as(_u32p), ntok, self._as_u8p(dst), cap,
                1 if final else 0, mode)
            if r < 0:
                raise RuntimeError("deflate pack overflow")
            return dst[:r].tobytes()
        finally:
            pool.qz_free(dst)

    def lz4_pack(self, src, tokens: np.ndarray, ntok: int) -> bytes:
        n = len(src)
        sa = (np.frombuffer(src, np.uint8) if not isinstance(src, np.ndarray)
              else src)
        toks = np.ascontiguousarray(tokens[:ntok], np.uint32)
        cap = n + n // 128 + 1024
        pool = self._pool()
        dst = pool.qz_malloc(cap)
        try:
            r = self._lib.qz_lz4_pack(
                self._as_u8p(sa) if n else self._as_u8p(np.empty(1, np.uint8)),
                n, toks.ctypes.data_as(_u32p), ntok, self._as_u8p(dst), cap)
            if r <= 0:
                raise RuntimeError("lz4 pack overflow")
            return dst[:r].tobytes()
        finally:
            pool.qz_free(dst)

    def lz4s_pack(self, src, tokens: np.ndarray, ntok: int,
                  mini_match: int = 3) -> bytes:
        n = len(src)
        sa = (np.frombuffer(src, np.uint8) if not isinstance(src, np.ndarray)
              else src)
        toks = np.ascontiguousarray(tokens[:ntok], np.uint32)
        cap = n + n // 128 + 1024
        pool = self._pool()
        dst = pool.qz_malloc(cap)
        try:
            r = self._lib.qz_lz4s_pack(
                self._as_u8p(sa) if n else self._as_u8p(np.empty(1, np.uint8)),
                n, toks.ctypes.data_as(_u32p), ntok, self._as_u8p(dst), cap,
                mini_match)
            if r <= 0:
                raise RuntimeError("lz4s pack overflow")
            return dst[:r].tobytes()
        finally:
            pool.qz_free(dst)

    def deflate_static_block(self, lits: np.ndarray, lens: np.ndarray,
                             dists: np.ndarray, final: bool = True,
                             bitpos: int = 0, dst: np.ndarray | None = None):
        """Pack tokens into a static-Huffman deflate block.

        Returns (bytes_or_none, out_bitpos, nbytes). When ``dst`` is given the
        block is written there (continuing at ``bitpos``); otherwise a fresh
        buffer is returned.
        """
        ntok = len(lits)
        own = dst is None
        if own:
            cap = ntok * 4 + 64
            dst = np.zeros(cap, np.uint8)
            bitpos = 0
        lits = np.ascontiguousarray(lits, np.uint8)
        lens = np.ascontiguousarray(lens, np.uint16)
        dists = np.ascontiguousarray(dists, np.uint16)
        out_bp = ctypes.c_int64(0)
        r = self._lib.qz_deflate_static_block(
            self._as_u8p(lits), lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            dists.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), ntok,
            self._as_u8p(dst), len(dst), bitpos, 1 if final else 0,
            ctypes.byref(out_bp))
        if r < 0:
            raise RuntimeError("deflate bitpack overflow")
        if own:
            return dst[:r].tobytes(), out_bp.value, r
        return None, out_bp.value, r


_lock = threading.Lock()
lib: _NativeLib | None = None


def _load():
    global lib, build_error
    with _lock:
        if lib is not None:
            return
        try:
            lock = open(_BUILD_LOCK, "a")
        except OSError:             # read-only install: load what is there
            lock = None
        try:
            if lock is not None:
                fcntl.flock(lock, fcntl.LOCK_EX)
            if _needs_build() and not _build():
                return
            try:
                lib = _NativeLib(ctypes.CDLL(_SO))
            except (OSError, AttributeError) as e:
                build_error = f"native load failed: {e}"
                sys.stderr.write(f"qztpu_native load failed: {e}\n")
                return
            _load_pyext()
        finally:
            if lock is not None:
                lock.close()        # releases the flock


if os.environ.get("QZTPU_NO_NATIVE") != "1":
    _load()
else:
    build_error = "QZTPU_NO_NATIVE=1"
