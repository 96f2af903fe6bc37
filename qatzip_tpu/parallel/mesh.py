"""Multi-chip chunk-data-parallel dispatch over a jax.sharding.Mesh.

The reference's only parallelism is data-parallel over independent chunks
and hardware instances (SURVEY.md §2.4): instances from all PCIe devices are
shuffled into one pool (src/qatzip.c:716-729) and threads fan chunk batches
across them. The equivalent here is one logical ``dp`` mesh axis over
every chip: the chunk batch is sharded on its leading axis, each chip
tokenizes its shard with the identical XLA program, and the only collective
is a tiny psum of per-shard stats — compressed members are gathered to host
in submission order for stitching (the doCompressOut ordered-retirement
analog, src/qatzip.c:1733-1750).

All three device compress paths shard: tokenize, static device pack, and
the two-pass dynamic device pack (histograms and trees are per-row, so
both passes shard over ``dp`` with no collectives — the host tree build
between them sees the gathered (B, 316) histograms, which are tiny).

Scaling notes: chunks are independent, so NVLink traffic is O(stats) — the
design scales linearly until host↔device bandwidth saturates, matching the
run_perf_test.sh model of summing per-worker Gbps (SURVEY.md §6).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from ..utils.jaxcache import ensure_compile_cache

ensure_compile_cache()


def make_mesh(devices=None, axis: str = "dp"):
    """Build a 1-D chunk-DP mesh over all (or the given) devices."""
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (axis,))


@functools.lru_cache(maxsize=32)
def _sharded_tokenize(mesh_key, n: int, min_match: int, max_match: int,
                      window: int, ss: int, ov: int, ctx: int,
                      probes: int):
    """Compile the mesh-sharded tokenize step (cached per mesh+shape)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = mesh_key.mesh
    from ..ops.lz77 import lz77_tokenize

    data_s = NamedSharding(mesh, P("dp", None))
    len_s = NamedSharding(mesh, P("dp"))
    ntok_s = NamedSharding(mesh, P("dp"))   # (B,) per-row token counts

    def step(data, lengths):
        toks, ntok = lz77_tokenize(data, lengths, n=n, min_match=min_match,
                                   max_match=max_match, window=window,
                                   search_seg=ss, search_overlap=ov,
                                   ctx_words=ctx, probes=probes)
        # cross-chip stats psum — the per-instance counter aggregation
        # (src/qatzip_counter.c:56-81) done as a collective
        total_tok = jnp.sum(ntok)
        total_in = jnp.sum(lengths)
        return toks, ntok, jnp.stack([total_tok, total_in])

    return jax.jit(step, in_shardings=(data_s, len_s),
                   out_shardings=(data_s, ntok_s, None))


@functools.lru_cache(maxsize=32)
def _sharded_pack(mesh_key, n: int, ss: int, ov: int, ctx: int,
                  probes: int):
    """Compile the mesh-sharded full-device deflate pack (static codes):
    rows are independent, so the batch axis shards over ``dp`` with no
    collectives — the multi-chip leg of the single-call-compress path."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = mesh_key.mesh
    from ..ops.deflate_pack import deflate_pack_device

    data_s = NamedSharding(mesh, P("dp", None))
    len_s = NamedSharding(mesh, P("dp"))

    def step(data, lengths):
        return deflate_pack_device(data, lengths, n=n, search_seg=ss,
                                   search_overlap=ov, ctx_words=ctx,
                                   probes=probes)

    return jax.jit(step, in_shardings=(data_s, len_s),
                   out_shardings=(data_s, len_s))


@functools.lru_cache(maxsize=32)
def _sharded_hist(mesh_key, n: int, ss: int, ov: int, ctx: int,
                  probes: int):
    """Compile dynamic pass 1 (parse + per-chunk histogram) over ``dp``."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = mesh_key.mesh
    from ..ops.deflate_pack import deflate_analyze_hist

    data_s = NamedSharding(mesh, P("dp", None))
    len_s = NamedSharding(mesh, P("dp"))

    def step(data, lengths):
        return deflate_analyze_hist(data, lengths, n=n, search_seg=ss,
                                    search_overlap=ov, ctx_words=ctx,
                                    probes=probes)

    return jax.jit(step, in_shardings=(data_s, len_s),
                   out_shardings=(data_s,) * 5)


@functools.lru_cache(maxsize=32)
def _sharded_dyn_pack(mesh_key, n: int):
    """Compile dynamic pass 2 (per-chunk-tree code lookup + bit-pack)
    over ``dp`` — trees are per-row (B, 286)/(B, 30) operands, so they
    shard with the batch."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = mesh_key.mesh
    from ..ops.deflate_pack import deflate_pack_dynamic

    row_s = NamedSharding(mesh, P("dp", None))
    vec_s = NamedSharding(mesh, P("dp"))

    def step(data, ml, dist, taken, lit, lit_pack, dist_pack, hdr_bits):
        return deflate_pack_dynamic(data, ml, dist, taken, lit, lit_pack,
                                    dist_pack, hdr_bits, n=n)

    return jax.jit(step,
                   in_shardings=(row_s,) * 7 + (vec_s,),
                   out_shardings=(row_s, vec_s))


def mesh_pack_device(mesh, data: np.ndarray, lengths: np.ndarray, *,
                     n: int, search_seg: int = 0, search_overlap: int = 1024,
                     ctx_words: int = 4, probes: int = 6,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Static-Huffman device pack sharded over the ``dp`` axis. The
    batch's leading dim must be divisible by the mesh size."""
    import jax.numpy as jnp

    step = _sharded_pack(_MeshKey(mesh), n, search_seg, search_overlap,
                         ctx_words, probes)
    words, nbits = step(jnp.asarray(data), jnp.asarray(lengths))
    return words, nbits


def mesh_analyze_hist(mesh, data: np.ndarray, lengths: np.ndarray, *,
                      n: int, search_seg: int = 0,
                      search_overlap: int = 1024,
                      ctx_words: int = 4, probes: int = 6):
    """Dynamic pass 1 sharded over ``dp``: returns DEVICE arrays
    (hist, ml, dist, taken, lit) — the parse planes stay sharded on
    device for pass 2; only the tiny histograms go to host."""
    import jax.numpy as jnp

    step = _sharded_hist(_MeshKey(mesh), n, search_seg, search_overlap,
                         ctx_words, probes)
    return step(jnp.asarray(data), jnp.asarray(lengths))


def mesh_pack_dynamic(mesh, data, ml, dist, taken, lit, lit_pack,
                      dist_pack, hdr_bits, *, n: int):
    """Dynamic pass 2 sharded over ``dp``: device arrays in (the pass-1
    planes), per-row trees h2d-sharded with the batch."""
    import jax.numpy as jnp

    step = _sharded_dyn_pack(_MeshKey(mesh), n)
    return step(data, ml, dist, taken, lit, jnp.asarray(lit_pack),
                jnp.asarray(dist_pack), jnp.asarray(hdr_bits))


class _MeshKey:
    """Hashable wrapper so lru_cache can key on a Mesh."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash(tuple(d.id for d in self.mesh.devices.flat))

    def __eq__(self, other):
        return (isinstance(other, _MeshKey)
                and tuple(d.id for d in self.mesh.devices.flat)
                == tuple(d.id for d in other.mesh.devices.flat))


def mesh_tokenize(mesh, data: np.ndarray, lengths: np.ndarray, *, n: int,
                  min_match: int = 4, max_match: int = 258,
                  window: int = 32768, search_seg: int = 0,
                  search_overlap: int = 1024,
                  ctx_words: int = 4, probes: int = 6,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tokenize a chunk batch sharded over the mesh's ``dp`` axis.

    The batch's leading dim must be divisible by the mesh size (pad with
    empty chunks — lengths 0 — to round up).
    """
    import jax.numpy as jnp

    step = _sharded_tokenize(_MeshKey(mesh), n, min_match, max_match,
                             window, search_seg, search_overlap,
                             ctx_words, probes)
    toks, ntok, stats = step(jnp.asarray(data), jnp.asarray(lengths))
    return np.asarray(toks), np.asarray(ntok), np.asarray(stats)
