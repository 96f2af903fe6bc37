"""qatzip_tpu — an accelerator-native lossless codec framework.

A from-scratch re-design of Intel QATzip's capabilities (reference:
liumiaomiaoIntel/QATzip) for a JAX accelerator (an NVIDIA GPU):
gzip/DEFLATE, LZ4, LZ4s and the lz4s→zstd post-process pipeline, with
chunk-data-parallel compression dispatched over a JAX device mesh, XLA
compute programs, a software fallback path, streaming and async APIs, and qzip/qzstd CLI tools.

Quick start::

    import qatzip_tpu as qz
    sess = qz.QzSession()
    sess.setup_deflate()
    blob = sess.compress(b"data...")      # gzip-ext members, stock-gzip readable
    data = sess.decompress(blob)
"""

from .utils.jaxcache import ensure_compile_cache as _ensure_compile_cache

_ensure_compile_cache()

from .constants import (  # noqa: F401
    DataFormat, Direction, HuffmanHdr, PollingMode, CrcType, MemType,
    SessionState, QzError, rc_name,
    QZ_OK, QZ_DUPLICATE, QZ_FORCE_SW, QZ_PARAMS, QZ_FAIL, QZ_BUF_ERROR,
    QZ_DATA_ERROR, QZ_TIMEOUT, QZ_NO_HW, QZ_LOW_MEM, QZ_UNSUPPORTED_FMT,
    QZ_NOSW_NO_HW, QZ_POST_PROCESS_ERROR,
    QZ_SW_BACKUP_OFF, QZ_SW_BACKUP_ON, QZ_AUTO_SELECT_BEST,
    QZ_HW_BUFF_SZ,
)
from .params import (  # noqa: F401
    SessionParams, SessionParamsCommon, SessionParamsDeflate,
    SessionParamsLZ4, SessionParamsLZ4S, get_defaults, set_defaults,
)
from .session import (  # noqa: F401
    QzSession,
    qz_init, qz_close,
    qz_setup_session, qz_setup_session_deflate, qz_setup_session_lz4,
    qz_setup_session_lz4s, qz_teardown_session,
    qz_compress, qz_compress_crc, qz_decompress,
    qz_max_compressed_length, qz_get_status,
)
from .bounds import max_compressed_length  # noqa: F401
from .memory import qz_malloc, qz_free, qz_mem_find_addr, BufferPool  # noqa: F401
from .stream import QzStream, qz_compress_stream, qz_decompress_stream, qz_end_stream  # noqa: F401
from .ops import crc32, crc32_combine, xxh32, adler32  # noqa: F401
from .crc64 import (  # noqa: F401
    Crc64, Crc64Config, Metadata, MetadataBlock,
    qz_set_session_crc64_config, qz_get_session_crc64_config,
    qz_compress_crc64, qz_decompress_crc64,
    qz_allocate_metadata, qz_metadata_block_read, qz_metadata_block_write,
    qz_compress_with_metadata,
)
from .async_engine import (  # noqa: F401
    AQzSession, aqz_init, aqz_stop, AQZ_OK, AQZ_NO_SPACE, AQZ_STOPPED,
)

__version__ = "0.1.0"
