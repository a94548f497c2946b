"""ctypes bindings for the native host tier (libmicfse.so).

The native tier mirrors the reference's C pipeline role
(ojph/mic_compress_c.c / mic_decompress_c.c via CGO): the fastest
single-host encode/decode path for the byte-oriented stream formats.
Falls back silently to the numpy tier when the library isn't built
(`make -C mic/native`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

__all__ = [
    "available",
    "compress_frame_native",
    "decompress_frame_native",
    "entropy_compress_native",
    "entropy_decompress_native",
    "decompress_strips_native",
    "read_ncount_native",
    "lane_encode_native",
    "normalize_write_count_native",
    "PRED_AVG",
    "PRED_GRAD",
    "PRED_MED",
    "PRED_ZZ",
]

PRED_AVG, PRED_GRAD, PRED_MED, PRED_ZZ = 0, 1, 2, 3

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = os.path.join(os.path.dirname(__file__), "libmicfse.so")
    if not os.path.exists(path):
        _LIB = False
        return False
    lib = ctypes.CDLL(path)
    lib.mic_decompress_frame.restype = ctypes.c_int
    lib.mic_decompress_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mic_compress_frame.restype = ctypes.c_size_t
    lib.mic_compress_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint16,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.mic_entropy_compress.restype = ctypes.c_size_t
    lib.mic_entropy_compress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.mic_entropy_decompress.restype = ctypes.c_size_t
    lib.mic_entropy_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
    ]
    # Optional symbols (absent if an older build of the library is already
    # mapped into this process — dlopen caches by path).
    try:
        lib.mic_read_ncount.restype = ctypes.c_size_t
        lib.mic_read_ncount.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p,
        ]
    except AttributeError:
        pass
    try:
        lib.mic_decompress_strips.restype = ctypes.c_int
        lib.mic_decompress_strips.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int,
        ]
    except AttributeError:
        pass
    try:
        lib.mic_compress_strips.restype = ctypes.c_size_t
        lib.mic_compress_strips.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint16,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
    except AttributeError:
        pass
    try:
        lib.mic_normalize_write_count.restype = ctypes.c_size_t
        lib.mic_normalize_write_count.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ]
    except AttributeError:
        pass
    try:
        lib.mic_lane_encode.restype = ctypes.c_size_t
        lib.mic_lane_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ]
    except AttributeError:
        pass
    _LIB = lib
    return lib


def available() -> bool:
    return bool(_load())


def decompress_frame_native(blob: bytes, width: int, height: int, kind: int = PRED_AVG) -> np.ndarray:
    lib = _load()
    if not lib:
        raise RuntimeError("libmicfse.so not built (make -C mic/native)")
    out = np.empty(width * height, dtype=np.uint16)
    rc = lib.mic_decompress_frame(
        blob, len(blob), width, height, kind, out.ctypes.data_as(ctypes.c_void_p)
    )
    if rc != 0:
        raise ValueError(f"native decode failed (code {rc})")
    return out


_VALID_PREDS = (0, 1, 2, 3)  # PRED_AVG/GRAD/MED/ZZ
_VALID_STATES = (1, 2, 4, 8)


def _check_kind_states(kind: int, n_states: int) -> None:
    """Descriptive errors for the classic footgun: passing the state
    count positionally where the predictor goes silently selected an
    invalid predictor and timed the failure-return path once — hence
    keyword-only kind/n_states everywhere."""
    if kind not in _VALID_PREDS:
        raise ValueError(
            f"invalid predictor kind={kind!r}; use PRED_AVG/PRED_GRAD/"
            f"PRED_MED/PRED_ZZ (did you mean n_states={kind}?)")
    if n_states not in _VALID_STATES:
        raise ValueError(f"invalid n_states={n_states!r}; must be 1, 2, 4 or 8")


def compress_frame_native(
    pixels: np.ndarray, width: int, height: int, max_value: int,
    *, kind: int = PRED_AVG, n_states: int = 2,
) -> bytes:
    lib = _load()
    if not lib:
        raise RuntimeError("libmicfse.so not built (make -C mic/native)")
    _check_kind_states(kind, n_states)
    px = np.ascontiguousarray(pixels, dtype=np.uint16)
    cap = px.nbytes * 2 + 4096
    out = (ctypes.c_uint8 * cap)()
    n = lib.mic_compress_frame(
        px.ctypes.data_as(ctypes.c_void_p), width, height, max_value, kind,
        n_states, out, cap,
    )
    if n == 0:
        raise ValueError("native compress failed (incompressible or error)")
    return bytes(bytearray(out)[:n])


def entropy_compress_native(symbols: np.ndarray, n_states: int = 4) -> bytes:
    lib = _load()
    if not lib:
        raise RuntimeError("libmicfse.so not built")
    s = np.ascontiguousarray(symbols, dtype=np.uint16)
    cap = s.nbytes * 2 + 4096
    out = (ctypes.c_uint8 * cap)()
    n = lib.mic_entropy_compress(s.ctypes.data_as(ctypes.c_void_p), len(s), n_states, out, cap)
    if n == 0:
        raise ValueError("native entropy compress failed")
    return bytes(bytearray(out)[:n])


def entropy_decompress_native(blob: bytes, max_symbols: int) -> np.ndarray:
    lib = _load()
    if not lib:
        raise RuntimeError("libmicfse.so not built")
    out = np.empty(max_symbols, dtype=np.uint16)
    n = lib.mic_entropy_decompress(blob, len(blob), out.ctypes.data_as(ctypes.c_void_p), max_symbols)
    if n == 0:
        raise ValueError("native entropy decompress failed")
    return out[:n]


def read_ncount_native(data: bytes):
    """Native normalized-count header reader (reference fseu16.go
    readNCount semantics; ~1000x the pure-Python nibble loop).  Returns
    (norm int32[symbol_len], symbol_len, table_log, consumed) or None if
    the native library is unavailable or the header is invalid."""
    lib = _load()
    if not lib or not hasattr(lib, "mic_read_ncount"):
        return None
    out = np.zeros(65536, dtype=np.int32)
    meta = np.zeros(2, dtype=np.int32)
    n = lib.mic_read_ncount(
        bytes(data), len(data), out.ctypes.data, 65536, meta.ctypes.data
    )
    if n == 0:
        return None
    sl, tl = int(meta[0]), int(meta[1])
    return out[:sl].copy(), sl, tl, int(n)


def decompress_strips_native(blob: bytes, kind: int = PRED_AVG, n_threads: int = 0):
    """Threaded PICS decode (reference mic_parallel.c analog).  Returns
    (pixels, width, height)."""
    import struct

    lib = _load()
    if not lib or not hasattr(lib, "mic_decompress_strips"):
        raise RuntimeError("libmicfse.so lacks mic_decompress_strips (rebuild)")
    if len(blob) < 20 or blob[:4] != b"PICS":
        raise ValueError("not a PICS container")
    width, height = struct.unpack_from("<II", blob, 4)
    out = np.empty(width * height, dtype=np.uint16)
    rc = lib.mic_decompress_strips(blob, len(blob), kind, out.ctypes.data, n_threads)
    if rc != 0:
        raise ValueError(f"native strips decode failed (code {rc})")
    return out, width, height


def compress_strips_native(pixels: np.ndarray, width: int, height: int,
                           max_value: int, *, kind: int = PRED_AVG,
                           n_states: int = 4, num_strips: int = 0,
                           n_threads: int = 0):
    """Whole-container PICS encode on the native std::thread pool
    (mic_compress_strips — the encode mirror of decompress_strips_native).
    Byte-identical to parallel/strips.py's per-strip assembly.  Returns
    the container bytes, or None when the library lacks the symbol or
    any strip is incompressible (caller falls back to the Python tier)."""
    lib = _load()
    if not lib or not hasattr(lib, "mic_compress_strips"):
        return None
    _check_kind_states(kind, n_states)
    px = np.ascontiguousarray(pixels, dtype=np.uint16)
    if num_strips <= 0:
        num_strips = os.cpu_count() or 1
    cap = px.nbytes * 2 + 4096 + 8 * (num_strips + 2)
    out = (ctypes.c_uint8 * cap)()
    n = lib.mic_compress_strips(
        px.ctypes.data_as(ctypes.c_void_p), width, height, max_value,
        kind, n_states, num_strips, n_threads, out, cap,
    )
    if n == 0:
        return None
    return bytes(bytearray(out)[:n])


def lane_encode_native(syms: np.ndarray, lanes: int, table_log: int,
                       freq_of: np.ndarray, cumul_of: np.ndarray,
                       slot_of: np.ndarray | None = None):
    """Reverse lane-interleaved rANS encode (the MICT/FF 41 hot loop);
    returns (states u32[lanes], words u16[n_words]) or None when the
    library lacks the symbol.  Mirrors device_rans._lane_encode bit for
    bit — cross-checked by tests/test_native.py."""
    lib = _load()
    if not lib or not hasattr(lib, "mic_lane_encode"):
        return None
    def _as_u32(a):
        # int32 tables reinterpret for free (values < 2^31); anything
        # else converts.  The int64 tables device_tables used to emit
        # cost a 0.5 MB copy per candidate on wide alphabets.
        a = np.asarray(a)
        if a.dtype == np.int32:
            a = a.view(np.uint32)
        elif a.dtype != np.uint32:
            a = a.astype(np.uint32)
        return np.ascontiguousarray(a)

    syms = np.ascontiguousarray(syms, dtype=np.uint16)
    freq_of = _as_u32(freq_of)
    cumul_of = _as_u32(cumul_of)
    n = len(syms)
    if n and int(syms.max()) >= len(freq_of):
        raise ValueError("lane encode: symbol beyond table range")
    states = np.empty(lanes, dtype=np.uint32)
    words = np.empty(max(n, 1), dtype=np.uint16)
    sl_ptr = None
    if slot_of is not None:
        slot_of = np.ascontiguousarray(slot_of, dtype=np.uint32)
        sl_ptr = slot_of.ctypes.data
    n_words = lib.mic_lane_encode(
        syms.ctypes.data, n, lanes, table_log,
        freq_of.ctypes.data, cumul_of.ctypes.data, sl_ptr,
        states.ctypes.data, words.ctypes.data, len(words),
    )
    if n_words == ctypes.c_size_t(-1).value:
        raise ValueError("native lane encode failed (corrupt tables)")
    return states, words[:n_words].copy()


def normalize_write_count_native(counts: np.ndarray, total: int,
                                 table_log: int, symbol_len: int):
    """Combined normalize_count + write_count (bit-identical to the
    Python pair — same Go-derived algorithm both sides, pinned by
    tests/test_native.py).  Returns (norm int64[symbol_len], header
    bytes) or None when the library lacks the symbol or normalization
    needs a retry the caller handles (returns None on native failure so
    the Python path decides)."""
    lib = _load()
    if not lib or not hasattr(lib, "mic_normalize_write_count"):
        return None
    c = np.ascontiguousarray(counts[:symbol_len], dtype=np.uint32)
    norm = np.empty(symbol_len, dtype=np.int32)
    cap = 2 * symbol_len + 64
    hdr = np.empty(cap, dtype=np.uint8)
    n = lib.mic_normalize_write_count(
        c.ctypes.data, total, table_log, symbol_len,
        norm.ctypes.data, hdr.ctypes.data, cap,
    )
    if n == 0:
        return None
    return norm.astype(np.int64), hdr[:n].tobytes()
