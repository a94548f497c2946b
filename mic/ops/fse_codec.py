"""Host FSE/tANS encoders and decoders for 1/2/4/8 interleaved states.

Stream formats (byte-compatible with the reference):

* 1-state: ``[writeCount header][reverse bitstream]`` (fsecompressu16.go:19)
* N-state (N=2,4,8): ``[0xFF][magic][count u32 LE][header][bitstream]``
  where magic is 0x02 / 0x04 / 0x84 (fse2state.go:13, fse4state.go:14,
  fse8state.go:13).

The N interleaved states break the serial ``state -> dt[state] -> state'``
dependency chain: symbols at positions ``i % N == k`` belong to lane *k*.
Encoding walks the input backwards (last symbol first) so the decoder reads
forwards; final states are flushed lane N-1 .. 0 so the decoder reads lane
0 first (fse4state.go:181-190).

The reference's flush32 discipline only prevents accumulator overflow and
never alters the emitted bytes, so these implementations append all
(value, width) pairs in encode order and bit-pack once at the end.

This is the host/reference tier; the device coder (wide-lane rANS) is
in :mod:`mic.device`, and the fast native tier in :mod:`mic.native`.
"""

from __future__ import annotations

import numpy as np

from .bitio import BitWriterLSB, ReverseBitReader
from .fse import (
    DEFAULT_TABLE_LOG,
    IncompressibleError,
    UseRLEError,
    build_ctable,
    build_dtable,
    histogram,
    normalize_count,
    optimal_table_log,
    read_ncount,
)

__all__ = [
    "MAGIC_2STATE",
    "MAGIC_4STATE",
    "MAGIC_8STATE_FSE",
    "MAGIC_8STATE_RANS",
    "fse_compress",
    "fse_decompress",
    "fse_compress_2state",
    "fse_decompress_2state",
    "fse_compress_4state",
    "fse_decompress_4state",
    "fse_compress_8state",
    "fse_decompress_8state",
    "fse_decompress_auto",
    "DECOMPRESS_LIMIT_DEFAULT",
    "ScratchU16",
]

MAGIC_2STATE = b"\xff\x02"
MAGIC_4STATE = b"\xff\x04"
MAGIC_8STATE_FSE = b"\xff\x84"
MAGIC_8STATE_RANS = b"\xff\x08"

DECOMPRESS_LIMIT_DEFAULT = (2 << 30) - 1


def _prepare_tables(data: np.ndarray, table_log_hint: int):
    """Shared encoder front-end: histogram -> tableLog -> normalize -> header.

    Raises UseRLEError / IncompressibleError per the reference gates
    (fsecompressu16.go:39-45).
    """
    n = len(data)
    counts, max_count, symbol_len = histogram(data)
    if max_count == n:
        raise UseRLEError
    if max_count == 1 or max_count < (n >> 15):
        raise IncompressibleError
    table_log = optimal_table_log(table_log_hint, n, symbol_len)
    norm = normalize_count(counts, n, table_log, symbol_len)
    # Reference validateNorm (fsecompressu16.go:58): normalizeCount2's
    # fixed-point redistribution can emit a non-summing table on
    # pathological histograms (many lowprob symbols, tiny tableLog);
    # reject so the caller falls down the state chain instead of
    # spreading a corrupt table.
    if int(np.abs(norm).sum()) != (1 << table_log):
        raise IncompressibleError
    from .fse import write_count

    header = write_count(norm, symbol_len, table_log)
    return norm, symbol_len, table_log, header


def _encode_bitstream(
    data: np.ndarray, norm: np.ndarray, symbol_len: int, table_log: int, n_states: int
) -> bytes:
    """Generic N-lane backwards tANS encode producing the reverse bitstream.

    Positions are processed in descending order; position *i* is encoded by
    lane ``i % N``.  This reproduces the tail-alignment and main-loop symbol
    order of every reference variant (they all reduce to descending order).
    """
    state_table, delta_nb_bits, delta_find_state, _zero_bits = build_ctable(
        norm, symbol_len, table_log
    )
    st = state_table.tolist()
    dnb = delta_nb_bits.tolist()
    dfs = delta_find_state.tolist()
    src = np.asarray(data, dtype=np.uint16).tolist()

    table_size = 1 << table_log
    states = [table_size] * n_states
    values: list[int] = []
    widths: list[int] = []
    vap = values.append
    wap = widths.append

    for i in range(len(src) - 1, -1, -1):
        s = src[i]
        lane = i % n_states
        x = states[lane]
        nb = (x + dnb[s]) >> 16
        vap(x)
        wap(nb)
        states[lane] = st[(x >> nb) + dfs[s]]

    # Final states, lane N-1 .. 0, tableLog bits each.
    for lane in range(n_states - 1, -1, -1):
        vap(states[lane])
        wap(table_log)

    w = BitWriterLSB()
    w.values = values
    w.widths = widths
    return w.close()


def _decode_bitstream(
    bits: bytes,
    new_state: np.ndarray,
    symbol: np.ndarray,
    nb_bits: np.ndarray,
    table_log: int,
    n_states: int,
    count: int | None,
    limit: int = DECOMPRESS_LIMIT_DEFAULT,
) -> np.ndarray:
    """Generic N-lane forward decode.

    With ``count`` given (N>=2 streams carry an exact count), decodes that
    many symbols round-robin across lanes.  With ``count=None`` (1-state),
    termination follows the reference's finished()/final() protocol
    (fsedecompressu16.go:362-375).
    """
    r = ReverseBitReader(bits)
    ns = new_state.tolist()
    sym = symbol.tolist()
    nb = nb_bits.tolist()
    get = r.get_bits

    if count is not None:
        if count > limit:
            raise ValueError(
                f"declared count ({count}) > DecompressLimit ({limit})"
            )
        states = []
        for _ in range(n_states):
            states.append(get(table_log))
        out = [0] * count
        for i in range(count):
            lane = i % n_states
            x = states[lane]
            out[i] = sym[x]
            states[lane] = ns[x] + get(nb[x])
        return np.array(out, dtype=np.uint16)

    # 1-state: implicit termination.
    x = get(table_log)
    out = []
    ap = out.append
    while True:
        if r.pos <= 0 and nb[x] > 0:
            if x != 0:
                ap(sym[x])
            break
        ap(sym[x])
        x = ns[x] + get(nb[x])
        if len(out) >= limit:
            raise ValueError(f"output size ({len(out)}) > DecompressLimit ({limit})")
    return np.array(out, dtype=np.uint16)


def _compress_n_state(
    data: np.ndarray, n_states: int, magic: bytes | None, table_log: int, min_len: int
) -> bytes:
    data = np.asarray(data, dtype=np.uint16)
    n = len(data)
    if n <= min_len:
        raise IncompressibleError
    if n > (2 << 30) - 1:
        raise ValueError("input too big, must be < 2GB")
    norm, symbol_len, actual_tl, header = _prepare_tables(data, table_log)
    bits = _encode_bitstream(data, norm, symbol_len, actual_tl, n_states)
    out = header + bits
    if len(out) >= n * 2:
        raise IncompressibleError
    if magic is None:
        return out
    return magic + int(n).to_bytes(4, "little") + out


def fse_compress(data, table_log: int = DEFAULT_TABLE_LOG) -> bytes:
    """Single-state FSE compress (reference FSECompressU16, fsecompressu16.go:19)."""
    return _compress_n_state(data, 1, None, table_log, 1)


def fse_compress_2state(data, table_log: int = DEFAULT_TABLE_LOG) -> bytes:
    """Two-state FSE (reference FSECompressU16TwoState, fse2state.go:22)."""
    return _compress_n_state(data, 2, MAGIC_2STATE, table_log, 1)


def fse_compress_4state(data, table_log: int = DEFAULT_TABLE_LOG) -> bytes:
    """Four-state FSE (reference FSECompressU16FourState, fse4state.go:24)."""
    return _compress_n_state(data, 4, MAGIC_4STATE, table_log, 3)


def fse_compress_8state(data, table_log: int = DEFAULT_TABLE_LOG) -> bytes:
    """Eight-state FSE (reference FSECompressU16EightState, fse8state.go:31)."""
    return _compress_n_state(data, 8, MAGIC_8STATE_FSE, table_log, 7)


def _decompress_body(
    body: bytes, n_states: int, count: int | None, limit: int
) -> np.ndarray:
    norm, symbol_len, table_log, consumed = read_ncount(body)
    new_state, symbol, nb_bits, _zero_bits = build_dtable(norm, symbol_len, table_log)
    return _decode_bitstream(
        body[consumed:], new_state, symbol, nb_bits, table_log, n_states, count, limit
    )


def fse_decompress(data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT) -> np.ndarray:
    """Single-state FSE decompress (reference FSEDecompressU16)."""
    return _decompress_body(data, 1, None, limit)


def _decompress_n_state(data: bytes, magic: bytes, n_states: int, limit: int):
    if len(data) < 6 or data[:2] != magic:
        raise ValueError(f"fse{n_states}state: missing magic bytes")
    count = int.from_bytes(data[2:6], "little")
    return _decompress_body(data[6:], n_states, count, limit)


def fse_decompress_2state(data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT):
    return _decompress_n_state(data, MAGIC_2STATE, 2, limit)


def fse_decompress_4state(data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT):
    return _decompress_n_state(data, MAGIC_4STATE, 4, limit)


def fse_decompress_8state(data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT):
    return _decompress_n_state(data, MAGIC_8STATE_FSE, 8, limit)


def fse_decompress_auto(data: bytes, limit: int = DECOMPRESS_LIMIT_DEFAULT):
    """Magic-byte auto-dispatch (reference FSEDecompressU16Auto, fse2state.go:96-116):

    ``FF 84`` -> 8-state FSE, ``FF 08`` -> 8-state rANS, ``FF 04`` -> 4-state,
    ``FF 02`` -> 2-state, otherwise single-state.
    """
    if len(data) >= 2 and data[:2] == MAGIC_8STATE_FSE:
        return fse_decompress_8state(data, limit)
    if len(data) >= 2 and data[:2] == MAGIC_8STATE_RANS:
        from .rans import rans_decompress_8state

        return rans_decompress_8state(data, limit)
    if len(data) >= 2 and data[:2] == MAGIC_4STATE:
        return fse_decompress_4state(data, limit)
    if len(data) >= 2 and data[:2] == MAGIC_2STATE:
        return fse_decompress_2state(data, limit)
    return fse_decompress(data, limit)


class ScratchU16:
    """API-parity shim for the reference's ScratchU16 (fseu16.go:62-103):
    per-block knobs carried across calls.  The numpy tier has no buffer
    reuse to manage, so this only carries the tunables.

    >>> s = ScratchU16(); s.TableLog = 12
    >>> blob = s.compress(data); out = s.decompress(blob)
    """

    def __init__(self) -> None:
        self.TableLog = DEFAULT_TABLE_LOG
        self.MaxSymbolValue = 65535
        self.DecompressLimit = DECOMPRESS_LIMIT_DEFAULT
        self.Out: bytes | None = None
        self.OutU16 = None

    def compress(self, data, n_states: int = 1) -> bytes:
        fn = {
            1: fse_compress,
            2: fse_compress_2state,
            4: fse_compress_4state,
            8: fse_compress_8state,
        }[n_states]
        self.Out = fn(data, table_log=self.TableLog)
        return self.Out

    def decompress(self, blob: bytes):
        self.OutU16 = fse_decompress_auto(blob, limit=self.DecompressLimit)
        return self.OutU16
