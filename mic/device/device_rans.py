"""Wide-lane interleaved rANS — the device entropy coder.

This is the device generalization of the reference's multi-state ANS:
where the reference interleaves 2/4/8 tANS states to fill a CPU's
out-of-order pipelines (fse2state.go … fse8state.go, rans8state.go), the
device coder interleaves **L = 128·K lanes** so every lane (one GPU
thread in the decode kernel) carries an independent rANS chain.  Three
device-first choices:

* **Word-granular renormalization** (classic ryg-style rANS): states are
  u32 in [2^16, 2^32); each decode step consumes 0 or 1 whole u16 word —
  no per-lane bit buffers, so the hot loop is pure u32 vector arithmetic
  (mul/shift/add/select) plus one small table gather.

* **Decoder-order word interleaving**: the encoder walks symbols
  backwards and emits renorm words so that the forward-reading decoder
  finds, at every step, the words for exactly the lanes that renorm, in
  lane order.  The decoder keeps ONE dense cursor; per-step distribution
  is an exclusive prefix-sum over the renorm mask (a log-depth scan)
  plus a contiguous-window gather.

* **Shared header machinery**: symbol statistics ride the same
  normalized-count header as the host FSE formats (write_count /
  read_ncount), so tableLog adaptation and ratio behaviour carry over.

Stream layout (new format, magic 0xFF 0x57 'W'):

    FF 57 | log2_lanes u8 | table_log u8 | count u32 | n_words u32
    normalized-count header (write_count)
    initial states: L x u32 LE  (the decoder's per-lane starting states)
    renorm words:  n_words x u16 LE  (decoder order)

Symbol i belongs to lane ``i % L`` at step ``i // L``; a final partial
step covers ``count % L`` lanes.  Every lane's state must return to
exactly RANS_L (2^16) after the last symbol — a free integrity check the
byte-oriented reference formats don't have.
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.fse import (
    DEFAULT_TABLE_LOG,
    IncompressibleError,
    UseRLEError,
    histogram,
    normalize_count,
    optimal_table_log,
    read_ncount,
    write_count,
)

__all__ = [
    "MICT_MAGIC",
    "MICT_ALIAS_MAGIC",
    "RANS_L",
    "mict_encode",
    "mict_decode_numpy",
    "mict_parse",
    "device_tables",
    "alias_construct",
    "alias_slot_tables",
    "slot_tables",
]

MICT_MAGIC = b"\xffW"
MICT_ALIAS_MAGIC = b"\xffA"  # alias-mapped slot permutation (see alias_construct)
RANS_L = 1 << 16  # state lower bound / renorm threshold
ALIAS_MAX_KEPT = 255  # kept symbols per alias stream (alphabet incl. ESC <= 256)


class AliasInfeasible(ValueError):
    """No 128-bucket/2-symbol alias layout exists for this normalized
    distribution (alphabet > 256, or pairing strands a symbol) — the
    encoder folds more of the tail into ESC and retries."""


def _freqs_from_norm(norm: np.ndarray) -> np.ndarray:
    """Device frequencies: low-probability (-1) symbols get freq 1; plain
    symbol-order cumulation (the device format's own convention).
    int32: values are <= 2^15 and the native lane encoder reinterprets
    int32 as u32 without the per-call copy an int64 table forces."""
    return np.where(norm == -1, 1, np.maximum(norm, 0)).astype(np.int32)


def _hist_or_counts(symbols: np.ndarray, counts: np.ndarray | None):
    """histogram(), or derive (counts, max_count, symbol_len) from a
    caller-supplied bincount — the trial-set encoders already bincount
    every candidate for the H0 size estimate, so the encode entries
    accept it instead of re-scanning the stream (2-3 bincounts per
    candidate otherwise: estimate + standard + alias encode)."""
    if counts is None:
        return histogram(symbols)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    if symbols.size and int(symbols.max()) >= counts.size:
        # A mismatched bincount (stale stream, pre-cast counts) would
        # otherwise emit a blob that silently decodes to wrong pixels.
        raise ValueError("counts shorter than the symbol range")
    return counts, int(counts.max()) if counts.size else 0, int(counts.size)


def encode_tables(norm: np.ndarray, table_log: int):
    """Encoder-side tables only (freq_sym, cumul_sym).  device_tables
    additionally materializes the 2^tl slot-indexed DECODE arrays the
    encoder never touches (~70 us/candidate at tl=12 — the trial-set
    encoders call this dozens of times per frame)."""
    freqs = _freqs_from_norm(norm)
    if int(freqs.sum()) != (1 << table_log):
        raise ValueError("encode_tables: freqs do not sum to table size")
    cumul = np.concatenate(([0], np.cumsum(freqs)))[:-1].astype(np.int32)
    return freqs, cumul


def device_tables(norm: np.ndarray, table_log: int):
    """Build the slot-indexed decode table and symbol-indexed encode table.

    Decode step (per lane):  slot = x & mask
        x' = freq[slot] * (x >> tl) + bias[slot]       (bias = slot-local)
        if x' < 2^16:  x' = (x' << 16) | next_word

    Returns (sym[2^tl] u16, freq_slot[2^tl] u32, bias_slot[2^tl] u32,
             freq_sym, cumul_sym).
    """
    freqs, cumul = encode_tables(norm, table_log)
    table_size = 1 << table_log
    present = np.nonzero(freqs)[0]
    sym = np.repeat(present, freqs[present]).astype(np.uint16)
    slot = np.arange(table_size, dtype=np.int64)
    freq_slot = freqs[sym].astype(np.uint32)
    # bias = slot - cumul[sym]  ∈ [0, freq)
    bias_slot = (slot - cumul[sym]).astype(np.uint32)
    return sym, freq_slot, bias_slot, freqs, cumul


def alias_construct(norm: np.ndarray, table_log: int):
    """Deterministic integer Vose alias layout over exactly 128 buckets.

    The 2^tl decode slots are regrouped into 128 equal buckets of
    K = 2^(tl-7) slots, each holding at most TWO symbols: a *primary*
    occupying the first ``t`` slots and an *alias* filling the rest.
    This is the classic alias-method construction (Vose '91; Giesen's
    "rANS with static probability distributions" applies it to ANS).
    The layout was chosen for a 128-wide hardware gather: bucket = slot
    >> (tl-7) always fits one gather row.  It is a frozen stream family
    now; the decoder expands it to a flat slot table
    (:func:`alias_slot_tables`) like the standard layout.

    Both encoder and decoder derive the layout from the normalized
    counts with THIS routine (stacks popped from the end, buckets filled
    in ascending order), so nothing extra rides the stream header.

    Returns a dict with per-bucket arrays (length 128) ``p``/``a``
    (symbol values u16), ``t`` (primary slot count, 1..K), ``fp``/``fa``
    (frequencies), ``sbp``/``sba`` (the running per-symbol slot index of
    each bucket's first primary/alias slot — the decode bias base), plus
    ``slot_of`` (u32[2^tl]): the encoder's permutation, mapping
    cumul[s] + j -> slot for symbol s's j-th slot.
    """
    if table_log < 7:
        raise ValueError("alias_construct: table_log must be >= 7")
    M = 1 << table_log
    K = M >> 7
    freqs = _freqs_from_norm(norm)
    if int(freqs.sum()) != M:
        raise ValueError("alias_construct: freqs do not sum to table size")
    syms = np.nonzero(freqs)[0]
    if len(syms) > 256:
        # 128 buckets x <=2 symbols: alphabets beyond 256 are infeasible
        # by counting; the encoder escape-folds the tail first.
        raise AliasInfeasible(f"alphabet {len(syms)} > 256")
    # Plain-int loop state (numpy scalar indexing at 128x2 pops measured
    # ~1ms/call and dominated alias encode); slot_of fills once at the
    # end from the collected runs.
    w = [int(v) for v in freqs[syms]]
    cumul = np.zeros(len(syms) + 1, np.int64)
    np.cumsum(freqs[syms], out=cumul[1:])
    cm = [int(v) for v in cumul[:-1]]
    # Deterministic stacks: indices ascending, pop from the end.
    small = [i for i in range(len(syms)) if w[i] < K]
    large = [i for i in range(len(syms)) if w[i] >= K]
    p_arr = np.zeros(128, np.int64)
    a_arr = np.zeros(128, np.int64)
    t_arr = np.zeros(128, np.int64)
    sbp = np.zeros(128, np.int64)
    sba = np.zeros(128, np.int64)
    counter = [0] * len(syms)  # slots assigned so far per symbol
    run_src = []  # (standard-layout start, alias-slot start, length)
    for b in range(128):
        if small:
            p = small.pop()
            t = w[p]
            w[p] = 0
            if large:
                a = large[-1]
                w[a] -= K - t
                if w[a] == 0:
                    large.pop()
                elif w[a] < K:
                    small.append(large.pop())
            else:
                # Alphabets in (128, 256] can exhaust larges while smalls
                # remain; pair two smalls when their weights cover the
                # bucket (deterministic: alias = max-weight small, lowest
                # index on ties).  When no pairing covers K the layout is
                # infeasible — the encoder retries with a smaller kept set.
                if not small:
                    raise AliasInfeasible("stranded small symbol")
                ai = max(range(len(small)), key=lambda i: w[small[i]])
                a = small[ai]
                if w[a] < K - t:
                    raise AliasInfeasible("no alias covers the bucket")
                w[a] -= K - t
                if w[a] == 0:
                    small.pop(ai)
        else:
            # No smalls left: take a whole-bucket run from a large symbol;
            # a sub-K remainder re-enters the small stack for later buckets.
            p = large[-1]
            t = K
            a = p
            w[p] -= K
            if w[p] == 0:
                large.pop()
            elif w[p] < K:
                small.append(large.pop())
        p_arr[b], a_arr[b], t_arr[b] = p, a, t
        sbp[b] = counter[p]
        run_src.append((cm[p] + counter[p], b * K, t))
        counter[p] += t
        if t < K:
            sba[b] = counter[a]
            run_src.append((cm[a] + counter[a], b * K + t, K - t))
            counter[a] += K - t
        else:
            sba[b] = counter[a] if a != p else 0
    # slot_of[std_start + j] = alias_start + j for each run, vectorized:
    # repeat the per-run (alias_start - std_start) delta across its
    # length and add the global ramp restarted at each std_start.
    starts = np.array([r[0] for r in run_src], np.int64)
    dsts = np.array([r[1] for r in run_src], np.int64)
    lens = np.array([r[2] for r in run_src], np.int64)
    order = np.argsort(starts, kind="stable")  # std-layout order
    starts, dsts, lens = starts[order], dsts[order], lens[order]
    delta = np.repeat(dsts - starts, lens)
    slot_of = (np.arange(M, dtype=np.int64) + delta).astype(np.uint32)
    f = freqs[syms]
    return {
        "syms": syms,
        "cumul": cumul,
        "p": syms[p_arr].astype(np.uint32),
        "a": syms[a_arr].astype(np.uint32),
        "t": t_arr.astype(np.uint32),
        "fp": f[p_arr].astype(np.uint32),
        "fa": f[a_arr].astype(np.uint32),
        "sbp": sbp.astype(np.uint32),
        "sba": sba.astype(np.uint32),
        "slot_of": slot_of,
    }


def alias_slot_tables(norm: np.ndarray, table_log: int):
    """Slot-indexed decode tables for an alias-mapped stream — the same
    (sym, freq, bias) triple device_tables returns for the standard
    layout, so every slot-table decoder (XLA scan, numpy, JS) handles
    alias streams without structural changes."""
    al = alias_construct(norm, table_log)
    M = 1 << table_log
    K = M >> 7
    off = np.tile(np.arange(K, dtype=np.int64), 128)
    bkt = np.repeat(np.arange(128, dtype=np.int64), K)
    is_p = off < al["t"][bkt]
    sym = np.where(is_p, al["p"][bkt], al["a"][bkt]).astype(np.uint16)
    freq_slot = np.where(is_p, al["fp"][bkt], al["fa"][bkt]).astype(np.uint32)
    bias_slot = np.where(
        is_p, al["sbp"][bkt] + off, al["sba"][bkt] + off - al["t"][bkt]
    ).astype(np.uint32)
    freqs, cumul = encode_tables(norm, table_log)
    return sym, freq_slot, bias_slot, freqs, cumul


def slot_tables(norm: np.ndarray, table_log: int, alias: bool):
    """Dispatch to the standard or alias slot-table builder."""
    return (alias_slot_tables if alias else device_tables)(norm, table_log)


def mict_encode(
    symbols,
    lanes: int | None = None,
    table_log: int = DEFAULT_TABLE_LOG,
    max_table_log: int | None = None,
    max_bytes: int | None = None,
    alias: bool = False,
    counts: np.ndarray | None = None,
) -> bytes:
    """Encode a u16 symbol stream into the MICT wide-lane rANS format.

    Fully vectorized across lanes (numpy): the per-step work is u64
    arithmetic on L-vectors; total host work is O(n) with n/L vector steps.

    ``alias=True`` writes the alias-mapped variant (magic FF 41): the
    same stream layout with slots permuted per alias_construct, which
    every slot-table decoder handles through its flat slot table.
    Ratio is unchanged (same normalized
    frequencies, same renorm); tableLog must be >= 7 (128 buckets).
    """
    # Default lane width per family: 512 for FF 57, 128 for FF 41 (the
    # alias layout's 128 buckets were sized for 128-lane decoders).
    if lanes is None:
        lanes = 128 if alias else 512
    if alias:
        return mict_encode_alias(
            symbols, lanes=lanes, table_log=table_log,
            max_table_log=max_table_log, max_bytes=max_bytes, counts=counts,
        )
    symbols = np.asarray(symbols, dtype=np.uint16)
    n = len(symbols)
    if n == 0:
        raise IncompressibleError
    counts, max_count, symbol_len = _hist_or_counts(symbols, counts)
    if max_count == n:
        raise UseRLEError
    if max_count == 1 or max_count < (n >> 15):
        raise IncompressibleError
    tl = optimal_table_log(table_log, n, symbol_len)
    if max_table_log is not None and tl > max_table_log:
        # Hard cap (the adaptive rule bumps tl up by symbol density); the
        # MICW encoder's caps are in strips.py.
        tl = max_table_log
    try:
        norm, header = _norm_and_header(counts, n, tl, symbol_len)
        freq, cumul = encode_tables(norm, tl)
    except ValueError as e:
        # Alphabet too wide for the clamped tableLog (tiny inputs) — the
        # same inputs the host FSE formats reject with an error.
        raise IncompressibleError(str(e)) from e

    states, words = _lane_encode(symbols.astype(np.int64), n, int(lanes), tl, freq, cumul)

    out = bytearray()
    out += MICT_MAGIC
    out += struct.pack("<BB", int(np.log2(int(lanes))), tl)
    out += struct.pack("<II", n, len(words))
    out += header
    out += states.astype("<u4").tobytes()
    out += words.astype("<u2").tobytes()
    # Reject when the blob exceeds the caller's byte budget (default:
    # the stream's own raw size; MICW's r-modes pass the STRIP's raw
    # size instead — their SoA stream is already much shorter than the
    # pixel count, so a locally "incompressible" blob can still beat
    # raw pixels by a wide margin).
    if len(out) >= (n * 2 if max_bytes is None else max_bytes):
        raise IncompressibleError
    return bytes(out)


def _norm_and_header(counts, n, tl, sl):
    """normalize_count + write_count pair, native when built (the two
    dominated micw_compress once the lane loop went native — same
    Go-derived algorithms both sides, bit-identity pinned by
    tests/test_native.py)."""
    from ..native import normalize_write_count_native

    nat = normalize_write_count_native(counts, n, tl, sl)
    if nat is not None:
        return nat
    norm = normalize_count(counts, n, tl, sl)
    if int(np.abs(norm).sum()) != (1 << tl):  # reference validateNorm
        raise ValueError("normalize: table does not sum to 1<<tableLog")
    return norm, write_count(norm, sl, tl)


def _lane_encode(sym_i64, n, L, tl, freq_of, cumul_of, slot_of=None):
    """Reverse lane-interleaved rANS encode shared by the standard and
    alias paths (slot written = cumul+j, or slot_of[cumul+j] when the
    alias permutation is given).  Returns (states u64[L], words u16).

    Dispatches to the native C++ loop when built (mic_lane_encode,
    bit-identical; the numpy per-step vector calls are ~100x slower and
    dominated the whole transcode-ingest pipeline)."""
    from ..native import lane_encode_native

    nat = lane_encode_native(
        np.asarray(sym_i64[:n], dtype=np.uint16), int(L), int(tl),
        freq_of, cumul_of, slot_of,
    )
    if nat is not None:
        states, words = nat
        return states.astype(np.uint64), words

    n_steps = (n + L - 1) // L
    states = np.full(L, RANS_L, dtype=np.uint64)
    # Renorm bound: emit while x >= freq << (32 - tl)  (single-word renorm).
    shift = 32 - tl

    step_words: list[np.ndarray] = []
    lane_idx = np.arange(L)

    for t in range(n_steps - 1, -1, -1):
        base = t * L
        cnt = min(L, n - base)
        s = sym_i64[base : base + cnt]
        if cnt < L:
            active = lane_idx < cnt
            s_full = np.zeros(L, dtype=np.int64)
            s_full[:cnt] = s
        else:
            active = None
            s_full = s
        f = freq_of[s_full].astype(np.uint64)
        c = cumul_of[s_full].astype(np.uint64)
        if active is not None:
            f = np.where(active, f, np.uint64(1))  # avoid div-by-zero on pad lanes
        x = states
        x_max = f << np.uint64(shift)
        need = x >= x_max
        if active is not None:
            need &= active
        if need.any():
            # Words for renorming lanes, lane-ascending.  Steps are emitted
            # in reverse (t descending) and the block list reversed at the
            # end, yielding (step asc, lane asc) = decoder order.
            step_words.append((x[need] & np.uint64(0xFFFF)).astype(np.uint16))
            x = np.where(need, x >> np.uint64(16), x)
        if slot_of is not None:
            x_new = ((x // f) << np.uint64(tl)) + slot_of[(x % f) + c]
        else:
            x_new = ((x // f) << np.uint64(tl)) + (x % f) + c
        if active is not None:
            x_new = np.where(active, x_new, x)
        states = x_new

    words = (
        np.concatenate(step_words[::-1]) if step_words else np.zeros(0, dtype=np.uint16)
    )
    return states, words


def _alias_plan(counts, symbol_len, kept: int):
    """Folding PLAN for a symbol stream's tail: keep the ``kept`` most
    frequent values (count desc, value asc); rare occurrences recode as
    ``esc_val`` (the smallest value with zero count).  O(alphabet) — the
    O(n) stream recode (:func:`_alias_apply`) runs once, only after a
    feasible layout is found, not on every kept-reduction retry.

    Returns (kept_vals, counts2, symbol_len2, esc_val)."""
    nzv = np.nonzero(counts)[0]
    order = np.lexsort((nzv, -counts[nzv]))  # count desc, value asc
    kept_vals = np.sort(nzv[order[:kept]])
    zero = np.nonzero(counts == 0)[0]
    if len(zero):
        esc_val = int(zero[0])
    elif symbol_len <= 65535:
        esc_val = symbol_len
    else:
        raise IncompressibleError("alias: no free symbol value for ESC")
    sl2 = max(int(kept_vals.max()), esc_val) + 1
    counts2 = np.zeros(sl2, np.int64)
    counts2[kept_vals] = counts[kept_vals]
    n_rare = int(counts[nzv].sum() - counts[kept_vals].sum())
    counts2[esc_val] = n_rare
    return kept_vals, counts2, sl2, esc_val


def _alias_apply(symbols, kept_vals, esc_val):
    """Apply a fold plan to the stream: (recoded i64[n], esc_values
    u16 in stream order)."""
    is_kept = np.zeros(65536, bool)
    is_kept[kept_vals] = True
    rare_mask = ~is_kept[symbols]
    esc_values = symbols[rare_mask].astype(np.uint16)
    recoded = np.where(rare_mask, esc_val, symbols).astype(np.int64)
    return recoded, esc_values


def _alias_fold(symbols, counts, symbol_len, kept: int):
    """Escape-fold a symbol stream's tail (plan + apply in one call;
    kept for tests/direct callers).  Returns (recoded i64[n], counts2,
    symbol_len2, esc_val, esc_values)."""
    kept_vals, counts2, sl2, esc_val = _alias_plan(counts, symbol_len, kept)
    recoded, esc_values = _alias_apply(symbols, kept_vals, esc_val)
    return recoded, counts2, sl2, esc_val, esc_values


def alias_encode_plan(counts, symbol_len, n, table_log, max_table_log=None):
    """The FULL byte-format-defining alias encode setup, shared by the
    host encoder (mict_encode_alias) and the device batch encoder
    (device_encode.mict_encode_device_batch) so the two can never drift:
    kept-reduction retry loop, tableLog clamp (hard 12, part of the FF 41
    format), normalization + ncount header, tables, and
    the alias layout.  Returns (kept_vals, esc_val, tl, header, freq,
    cumul, al); raises the usual sentinel errors."""
    counts = np.asarray(counts[:symbol_len], dtype=np.int64)
    kept = min(int((counts > 0).sum()), ALIAS_MAX_KEPT)
    while True:
        kept_vals, counts2, sl2, esc_val = _alias_plan(counts, symbol_len, kept)
        tl = optimal_table_log(table_log, n, sl2)
        tl = min(tl, 12 if max_table_log is None else min(max_table_log, 12))
        tl = max(tl, 7)  # 128 buckets need at least 128 slots
        try:
            norm, header = _norm_and_header(counts2, n, tl, sl2)
            freq, cumul = encode_tables(norm, tl)
            al = alias_construct(norm, tl)
            return kept_vals, esc_val, tl, header, freq, cumul, al
        except AliasInfeasible:
            kept -= 64
            if kept < 8:
                raise IncompressibleError("alias layout infeasible")
        except ValueError as e:
            raise IncompressibleError(str(e)) from e


def mict_encode_alias(
    symbols,
    lanes: int = 128,
    table_log: int = DEFAULT_TABLE_LOG,
    max_table_log: int | None = None,
    max_bytes: int | None = None,
    counts: np.ndarray | None = None,
) -> bytes:
    """Encode into the alias-mapped MICT variant (magic FF 41).

    Layout:  FF 41 | log2_lanes u8 | table_log u8 | count u32 |
    n_words u32 | n_esc u32 | esc_val u16 | ncount | init states |
    renorm words | esc values u16[n_esc].

    The slot permutation follows alias_construct (both sides derive it
    from the ncount header).  Alphabets beyond 256 are escape-folded: rare values become one ESC
    symbol and their true values ride the uncoded side stream (measured
    ~1% corpus stream-size cost at 255 kept, see docs/formats.md)."""
    symbols = np.asarray(symbols, dtype=np.uint16)
    n = len(symbols)
    if n == 0:
        raise IncompressibleError
    counts, max_count, symbol_len = _hist_or_counts(symbols, counts)
    if max_count == n:
        raise UseRLEError
    if max_count == 1 or max_count < (n >> 15):
        raise IncompressibleError
    kept_vals, esc_val, tl, header, freq, cumul, al = alias_encode_plan(
        counts, symbol_len, n, table_log, max_table_log
    )
    recoded, esc_values = _alias_apply(symbols, kept_vals, esc_val)
    states, words = _lane_encode(
        recoded, n, int(lanes), tl, freq, cumul,
        slot_of=al["slot_of"].astype(np.uint64),
    )

    out = bytearray()
    out += MICT_ALIAS_MAGIC
    out += struct.pack("<BB", int(np.log2(int(lanes))), tl)
    out += struct.pack("<II", n, len(words))
    out += struct.pack("<IH", len(esc_values), esc_val)
    out += header
    out += states.astype("<u4").tobytes()
    out += words.astype("<u2").tobytes()
    out += esc_values.astype("<u2").tobytes()
    if len(out) >= (n * 2 if max_bytes is None else max_bytes):
        raise IncompressibleError
    return bytes(out)


def mict_parse(blob: bytes):
    """Parse a MICT blob.  Returns (lanes, table_log, count,
    init_states u32[L], words u16[W], norm, symbol_len, alias) — alias
    is None for standard streams, or (esc_val, esc_values u16[n_esc])
    for the FF 41 alias-mapped variant (see mict_encode_alias; the
    tuple is truthy even with no escapes)."""
    if len(blob) < 12 or blob[:2] not in (MICT_MAGIC, MICT_ALIAS_MAGIC):
        raise ValueError("MICT: missing magic bytes")
    is_alias = blob[:2] == MICT_ALIAS_MAGIC
    if is_alias and len(blob) < 18:
        raise ValueError("MICT: truncated alias header")
    log2_lanes, tl_hdr = struct.unpack_from("<BB", blob, 2)
    count, n_words = struct.unpack_from("<II", blob, 4)
    L = 1 << log2_lanes
    hdr = 12
    n_esc = esc_val = 0
    if is_alias:
        n_esc, esc_val = struct.unpack_from("<IH", blob, 12)
        hdr = 18
    body = blob[hdr:]
    # Native header reader when built (~1ms/strip in pure Python — it
    # dominated batch-decode latency); falls back to ops.fse.read_ncount.
    from ..native import read_ncount_native

    nat = read_ncount_native(body)
    if nat is not None:
        norm, symbol_len, table_log, consumed = nat
    else:
        norm, symbol_len, table_log, consumed = read_ncount(body)
    if table_log != tl_hdr:
        raise ValueError("MICT: header tableLog mismatch")
    pos = hdr + consumed
    states = np.frombuffer(blob, dtype="<u4", count=L, offset=pos).copy()
    pos += 4 * L
    words = np.frombuffer(blob, dtype="<u2", count=n_words, offset=pos).copy()
    alias = None
    if is_alias:
        pos += 2 * n_words
        if pos + 2 * n_esc > len(blob):
            raise ValueError("MICT: escape stream out of bounds")
        esc_values = np.frombuffer(blob, dtype="<u2", count=n_esc, offset=pos).copy()
        alias = (esc_val, esc_values)
    return L, table_log, count, states, words, norm, symbol_len, alias


def mict_decode_numpy(blob: bytes) -> np.ndarray:
    """Host (numpy) reference decoder — bit-exact mirror of the device
    decoder in mic.device.rans_kernel; used for cross-tier equality tests."""
    L, tl, count, states, words, norm, _symbol_len, alias = mict_parse(blob)
    sym, freq_slot, bias_slot, _, _ = slot_tables(norm, tl, alias)
    mask = (1 << tl) - 1

    n_steps = (count + L - 1) // L
    x = states.astype(np.uint64)
    cursor = 0
    out = np.empty(n_steps * L, dtype=np.uint16)
    lane_idx = np.arange(L)
    words_u64 = words.astype(np.uint64)
    for t in range(n_steps):
        base = t * L
        active = lane_idx < (count - base)
        slot = (x & mask).astype(np.int64)
        out[base : base + L] = sym[slot]
        f = freq_slot[slot].astype(np.uint64)
        b = bias_slot[slot].astype(np.uint64)
        x_new = f * (x >> np.uint64(tl)) + b
        need = (x_new < RANS_L) & active
        k = np.cumsum(need) - need  # exclusive prefix sum
        idx = cursor + k
        w = words_u64[np.minimum(idx, len(words_u64) - 1)] if len(words_u64) else np.zeros(L, np.uint64)
        x_new = np.where(need, (x_new << np.uint64(16)) | w, x_new)
        cursor += int(need.sum())
        x = np.where(active, x_new, x)
    if not np.all(x == RANS_L):
        raise ValueError("MICT: final state mismatch (corrupt stream)")
    if cursor != len(words):
        raise ValueError("MICT: word count mismatch (corrupt stream)")
    out = out[:count]
    if alias is not None:
        out = alias_substitute_escapes(out, alias)
    return out


def alias_substitute_escapes(syms: np.ndarray, alias) -> np.ndarray:
    """Replace decoded ESC symbols with their true values from the alias
    side stream, in stream order (shared by every slot-table decoder).
    The count check runs even with an empty side stream — a forged
    n_esc=0 header on a stream that decodes ESC placeholders must fail,
    not silently leave them in the output."""
    esc_val, esc_values = alias
    idx = np.nonzero(syms == esc_val)[0]
    if len(idx) != len(esc_values):
        raise ValueError("MICT: escape count mismatch (corrupt stream)")
    if not len(idx):
        return syms
    syms = syms.copy()
    syms[idx] = esc_values
    return syms
