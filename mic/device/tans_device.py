"""Device decode of the reference's bit-granular interleaved ANS formats.

The byte-compatible MIC entropy formats (1/2/4/8-state FSE, magic FF
02/04/84 — fse2state.go:22, fse4state.go:195, fse8state.go:230 — and the
8-state rANS format FF 08, rans8state.go:14-17) are reverse-direction
bit streams: N interleaved ANS states, each decode step reading a
data-dependent number of bits (state -> dtable[state] -> state' +
getBits(nbBits)).  This module decodes them bit-exactly on the device,
so an archive of existing .mic blobs decodes with no host entropy pass.

The decode is a plain ``lax.scan`` over steps, vmapped over streams.  A
step decodes the N states of a stream at once: the N reads of one step
lie back to back below the bit cursor, so lane j's read starts at
``pos - cumsum(nb)[j]`` (inclusive prefix), and its bits come from the
two 32-bit words covering ``[start, start + nb)``.  FF 08 shares the
step; only the decode-table construction differs.

A stream fills N <= 8 lanes, so this is a capability (device decode of
reference blobs with no host in the loop), not the fast path: MICW's
wide-lane format exists for throughput, and ingest transcodes to it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "tans_decode_scan",
    "build_tans_batch",
    "fse_parse_header",
    "fse_decompress_device_batch",
]


@partial(jax.jit, static_argnames=("steps", "n_states"))
def tans_decode_scan(init, pos, cnt, new_state, nb_bits, symbol, words, *,
                     steps, n_states):
    """Decode R interleaved ANS streams of N states each.

    init: int32[R, N] initial states.  pos: int32[R] bit cursor after the
    init-state reads.  cnt: int32[R] symbol counts.  new_state / nb_bits /
    symbol: [R, 2^tl_max] decode tables (int32 / int32 / uint16).  words:
    uint32[R, W] stream bits as LE words (bit p of the stream is bit
    p & 31 of word p >> 5), with at least one zero word of padding.

    Returns uint16[R, steps * N]: ``out[s, :count]`` is stream s's
    symbol stream in order.
    """
    N = n_states
    lane = jnp.arange(N, dtype=jnp.int32)

    def one(x0, p0, count, ns_tab, nb_tab, sym_tab, wrd):
        last = wrd.shape[0] - 1

        def step(carry, t):
            x, p = carry
            active = t * N + lane < count
            nb = jnp.where(active, nb_tab[x], 0)
            start = p - jnp.cumsum(nb)
            wi = start >> 5
            off = (start & 31).astype(jnp.uint32)
            wa = wrd[jnp.clip(wi, 0, last)]
            wb = wrd[jnp.clip(wi + 1, 0, last)]
            hi = jnp.where(off == 0, jnp.uint32(0),
                           wb << ((jnp.uint32(32) - off) & jnp.uint32(31)))
            val = (wa >> off) | hi
            # Reads that reach below the stream start see zeros there
            # (ReverseBitReader's over-read rule).
            under = jnp.minimum(-start, 32).astype(jnp.uint32)
            low = jnp.where(under >= 32, jnp.uint32(0),
                            wrd[0] << (under & jnp.uint32(31)))
            val = jnp.where(start < 0, low, val)
            val = val & ((jnp.uint32(1) << nb.astype(jnp.uint32)) - jnp.uint32(1))
            x_new = ns_tab[x] + val.astype(jnp.int32)
            sym = jnp.where(active, sym_tab[x], jnp.uint16(0))
            return (jnp.where(active, x_new, x), p - jnp.sum(nb)), sym

        _, syms = jax.lax.scan(step, (x0, p0), jnp.arange(steps, dtype=jnp.int32))
        return syms.reshape(-1)

    return jax.vmap(one)(init, pos, cnt, new_state, nb_bits, symbol, words)


def fse_parse_header(blob: bytes):
    """Split a reference entropy blob into (n_states, count, body bytes,
    coder).  count is None for the 1-state format (implicit termination —
    decoded on the host; the device path needs the exact count the N>=2
    formats carry).  coder is 'tans' for FF 02/04/84 and 'rans' for the
    8-state rANS format FF 08 (rans8state.go:14-17) — the decode *step*
    is identical (x' = newState[x] + readBits(nb[x]), ransu16.go:33-39),
    only the table construction differs."""
    from ..ops.fse_codec import (
        MAGIC_2STATE,
        MAGIC_4STATE,
        MAGIC_8STATE_FSE,
        MAGIC_8STATE_RANS,
    )

    if len(blob) >= 6:
        for magic, n, coder in (
            (MAGIC_8STATE_FSE, 8, "tans"),
            (MAGIC_8STATE_RANS, 8, "rans"),
            (MAGIC_4STATE, 4, "tans"),
            (MAGIC_2STATE, 2, "tans"),
        ):
            if blob[:2] == magic:
                return n, int.from_bytes(blob[2:6], "little"), blob[6:], coder
    return 1, None, blob, "tans"


def _dtable(norm, symbol_len: int, table_log: int, coder: str):
    from ..ops.fse import build_dtable

    if coder == "rans":
        from ..ops.rans import build_rans_dec_table

        return build_rans_dec_table(norm, symbol_len, table_log)
    new_state, symbol, nb_bits, _zero_bits = build_dtable(norm, symbol_len, table_log)
    return new_state, symbol, nb_bits


def build_tans_batch(parsed, n_states: int, min_steps: int = 0):
    """Stage a batch of same-N ANS streams for :func:`tans_decode_scan`.

    parsed: list of (count, norm, symbol_len, table_log, bits, coder) —
    the output of read_ncount + header split; ``coder`` selects the
    decode-table construction ('tans' = co-prime spread, 'rans' = linear
    fill).  Returns (operands, steps).
    """
    from ..ops.bitio import ReverseBitReader

    R = len(parsed)
    T = 1 << max(p[3] for p in parsed)
    steps = max(min_steps, max(-(-p[0] // n_states) for p in parsed))
    new_state = np.zeros((R, T), np.int32)
    nb_bits = np.zeros((R, T), np.int32)
    symbol = np.zeros((R, T), np.uint16)
    init = np.zeros((R, n_states), np.int32)
    pos = np.zeros(R, np.int32)
    cnt = np.zeros(R, np.int32)
    words_list = []
    for i, (count, norm, symbol_len, tl, bits, coder) in enumerate(parsed):
        ns, sym, nb = _dtable(norm, symbol_len, tl, coder)
        new_state[i, : len(ns)] = ns
        nb_bits[i, : len(nb)] = nb
        symbol[i, : len(sym)] = sym
        r = ReverseBitReader(bits)
        for j in range(n_states):
            init[i, j] = r.get_bits(tl)
        pos[i] = r.pos
        cnt[i] = count
        words_list.append(np.frombuffer(bits + b"\x00" * ((-len(bits)) % 4), dtype="<u4"))
    words = np.zeros((R, max(len(w) for w in words_list) + 1), np.uint32)
    for i, w in enumerate(words_list):
        words[i, : len(w)] = w
    return (init, pos, cnt, new_state, nb_bits, symbol, words), steps


def fse_decompress_device_batch(blobs: list[bytes]):
    """Decode a batch of reference entropy blobs (FF 02/04/84/08) on the
    device.

    Streams group by (n_states, pow2 steps bucket); each group is one
    device launch.  1-state blobs (no symbol count in the header) decode
    on the host.  Returns a list of numpy symbol arrays, blob-order —
    bit-exact vs ops.fse_codec / ops.rans.
    """
    from ..ops.fse import read_ncount
    from ..ops.fse_codec import fse_decompress_auto

    results = [None] * len(blobs)
    groups: dict[tuple, list] = {}
    for bi, blob in enumerate(blobs):
        n, count, body, coder = fse_parse_header(blob)
        if n == 1 or count is None:
            results[bi] = fse_decompress_auto(blob)
            continue
        norm, symbol_len, tl, consumed = read_ncount(body)
        entry = (count, norm, symbol_len, tl, body[consumed:], coder)
        b = 8
        while b < -(-count // n):
            b *= 2
        groups.setdefault((n, b), []).append((bi, entry))

    for (n, b), items in groups.items():
        ops, steps = build_tans_batch([e for _bi, e in items], n, min_steps=b)
        out = np.asarray(tans_decode_scan(
            *(jnp.asarray(a) for a in ops), steps=steps, n_states=n))
        for j, (bi, (count, *_rest)) in enumerate(items):
            results[bi] = out[j, :count]
    return results
