"""Wide-lane rANS entropy decode: one Pallas kernel (Triton route).

The recursion (device_rans.py holds the format contract) is the same for
every MICT stream family: per lane, ``slot = x & mask`` → (symbol, freq,
bias) from the strip's slot table → ``x = freq * (x >> tl) + bias`` →
renormalize with the next u16 word when ``x < 2^16``, the words of one
step handed out in lane order through an exclusive prefix sum over the
renorm mask.

Operands are flat, so standard (FF 57) and alias-mapped (FF 41) strips
of any tableLog share one launch:

* ``meta``   int32[S, 4] per strip: symbol count, tableLog, offset of
  its slot table in ``tab_sym``/``tab_fb``, offset of its words in
  ``words``;
* ``init``   uint32[S, L] the decoder's initial lane states;
* ``words``  uint16[W] every strip's renorm words, concatenated;
* ``tab_sym`` uint16[T] and ``tab_fb`` uint32[T] (``freq << 16 | bias``),
  every strip's 2^tl slot table, concatenated.

:func:`rans_decode` is the kernel: each program owns
``STRIPS_PER_PROGRAM`` strips × L lanes, keeps the states in registers
for the whole scan (a ``fori_loop`` over steps inside the kernel),
gathers straight from the flat tables and word stream, and takes the
renorm offsets from an integer ``cumsum`` across the lanes.  :func:`rans_decode_scan` is the
plain XLA version of the same recursion (a ``lax.scan`` vmapped over
strips): the reference the kernel is checked and timed against, never a
route the decoders fall back to.

Both return uint16[S, n_steps * L] in stream order (symbol i of a strip
is lane ``i % L`` of step ``i // L``); alias escape substitution and the
predictor post stages run after them as ordinary XLA ops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .device_rans import alias_substitute_escapes, mict_parse, slot_tables

__all__ = [
    "interpret_mode",
    "FlatStreams",
    "rans_decode",
    "rans_decode_scan",
    "substitute_escapes",
    "mict_decode_device",
    "MAX_TABLE_LOG",
    "STRIPS_PER_PROGRAM",
    "bucket_size",
]

MAX_TABLE_LOG = 15  # freq (< 2^tl) and bias must fit 16 bits of tab_fb
# Strips per program and warps per program.  On the H100 (700 W) over
# 512 CT strips, 1/2/4 strips at 4 warps took 0.74/0.69/0.65 ms and 8
# strips 1.74 ms; 1 strip at 1/2 warps 0.85/0.74 ms (PERF.md, "Findings").
STRIPS_PER_PROGRAM = 4
NUM_WARPS = 4


def bucket_size(n: int, quantum: int = 1) -> int:
    """``n`` rounded up to a coarse size bucket: a multiple of ``quantum``
    and of an eighth of the power of two at or above ``n`` — four buckets
    per octave, less than 25% above ``n`` once ``n`` exceeds 8 quanta.
    Padding operands to these sizes lets a new batch of similar size reuse
    the programs compiled for the last one."""
    b = 1
    while b < n:
        b *= 2
    q = max(b // 8, quantum)
    return -(-n // q) * q


def interpret_mode() -> bool:
    """Whether Pallas kernels run in the interpreter: only on the CPU
    backend, where the tests run.  On the GPU they compile or raise; any
    other platform is an error, never a silent fallback."""
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(f"no kernel route for JAX platform {platform!r}")


class FlatStreams:
    """Host-side flat operands of a batch of parsed MICT strips (see the
    module docstring), plus the per-strip alias escape side streams.

    ``parsed`` are :func:`device_rans.mict_parse` tuples, all with the
    same lane count.  Identical parse objects (replicated batches) share
    one copy of their table and words.  ``rows`` (>= ``len(parsed)``)
    pads the strip axis with empty strips (count 0); the word stream and
    the tables are always padded to a :func:`bucket_size`."""

    def __init__(self, parsed, rows: int | None = None):
        if not parsed:
            raise ValueError("FlatStreams: empty batch")
        lanes = parsed[0][0]
        S = len(parsed) if rows is None else rows
        if S < len(parsed):
            raise ValueError("FlatStreams: rows < strips")
        self.lanes = lanes
        self.meta = np.zeros((S, 4), np.int32)
        self.init = np.zeros((S, lanes), np.uint32)
        tab_sym, tab_fb, words = [], [], []
        t_off = w_off = 0
        seen: dict[int, tuple[int, int]] = {}
        esc_n = [0] * S
        alias = [None] * S
        for i, p in enumerate(parsed):
            L, tl, count, states, wrds, norm, _sl, al = p
            if L != lanes:
                raise ValueError("FlatStreams: mixed lane counts")
            if tl > MAX_TABLE_LOG:
                raise ValueError(f"MICT: tableLog {tl} > {MAX_TABLE_LOG}")
            offs = seen.get(id(p))
            if offs is None:
                sym, fs, bs, _, _ = slot_tables(norm, tl, al)
                tab_sym.append(sym.astype(np.uint16))
                tab_fb.append((fs.astype(np.uint32) << np.uint32(16)) | bs.astype(np.uint32))
                words.append(np.asarray(wrds, np.uint16))
                offs = (t_off, w_off)
                seen[id(p)] = offs
                t_off += len(sym)
                w_off += len(wrds)
            self.meta[i] = (count, tl, offs[0], offs[1])
            self.init[i] = states
            if al is not None:
                alias[i] = al
                esc_n[i] = len(al[1])
        # At least one trailing zero word: an exhausted cursor's gather
        # stays in bounds (its value is never used).
        words.append(np.zeros(bucket_size(w_off + 1) - w_off, np.uint16))
        self.words = np.concatenate(words)
        pad = bucket_size(t_off) - t_off
        self.tab_sym = np.concatenate(tab_sym + [np.zeros(pad, np.uint16)])
        self.tab_fb = np.concatenate(tab_fb + [np.zeros(pad, np.uint32)])
        # Escape side streams, padded to a power of two (>= 1) so the
        # substitution program family stays small.
        e = 1
        while e < max(esc_n):
            e *= 2
        self.esc_vals = np.full(S, -1, np.int32)
        self.esc_sides = np.zeros((S, e), np.uint16)
        for i, a in enumerate(alias):
            if a is not None and len(a[1]):
                self.esc_vals[i] = a[0]
                self.esc_sides[i, : len(a[1])] = a[1]
        self.has_escapes = bool(max(esc_n))
        self.n_steps = int(max(-(-int(c) // lanes) for c in self.meta[:, 0]))

    def device_operands(self):
        """(meta, init, words, tab_sym, tab_fb) as device arrays."""
        return tuple(jnp.asarray(a) for a in
                     (self.meta, self.init, self.words, self.tab_sym, self.tab_fb))


def _step(x, cursor, t, *, count, tl, tbase, wbase, lane, lanes, n_words,
          take_table, take_words):
    """One decode step over a [G, L] block of lanes (shared by the kernel
    body and the XLA scan so the two cannot drift)."""
    tlu = tl.astype(jnp.uint32)
    mask = (jnp.uint32(1) << tlu) - jnp.uint32(1)
    active = t * lanes + lane < count
    idx = tbase + (x & mask).astype(jnp.int32)
    sym, fb = take_table(idx)
    x_new = (fb >> jnp.uint32(16)) * (x >> tlu) + (fb & jnp.uint32(0xFFFF))
    need = (x_new < jnp.uint32(1 << 16)) & active
    ni = need.astype(jnp.int32)
    k = jnp.cumsum(ni, axis=1) - ni
    widx = jnp.minimum(wbase + cursor + k, n_words - 1)
    w = take_words(widx).astype(jnp.uint32)
    x_new = jnp.where(need, (x_new << jnp.uint32(16)) | w, x_new)
    x = jnp.where(active, x_new, x)
    cursor = cursor + jnp.sum(ni, axis=1, keepdims=True)
    return x, cursor, sym


def _kernel(meta_ref, init_ref, words_ref, sym_ref, fb_ref, out_ref, *,
            n_steps, lanes, n_words):
    G = init_ref.shape[0]
    count = meta_ref[:, pl.ds(0, 1)]
    tl = meta_ref[:, pl.ds(1, 1)]
    tbase = meta_ref[:, pl.ds(2, 1)]
    wbase = meta_ref[:, pl.ds(3, 1)]
    lane = jax.lax.broadcasted_iota(jnp.int32, (G, lanes), 1)
    step = partial(
        _step, count=count, tl=tl, tbase=tbase, wbase=wbase, lane=lane,
        lanes=lanes, n_words=n_words,
        take_table=lambda idx: (sym_ref[idx], fb_ref[idx]),
        take_words=lambda idx: words_ref[idx],
    )

    def body(t, carry):
        x, cursor = carry
        x, cursor, sym = step(x, cursor, t)
        out_ref[:, pl.ds(t * lanes, lanes)] = sym
        return x, cursor

    jax.lax.fori_loop(0, n_steps, body,
                      (init_ref[...], jnp.zeros((G, 1), jnp.int32)))


@partial(jax.jit, static_argnames=("n_steps",))
def rans_decode(meta, init, words, tab_sym, tab_fb, *, n_steps):
    """The entropy kernel.  Returns uint16[S, n_steps * L].  The lane
    count must be a power of two (a Triton block shape)."""
    S, lanes = init.shape
    group = STRIPS_PER_PROGRAM
    if S % group:
        pad = group - S % group
        meta = jnp.concatenate([meta, jnp.broadcast_to(meta[:1], (pad, 4))])
        init = jnp.concatenate([init, jnp.broadcast_to(init[:1], (pad, lanes))])
        return rans_decode(meta, init, words, tab_sym, tab_fb, n_steps=n_steps)[:S]
    n_words = words.shape[0]
    full = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)  # noqa: E731
    return pl.pallas_call(
        partial(_kernel, n_steps=n_steps, lanes=lanes, n_words=n_words),
        out_shape=jax.ShapeDtypeStruct((S, n_steps * lanes), jnp.uint16),
        grid=(S // group,),
        in_specs=[
            pl.BlockSpec((group, 4), lambda i: (i, 0)),
            pl.BlockSpec((group, lanes), lambda i: (i, 0)),
            full(words),
            full(tab_sym),
            full(tab_fb),
        ],
        out_specs=pl.BlockSpec((group, n_steps * lanes), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret_mode(),
        name="mict_rans_decode",
    )(meta, init, words, tab_sym, tab_fb)


@partial(jax.jit, static_argnames=("n_steps",))
def rans_decode_scan(meta, init, words, tab_sym, tab_fb, *, n_steps):
    """XLA's own version of the same recursion: a ``lax.scan`` over steps,
    vmapped over strips.  Same operands and output as :func:`rans_decode`."""
    lanes = init.shape[1]
    n_words = words.shape[0]

    def rans_one(m, x0):
        step = partial(
            _step, count=m[0], tl=m[1], tbase=m[2], wbase=m[3],
            lane=jnp.arange(lanes, dtype=jnp.int32)[None, :], lanes=lanes,
            n_words=n_words,
            take_table=lambda idx: (tab_sym[idx], tab_fb[idx]),
            take_words=lambda idx: words[idx],
        )

        def body(carry, t):
            x, cursor = carry
            x, cursor, sym = step(x, cursor, t)
            return (x, cursor), sym[0]

        _, syms = jax.lax.scan(
            body, (x0[None, :], jnp.zeros((1, 1), jnp.int32)),
            jnp.arange(n_steps, dtype=jnp.int32))
        return syms.reshape(-1)

    return jax.vmap(rans_one)(meta, init)


def substitute_escapes(syms, esc_vals, esc_sides):
    """Alias (FF 41) escape substitution, [S, n] symbols: ESC symbols take
    their true values from the side stream in stream order.  esc_vals is
    -1 for strips without escapes (identity)."""

    def one(s, ev, side):
        m = s.astype(jnp.int32) == ev
        rank = jnp.cumsum(m.astype(jnp.int32)) - 1
        sv = jnp.take(side, jnp.clip(rank, 0, side.shape[0] - 1))
        return jnp.where(m, sv.astype(s.dtype), s)

    return jax.vmap(one)(syms, esc_vals, esc_sides)


def mict_decode_device(blob: bytes) -> np.ndarray:
    """Decode one MICT blob on the default JAX device (through the
    kernel).  Returns uint16[count]."""
    p = mict_parse(blob)
    fs = FlatStreams([p])
    n_steps = 1
    while n_steps < fs.n_steps:
        n_steps *= 2
    out = np.asarray(rans_decode(*fs.device_operands(), n_steps=n_steps))
    out = out[0, : p[2]]
    if p[7] is not None:
        out = alias_substitute_escapes(out, p[7])
    return out
