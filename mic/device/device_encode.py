"""Wide-lane rANS ENCODE on the device (device-side compression).

The reference encodes on CPU threads (mic_compress_c.c, parallelstrips.go
workers); here the encode scan itself runs on the device: the mirror
recursion of the decode kernel (rans_kernel.py), processed in reverse
step order as a plain ``lax.scan`` vmapped over strips.  Output blobs are
BYTE-IDENTICAL to the host encoder (device_rans.mict_encode /
mict_encode_alias), so every decoder tier accepts them.

* Per step and lane: ``x >= freq << (32 - tl)`` emits the low 16 bits as
  a renorm word, then ``x = (x // freq) << tl | slot`` with native
  uint32 division.  ``slot = cumul + x % freq`` for FF 57 strips and
  ``slot_of[cumul + x % freq]`` (the alias permutation) for FF 41 ones;
  FF 57 strips carry the identity permutation, so both families share
  one program.
* Renorm words come back dense with a flag plane; the host compacts
  ``words[flags]`` in (step asc, lane asc) order, which IS the decoder's
  word order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "rans_encode_scan",
    "mict_encode_device_batch",
    "micw_compress_device",
    "micw_compress_device_many",
]


@partial(jax.jit, static_argnames=("lanes",))
def rans_encode_scan(ranks, freq, cumul, slot_of, count, tls, *, lanes):
    """Encode rank streams into wide-lane rANS states + dense word planes.

    ranks: int32[S, steps * lanes] (each symbol's rank in its strip's
    alphabet; anything on pad positions).  freq/cumul: uint32[S, A] per
    rank.  slot_of: uint32[S, 2^tl_max] the slot permutation (identity
    for FF 57).  count/tls: int32[S] symbol count and tableLog.
    Returns (words u16[S, steps, lanes], flags bool[S, steps, lanes],
    states u32[S, lanes]); the stream's words are ``words[flags]`` in
    (step asc, lane asc) order, and the final states are the decoder's
    initial states.
    """
    S, n = ranks.shape
    steps = n // lanes
    lane = jnp.arange(lanes, dtype=jnp.int32)

    def one(rk, f_tab, c_tab, perm, cnt, tl):
        rk = rk.reshape(steps, lanes)
        tlu = tl.astype(jnp.uint32)

        def step(x, t):
            active = t * lanes + lane < cnt
            r = rk[t]
            f = jnp.where(active, f_tab[r], jnp.uint32(1))
            need = (x >= (f << (jnp.uint32(32) - tlu))) & active
            w = jnp.where(need, x & jnp.uint32(0xFFFF), jnp.uint32(0))
            x1 = jnp.where(need, x >> jnp.uint32(16), x)
            slot = perm[(c_tab[r] + x1 % f).astype(jnp.int32)]
            x2 = ((x1 // f) << tlu) + slot
            return jnp.where(active, x2, x1), (w.astype(jnp.uint16), need)

        x0 = jnp.full((lanes,), 1 << 16, jnp.uint32)
        x, (w, flags) = jax.lax.scan(
            step, x0, jnp.arange(steps, dtype=jnp.int32), reverse=True)
        return w, flags, x

    return jax.vmap(one)(ranks, freq, cumul, slot_of, count, tls)


def mict_encode_device_batch(streams, lanes: int = 128, table_log: int | None = None, max_table_log: int = 12, on_error: str = "raise", alias: bool = False, max_bytes: list | None = None):
    """Encode many u16 symbol streams into MICT blobs with one device
    encode launch for the whole batch (:func:`rans_encode_scan`).  Blobs
    are byte-identical to device_rans.mict_encode(stream, lanes=lanes,
    max_table_log=max_table_log) — reference semantics: fseu16.go
    normalization + adaptive tableLog.

    ``alias=True`` writes the FF 41 alias-mapped variant instead
    (byte-identical to mict_encode_alias): the host does the escape-fold
    plan and table build; the scan writes each slot through the alias
    permutation.

    Returns a list of bytes.  Raises the same sentinel errors as the host
    encoder per stream (caller handles fallback per strip).  With
    on_error="none", failing streams yield None instead (the scan runs
    on the encodable subset).  ``max_bytes`` supplies a per-stream byte
    budget (host mict_encode's max_bytes; default = the stream's own raw
    size) — blobs at or over budget fail like any sentinel error.
    """
    import struct

    from ..ops.fse import (
        DEFAULT_TABLE_LOG,
        IncompressibleError,
        UseRLEError,
        histogram,
        optimal_table_log,
    )
    from .device_rans import (
        MICT_ALIAS_MAGIC,
        MICT_MAGIC,
        _alias_apply,
        _norm_and_header,
        alias_encode_plan,
        encode_tables,
    )

    tl_hint = DEFAULT_TABLE_LOG if table_log is None else table_log

    metas = []  # (n, tl, header, ranks, freq, cumul, slot_of, esc_info)
    out_pos = []  # output position per encodable stream
    failed = [None] * len(streams)
    for si, symbols in enumerate(streams):
        try:
            symbols = np.asarray(symbols, dtype=np.uint16)
            n = len(symbols)
            if n == 0:
                raise IncompressibleError
            counts, max_count, symbol_len = histogram(symbols)
            if max_count == n:
                raise UseRLEError
            if max_count == 1 or max_count < (n >> 15):
                raise IncompressibleError
            esc_info = None
            if alias:
                # The byte-format-defining setup (fold/retry/clamp/tables)
                # is SHARED with the host encoder — see alias_encode_plan.
                kept_vals, esc_val, tl, header, freq, cumul, al = (
                    alias_encode_plan(counts, symbol_len, n, tl_hint,
                                      max_table_log))
                recoded, esc_values = _alias_apply(symbols, kept_vals, esc_val)
                symbols = recoded.astype(np.uint16)
                esc_info = (esc_val, esc_values)
                perm = al["slot_of"]
            else:
                tl = optimal_table_log(tl_hint, n, symbol_len)
                tl = min(tl, max_table_log)
                try:
                    norm, header = _norm_and_header(counts, n, tl, symbol_len)
                    freq, cumul = encode_tables(norm, tl)
                except ValueError as e:
                    raise IncompressibleError(str(e)) from e
                perm = None
        except (IncompressibleError, UseRLEError):
            if on_error == "raise":
                raise
            continue
        alphabet = np.nonzero(freq)[0]
        lut = np.zeros(65536, np.int32)
        lut[alphabet] = np.arange(len(alphabet), dtype=np.int32)
        metas.append((n, tl, header, lut[symbols], freq[alphabet],
                      cumul[alphabet], perm, esc_info))
        out_pos.append(si)
    if not metas:
        return failed

    S = len(metas)
    steps = max(-(-m[0] // lanes) for m in metas)
    a_max = max(len(m[4]) for m in metas)
    t_max = 1 << max(m[1] for m in metas)
    rk = np.zeros((S, steps * lanes), np.int32)
    f_tab = np.ones((S, a_max), np.uint32)
    c_tab = np.zeros((S, a_max), np.uint32)
    perms = np.zeros((S, t_max), np.uint32)
    cnt = np.zeros(S, np.int32)
    tls = np.zeros(S, np.int32)
    for i, (n, tl_i, _h, ranks, fr, cu, perm, _e) in enumerate(metas):
        rk[i, :n] = ranks
        f_tab[i, : len(fr)] = fr
        c_tab[i, : len(cu)] = cu
        perms[i, : 1 << tl_i] = np.arange(1 << tl_i) if perm is None else perm
        cnt[i] = n
        tls[i] = tl_i
    w, f, x = rans_encode_scan(
        *(jnp.asarray(a) for a in (rk, f_tab, c_tab, perms, cnt, tls)),
        lanes=lanes,
    )
    w = np.asarray(w).reshape(S, -1)
    f = np.asarray(f).reshape(S, -1)
    x = np.asarray(x)
    log2_lanes = int(lanes).bit_length() - 1

    blobs = list(failed)
    for i, (n, tl, header, *_tabs, esc_info) in enumerate(metas):
        words = w[i][f[i]]
        out = bytearray()
        if alias:
            esc_val, esc_values = esc_info
            out += MICT_ALIAS_MAGIC
            out += struct.pack("<BB", log2_lanes, tl)
            out += struct.pack("<II", n, len(words))
            out += struct.pack("<IH", len(esc_values), esc_val)
        else:
            out += MICT_MAGIC
            out += struct.pack("<BB", log2_lanes, tl)
            out += struct.pack("<II", n, len(words))
        out += header
        out += x[i].astype("<u4").tobytes()
        out += words.astype("<u2").tobytes()
        if alias:
            out += esc_info[1].astype("<u2").tobytes()
        budget = n * 2
        if max_bytes is not None and max_bytes[out_pos[i]] is not None:
            budget = max_bytes[out_pos[i]]
        if len(out) >= budget:
            if on_error == "raise":
                raise IncompressibleError
            continue
        blobs[out_pos[i]] = bytes(out)
    return blobs


def micw_compress_device(pixels, width: int, height: int, max_value: int,
                         num_strips: int = 0, entropy: str = "standard",
                         predictor: str = "zzd"):
    """MICW compression with the entropy stage on the device.

    Byte-identical to strips.micw_compress(pixels, ..., predictor=
    predictor, entropy=entropy) for every predictor/entropy combination
    — see micw_compress_device_many."""
    return micw_compress_device_many(
        [(pixels, width, height, max_value, num_strips)], entropy=entropy,
        predictor=predictor,
    )[0]


def micw_compress_device_many(images, entropy: str = "standard",
                              predictor: str = "zzd"):
    """Device-encode MANY images into MICW containers — the archive-
    migration shape (a 1000-frame study batched here pays one launch per
    stream family).

    ``images`` is a list of (pixels, width, height, max_value
    [, num_strips]); returns the containers blob-order, each
    byte-identical to strips.micw_compress on that image with the same
    ``predictor``/``entropy`` — including the adaptive trial sets
    ("auto-fast", "auto-r", "auto") and entropy="best".  Identity holds
    because candidate generation and selection are the SAME code
    (strips._strip_candidates / _strip_select); this function merely
    pre-encodes every candidate the selector may ask for, batched into
    at most two encode launches (one FF 57, one FF 41) covering all
    strips of all images, with per-stream raw-size budgets
    (reference anchor: the C encoder covers every shipped format,
    mic_compress_c.c:915-955)."""
    if entropy not in ("standard", "alias", "best"):
        raise ValueError(f"micw device encode: unknown entropy {entropy!r}")
    import struct as _struct

    from .strips import (
        ALIAS_TABLE_LOG,
        _PRED_MODE,
        _RLE_DIRECT_PREDS,
        FLAG_ADAPTIVE,
        FLAG_AVG_PREDICTOR,
        FLAG_BANDED,
        FLAG_DIRECT,
        FLAG_RDENSE,
        MAX_TABLE_LOG,
        MICW_BAND_W,
        MICW_MAGIC,
        STRIP_MODE_CONST,
        _rle_mid,
        _strip_candidates,
        _strip_requests,
        _strip_select,
        _trials_for,
        band_split,
    )

    trials = _trials_for(predictor)

    prep = []  # per image: (width, height, max_value, actual, strip_h, entries, band)
    jobs = {False: [], True: []}  # alias? -> [(syms, counts, max_bytes)]
    for spec in images:
        pixels, width, height, max_value = spec[:4]
        num_strips = spec[4] if len(spec) > 4 else 0
        pixels = np.asarray(pixels, dtype=np.uint16)
        if len(pixels) != width * height:
            raise ValueError("micw: pixel count mismatch")
        # Wide images band exactly like the host encoder (FLAG_BANDED) —
        # part of the byte-identity contract and of the shared
        # compiled-program-family property.
        orig_w, orig_h = width, height
        banded = width > MICW_BAND_W and width % MICW_BAND_W == 0
        if banded:
            pixels, width, height = band_split(pixels, width, height)
        if num_strips <= 0:
            # Same default geometry as the host container (128-row
            # strips, scaled by the band count for banded images).
            rows = 128 * (orig_w // width if banded else 1)
            num_strips = max(1, height // rows)
        num_strips = max(1, min(num_strips, height))
        strip_h = (height + num_strips - 1) // num_strips
        actual = (height + strip_h - 1) // strip_h
        mid = _rle_mid(max_value)

        entries = []
        for s in range(actual):
            y0 = s * strip_h
            y1 = min(y0 + strip_h, height)
            sh = y1 - y0
            strip_px = pixels[y0 * width : y1 * width]
            if strip_px[0] == strip_px.max() and strip_px[0] == strip_px.min():
                entries.append(("const", strip_px))
                continue
            candidates = _strip_candidates(strip_px, width, sh, max_value,
                                           mid, trials, entropy)
            slots = {}
            for i, alias in _strip_requests(candidates, len(trials), entropy):
                jobs[alias].append((candidates[i][1], candidates[i][2],
                                    strip_px.nbytes))
                slots[(i, alias)] = len(jobs[alias]) - 1
            entries.append(("enc", strip_px, candidates, slots))
        prep.append((width, height, max_value, actual, strip_h, entries,
                     (orig_w, orig_h) if banded else None))

    # One encode launch per stream family for every candidate of every
    # strip of every image.
    results = {
        alias: (mict_encode_device_batch(
            [j[0] for j in batch], on_error="none", alias=alias,
            max_table_log=ALIAS_TABLE_LOG if alias else MAX_TABLE_LOG,
            max_bytes=[j[2] for j in batch],
        ) if batch else [])
        for alias, batch in jobs.items()
    }

    outs = []
    for (width, height, max_value, actual, strip_h, entries, band) in prep:
        blobs = []
        metas = []
        for entry in entries:
            if entry[0] == "const":
                strip_px = entry[1]
                blobs.append(strip_px[:1].astype("<u2").tobytes())
                metas.append((0, 0, 0, 0, STRIP_MODE_CONST))
                continue
            _tag, strip_px, candidates, slots = entry

            def enc(i, alias, _slots=slots):
                # Direct indexing: a (candidate, family) pair the request
                # enumeration missed must KeyError, not silently diverge
                # from the host selection.
                return results[alias][_slots[(i, alias)]]

            blob, meta = _strip_select(candidates, strip_px, len(trials),
                                       entropy, enc)
            blobs.append(blob)
            metas.append(meta)

        out = bytearray()
        out += MICW_MAGIC
        out += _struct.pack("<IIII", width, height, actual, strip_h)
        flags = FLAG_ADAPTIVE | {"avg": FLAG_AVG_PREDICTOR,
                                 "zzd": FLAG_DIRECT}.get(predictor, 0)
        if band is not None:
            flags |= FLAG_BANDED
        r_modes = {_PRED_MODE[pr] for pr in _RLE_DIRECT_PREDS}
        if any(m[4] in r_modes for m in metas):
            flags |= FLAG_RDENSE
        out += _struct.pack("<HBB", max_value, flags, 7)
        if band is not None:
            out += _struct.pack("<II", *band)
        offset = 0
        for blob, (n_soa, n_tok, n_runs, n_same, mode) in zip(blobs, metas):
            out += _struct.pack("<IIIIIII", offset, len(blob), n_soa, n_tok,
                                n_runs, n_same, mode)
            offset += len(blob)
        outs.append(bytes(out) + b"".join(blobs))
    return outs
