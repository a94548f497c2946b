"""Spatial predictors and residual (escape-coded) symbol streams.

All MIC predictors share one residual grammar (deltacompressu16.go:11-52):
with ``depth = bit_length(maxValue)``, ``thr = (1<<(depth-1))-1`` and
``delim = (1<<depth)-1``, each pixel encodes as

* ``thr + diff``                     when ``|diff| < thr``
* ``delim`` followed by the raw pixel otherwise  (escape)

Predictors (selected per pipeline):

* ``avg``  — floor((left+top)/2), left-only on row 0, top-only on col 0
  (deltacompressu16.go) — the MIC default.
* ``grad`` — gradient-corrected average with clamped NE slope
  (deltagradcompressu16.go:149-166, gradShift=3).
* ``med``  — JPEG-LS median edge detector (deltamedcompressu16.go:133-147).
* ``zz``   — left-neighbour delta with ZigZag mapping
  (deltazigzagcompressu16.go).

Everything here is vectorized numpy.  Encoding uses original-pixel
neighbours (as the reference does), so it is embarrassingly parallel.
Decoding has the classic serial neighbour recurrence; it is computed on
anti-diagonal wavefronts ``k = 2*i + j``, along which *all four* neighbour
positions (left, top, top-left, top-right) lie on strictly earlier
wavefronts — so every predictor family decodes with O(2h+w) vector steps.
The device avg inverse in :mod:`mic.device.pipeline` uses the same wavefront.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "zigzag",
    "unzigzag",
    "delta_params",
    "predictor_encode",
    "predictor_decode",
    "parse_escaped",
    "delta_compress",
    "delta_decompress",
    "grad_delta_compress",
    "grad_delta_decompress",
    "med_delta_compress",
    "med_delta_decompress",
    "delta_zz_compress",
    "delta_zz_decompress",
    "temporal_delta_encode",
    "temporal_delta_decode",
]


def zigzag(x: np.ndarray) -> np.ndarray:
    """int16 -> uint16 ZigZag (deltazigzagcompressu16.go:108-111)."""
    x = np.asarray(x, dtype=np.int16)
    return ((x.astype(np.uint16) << np.uint16(1)) ^ (x >> np.int16(15)).astype(np.uint16))


def unzigzag(ux: np.ndarray) -> np.ndarray:
    """uint16 -> int16 inverse ZigZag (deltazigzagcompressu16.go:113-116)."""
    ux = np.asarray(ux, dtype=np.uint16)
    return ((ux >> np.uint16(1)) ^ (-(ux & np.uint16(1)).astype(np.int16)).astype(np.uint16)).astype(
        np.int16
    )


def delta_params(max_value: int) -> tuple[int, int]:
    """(delta_threshold, delimiter) for a given maxValue
    (deltacompressu16.go:12-14)."""
    depth = int(max_value).bit_length()
    thr = (1 << (depth - 1)) - 1
    delim = (1 << depth) - 1
    return thr, delim


GRAD_SHIFT = 3  # deltagradcompressu16.go:147


def _predict(kind: str, w, n, nw, ne):
    """Vectorized predictor on int64 neighbour arrays."""
    if kind == "avg":
        return (w + n) >> 1
    if kind == "med":
        mx = np.maximum(w, n)
        mn = np.minimum(w, n)
        pred = np.where(nw >= mx, mn, np.where(nw <= mn, mx, w + n - nw))
        return pred
    if kind == "grad":
        avg = (w + n) >> 1
        g = np.abs(w - nw) + np.abs(n - nw)
        corr = (ne - nw) >> GRAD_SHIFT
        limit = g >> 1
        corr = np.clip(corr, -limit, limit)
        return np.where(g == 0, avg, avg + corr)
    raise ValueError(f"unknown predictor {kind!r}")


def _full_predictions(img: np.ndarray, kind: str) -> np.ndarray:
    """Per-pixel predictions from *original* neighbours (encode side).

    Boundary rules shared by all 2D predictors: corner predicts 0, row 0
    predicts left, col 0 predicts top.
    """
    h, w = img.shape
    p = img.astype(np.int64)
    left = np.zeros_like(p)
    left[:, 1:] = p[:, :-1]
    top = np.zeros_like(p)
    top[1:, :] = p[:-1, :]
    topleft = np.zeros_like(p)
    topleft[1:, 1:] = p[:-1, :-1]
    topright = np.zeros_like(p)
    topright[1:, :-1] = p[:-1, 1:]
    # NE falls back to NW on the last column (deltagradcompressu16.go:42-45).
    topright[1:, -1] = p[:-1, -2] if w >= 2 else 0

    pred = _predict(kind, left, top, topleft, topright)
    if h > 0:
        pred[0, 1:] = left[0, 1:]  # row 0: left only
    if w > 0:
        pred[1:, 0] = top[1:, 0]  # col 0: top only
    pred[0, 0] = 0
    if kind == "avg":
        # interior already avg; row0/col0 handled above
        pass
    return pred


def predictor_encode(img: np.ndarray, width: int, height: int, max_value: int, kind: str) -> np.ndarray:
    """Residual symbol stream (without any leading maxValue word) for a 2D
    predictor, fully vectorized."""
    img = np.asarray(img, dtype=np.uint16).reshape(height, width)
    thr, delim = delta_params(max_value)
    pred = _full_predictions(img, kind)
    diff = img.astype(np.int64) - pred
    escape = np.abs(diff) >= thr
    return _interleave_escapes(
        (thr + diff).astype(np.uint16).ravel(), img.ravel(), escape.ravel(), delim
    )


def _interleave_escapes(
    coded: np.ndarray, raw: np.ndarray, escape: np.ndarray, delim: int
) -> np.ndarray:
    """Build the escaped stream: coded symbol, or [delim, raw] per pixel."""
    n = coded.size
    sizes = np.where(escape, 2, 1).astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    out = np.empty(int(starts[-1] + sizes[-1]) if n else 0, dtype=np.uint16)
    out[starts] = np.where(escape, delim, coded)
    esc_idx = starts[escape] + 1
    out[esc_idx] = raw[escape]
    return out


def parse_escaped(stream: np.ndarray, delim: int, n_tokens: int) -> tuple[np.ndarray, np.ndarray]:
    """Parse an escaped stream back to per-token ``(value, is_raw)``.

    Vectorized via the run-parity property: every maximal run of
    consecutive ``delim`` symbols begins at a token boundary, so escape
    markers sit at even offsets within each run.
    """
    s = np.asarray(stream, dtype=np.uint16)
    is_delim = s == delim
    n = s.size
    # Identify run starts of consecutive delims.
    run_start_mask = is_delim.copy()
    run_start_mask[1:] &= ~is_delim[:-1]
    # For each position, distance into its delim run:
    run_id = np.cumsum(run_start_mask)
    # position index minus position of run start:
    idx = np.arange(n)
    start_pos = np.zeros(n, dtype=np.int64)
    starts = idx[run_start_mask]
    if starts.size:
        start_pos_per_run = starts
        start_pos = np.where(is_delim, start_pos_per_run[np.maximum(run_id - 1, 0)], 0)
    offset_in_run = idx - start_pos
    escape_marker = is_delim & (offset_in_run % 2 == 0)
    consumed_as_raw = np.zeros(n, dtype=bool)
    consumed_as_raw[1:] = escape_marker[:-1]
    token_start = ~consumed_as_raw
    tok_pos = idx[token_start]
    if tok_pos.size < n_tokens:
        raise ValueError("escaped stream truncated")
    tok_pos = tok_pos[:n_tokens]
    is_raw = escape_marker[tok_pos]
    values = np.where(is_raw, s[np.minimum(tok_pos + 1, n - 1)], s[tok_pos])
    return values.astype(np.uint16), is_raw


def predictor_decode(
    values: np.ndarray, is_raw: np.ndarray, width: int, height: int, max_value: int, kind: str
) -> np.ndarray:
    """Reconstruct pixels from per-pixel residual tokens.

    Wavefront evaluation over k = 2*i + j: neighbours (i, j-1), (i-1, j),
    (i-1, j-1), (i-1, j+1) lie on wavefronts k-1, k-2, k-3, k-1 — all
    strictly earlier, so each wavefront is a pure vector step.
    """
    thr, delim = delta_params(max_value)
    vals = values.astype(np.int64).reshape(height, width)
    raw = np.asarray(is_raw, dtype=bool).reshape(height, width)
    diff = vals - thr
    out = np.zeros((height, width), dtype=np.int64)

    if kind == "zz":
        # Rows are independent chains; vectorize across rows, step x.
        dz = unzigzag(values.astype(np.uint16)).astype(np.int64).reshape(height, width)
        col = np.where(raw[:, 0], vals[:, 0], dz[:, 0]) & 0xFFFF  # x=0: prev = 0
        out[:, 0] = col
        for x in range(1, width):
            col = np.where(raw[:, x], vals[:, x], (col + dz[:, x]))
            col &= 0xFFFF
            out[:, x] = col
        return out.astype(np.uint16)

    flat = out.ravel()
    vflat = vals.ravel()
    rflat = raw.ravel()
    dflat = diff.ravel()

    # Corner.
    flat[0] = vflat[0] if rflat[0] else (dflat[0]) & 0xFFFF

    for k in range(1, 2 * (height - 1) + width):
        i_lo = max(0, (k - width + 1 + 1) // 2)
        i_hi = min(height - 1, k // 2)
        if i_lo > i_hi:
            continue
        ii = np.arange(i_lo, i_hi + 1)
        jj = k - 2 * ii
        m = (jj >= 0) & (jj < width) & ~((ii == 0) & (jj == 0))
        ii, jj = ii[m], jj[m]
        if ii.size == 0:
            continue
        pos = ii * width + jj

        w_v = np.where(jj > 0, flat[pos - 1], 0)
        n_v = np.where(ii > 0, flat[pos - width], 0)
        nw_v = np.where((ii > 0) & (jj > 0), flat[pos - width - 1], 0)
        ne_j = np.where(jj + 1 < width, jj + 1, jj - 1)
        ne_v = np.where(ii > 0, flat[(ii - 1) * width + np.maximum(ne_j, 0)], 0)

        pred = _predict(kind, w_v, n_v, nw_v, ne_v)
        pred = np.where(ii == 0, w_v, np.where(jj == 0, n_v, pred))
        res = (pred + dflat[pos]) & 0xFFFF
        flat[pos] = np.where(rflat.ravel()[pos], vflat[pos], res)

    return out.astype(np.uint16)


# ── Standalone (non-RLE) predictor codecs, mirroring the reference API ──


def _std_compress(img, width, height, max_value, kind) -> np.ndarray:
    stream = predictor_encode(img, width, height, max_value, kind)
    return np.concatenate([[np.uint16(max_value)], stream]).astype(np.uint16)


def _std_decompress(stream, width, height, kind) -> np.ndarray:
    s = np.asarray(stream, dtype=np.uint16)
    max_value = int(s[0])
    _, delim = delta_params(max_value)
    values, is_raw = parse_escaped(s[1:], delim, width * height)
    return predictor_decode(values, is_raw, width, height, max_value, kind).ravel()


def delta_compress(img, width, height, max_value):
    """Reference DeltaCompressU16 (deltacompressu16.go:11)."""
    return _std_compress(img, width, height, max_value, "avg")


def delta_decompress(stream, width, height):
    """Reference DeltaDecompressU16 (deltacompressu16.go:54)."""
    return _std_decompress(stream, width, height, "avg")


def grad_delta_compress(img, width, height, max_value):
    """Reference GradDeltaCompressU16 (deltagradcompressu16.go:20)."""
    return _std_compress(img, width, height, max_value, "grad")


def grad_delta_decompress(stream, width, height):
    """Reference GradDeltaDecompressU16 (deltagradcompressu16.go:65)."""
    return _std_decompress(stream, width, height, "grad")


def med_delta_compress(img, width, height, max_value):
    """Reference MEDDeltaCompressU16 (deltamedcompressu16.go:15)."""
    return _std_compress(img, width, height, max_value, "med")


def med_delta_decompress(stream, width, height):
    """Reference MEDDeltaDecompressU16 (deltamedcompressu16.go:56)."""
    return _std_decompress(stream, width, height, "med")


def delta_zz_compress(img, width, height, max_value):
    """Reference DeltaZZU16.Compress: left-delta with ZigZag mapping and the
    same escape rule (deltazigzagcompressu16.go:20-54)."""
    img = np.asarray(img, dtype=np.uint16).reshape(height, width)
    thr, delim = delta_params(max_value)
    p = img.astype(np.int64)
    left = np.zeros_like(p)
    left[:, 1:] = p[:, :-1]
    diff = p - left
    escape = np.abs(diff) >= thr
    coded = zigzag(diff.astype(np.int16)).ravel()
    stream = _interleave_escapes(coded, img.ravel(), escape.ravel(), delim)
    return np.concatenate([[np.uint16(max_value)], stream]).astype(np.uint16)


def delta_zz_decompress(stream, width, height):
    """Reference DeltaZZU16.Decompress (deltazigzagcompressu16.go:56-73)."""
    s = np.asarray(stream, dtype=np.uint16)
    max_value = int(s[0])
    _, delim = delta_params(max_value)
    values, is_raw = parse_escaped(s[1:], delim, width * height)
    return predictor_decode(values, is_raw, width, height, max_value, "zz").ravel()


def temporal_delta_encode(current, prev) -> np.ndarray:
    """Inter-frame ZigZag residual (temporaldelta.go:11-23)."""
    current = np.asarray(current, dtype=np.uint16)
    if prev is None:
        return current.copy()
    prev = np.asarray(prev, dtype=np.uint16)
    diff = (current.astype(np.int64) - prev.astype(np.int64)).astype(np.int16)
    return zigzag(diff)


def temporal_delta_decode(residual, prev) -> np.ndarray:
    """Inverse of temporal_delta_encode (temporaldelta.go:27-39)."""
    residual = np.asarray(residual, dtype=np.uint16)
    if prev is None:
        return residual.copy()
    prev = np.asarray(prev, dtype=np.uint16)
    diff = unzigzag(residual).astype(np.int64)
    return ((prev.astype(np.int64) + diff) & 0xFFFF).astype(np.uint16)
