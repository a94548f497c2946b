"""The wide-lane rANS entropy kernel (rans_kernel.rans_decode) in interpret
mode against the numpy decoder and the plain XLA scan: both stream
families, tableLog 7-12, strip counts that do not fill a program's strip
group, symbol counts that are not multiples of the lane count; and the
size buckets that let a new batch reuse compiled programs."""

import jax
import numpy as np
import pytest

from mic.device import device_rans as dr
from mic.device.rans_kernel import (
    STRIPS_PER_PROGRAM,
    FlatStreams,
    bucket_size,
    interpret_mode,
    rans_decode,
    rans_decode_scan,
    substitute_escapes,
)

N = 16500  # not a multiple of 128, and enough symbols for tableLog 12


def _stream(rng, n, alpha=900):
    return np.minimum(rng.geometric(0.02, n), alpha).astype(np.uint16)


def _decode_all(parsed, rows=None):
    """Kernel and scan over one flat batch; returns the kernel's symbols
    after escape substitution, checking the scan agrees on the way."""
    fs = FlatStreams(parsed, rows=rows)
    ops = fs.device_operands()
    out = rans_decode(*ops, n_steps=fs.n_steps)
    ref = rans_decode_scan(*ops, n_steps=fs.n_steps)
    assert np.array_equal(np.asarray(out), np.asarray(ref))
    out = substitute_escapes(out, fs.esc_vals, fs.esc_sides)
    return np.asarray(out)


@pytest.mark.parametrize("alias", [False, True], ids=["ff57", "ff41"])
@pytest.mark.parametrize("tl", [7, 8, 9, 10, 11, 12])
def test_kernel_matches_numpy_per_table_log(rng, alias, tl):
    data = _stream(rng, N, alpha=1 << (tl - 2))  # alphabet fits the table
    blob = dr.mict_encode(data, lanes=128, table_log=tl, max_table_log=tl,
                          alias=alias)
    p = dr.mict_parse(blob)
    assert p[1] == tl and (p[7] is not None) == alias
    out = _decode_all([p])
    assert np.array_equal(out[0, : p[2]], dr.mict_decode_numpy(blob))
    assert np.array_equal(out[0, : p[2]], data)


@pytest.mark.parametrize("n_strips", [1, 3, STRIPS_PER_PROGRAM + 1])
def test_strip_counts_that_fill_no_group(rng, n_strips):
    """The wrapper pads the strip axis to the group and slices it back;
    mixed families and table logs share the launch."""
    blobs = [dr.mict_encode(_stream(rng, 3000 + 700 * i), lanes=128,
                            alias=bool(i % 2))
             for i in range(n_strips)]
    parsed = [dr.mict_parse(b) for b in blobs]
    out = _decode_all(parsed)
    assert out.shape[0] == n_strips
    for i, b in enumerate(blobs):
        assert np.array_equal(out[i, : parsed[i][2]], dr.mict_decode_numpy(b))


@pytest.mark.parametrize("n", [600, 1001, 4097, 16383])
def test_counts_off_the_lane_grid(rng, n):
    """A final partial step: lanes past the count stay inactive."""
    data = rng.integers(0, 12, n).astype(np.uint16)
    blob = dr.mict_encode(data, lanes=128)
    p = dr.mict_parse(blob)
    out = _decode_all([p])
    assert np.array_equal(out[0, :n], data)


@pytest.mark.parametrize("lanes", [64, 256])
def test_lane_counts(rng, lanes):
    data = _stream(rng, 5000)
    blob = dr.mict_encode(data, lanes=lanes)
    out = _decode_all([dr.mict_parse(blob)])
    assert np.array_equal(out[0, :5000], data)


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_group_sizes(rng, groups):
    """Launches of 1, 2 and 8 whole strip groups (programs) decode every
    strip; the row padding FlatStreams adds decodes to nothing."""
    n_strips = groups * STRIPS_PER_PROGRAM - 1
    blobs = [dr.mict_encode(_stream(rng, 2000 + 100 * i), lanes=128)
             for i in range(n_strips)]
    parsed = [dr.mict_parse(b) for b in blobs]
    out = _decode_all(parsed, rows=n_strips + 1)
    assert out.shape[0] == n_strips + 1
    for i, b in enumerate(blobs):
        assert np.array_equal(out[i, : parsed[i][2]], dr.mict_decode_numpy(b))


@pytest.mark.parametrize(("n", "quantum", "want"), [
    (1, 1, 1), (5, 1, 5), (9, 1, 10), (100, 1, 112), (1024, 1, 1024),
    (1025, 1, 1280), (1, 4, 4), (5, 4, 8), (66, 4, 80),
])
def test_bucket_size(n, quantum, want):
    b = bucket_size(n, quantum)
    assert b == want and b % quantum == 0
    if n > 8 * quantum:
        assert b < 1.25 * n


def test_flat_streams_pads_to_buckets(rng):
    """Words and tables are padded to a bucket; extra rows are empty
    strips (count 0) that leave n_steps alone."""
    parsed = [dr.mict_parse(dr.mict_encode(_stream(rng, 3000), lanes=128))
              for _ in range(3)]
    fs = FlatStreams(parsed, rows=8)
    assert fs.meta.shape == (8, 4) and fs.init.shape == (8, 128)
    assert not fs.meta[3:].any() and fs.n_steps == FlatStreams(parsed).n_steps
    n_words = sum(len(p[4]) for p in parsed) + 1
    assert len(fs.words) == bucket_size(n_words)
    assert len(fs.tab_sym) == len(fs.tab_fb) == bucket_size(sum(1 << p[1] for p in parsed))
    with pytest.raises(ValueError, match="rows"):
        FlatStreams(parsed, rows=2)


def test_escapes_substituted_in_stream_order(rng):
    base = _stream(rng, 6000, alpha=40)
    tail = rng.integers(0, 30000, 6000).astype(np.uint16)
    data = np.where(rng.random(6000) < 0.1, tail, base)
    blob = dr.mict_encode(data, alias=True)
    p = dr.mict_parse(blob)
    assert len(p[7][1]) > 0
    assert np.array_equal(_decode_all([p])[0, :6000], data)


def test_flat_streams_rejects_mixed_lanes(rng):
    a = dr.mict_parse(dr.mict_encode(_stream(rng, 2000), lanes=64))
    b = dr.mict_parse(dr.mict_encode(_stream(rng, 2000), lanes=128))
    with pytest.raises(ValueError, match="lane"):
        FlatStreams([a, b])


def test_interpret_mode_is_chosen_by_platform(monkeypatch):
    assert interpret_mode() is True  # the tests run on the CPU backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert interpret_mode() is False
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="no kernel route"):
        interpret_mode()
