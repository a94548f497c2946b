"""Entropy-coder contract tests: roundtrip / auto-detect / magic bytes /
edge cases for every state count, mirroring the reference quartets
(fse2state_test.go, fse4state_test.go, fse8state_test.go, rans8state_test.go)."""

import numpy as np
import pytest

from mic.ops.fse import (
    IncompressibleError,
    UseRLEError,
    histogram,
    normalize_count,
    optimal_table_log,
    read_ncount,
    write_count,
)
from mic.ops.fse_codec import (
    MAGIC_2STATE,
    MAGIC_4STATE,
    MAGIC_8STATE_FSE,
    MAGIC_8STATE_RANS,
    fse_compress,
    fse_compress_2state,
    fse_compress_4state,
    fse_compress_8state,
    fse_decompress,
    fse_decompress_2state,
    fse_decompress_4state,
    fse_decompress_8state,
    fse_decompress_auto,
)
from mic.ops.rans import rans_compress_8state, rans_decompress_8state

CODECS = [
    (fse_compress, fse_decompress, None),
    (fse_compress_2state, fse_decompress_2state, MAGIC_2STATE),
    (fse_compress_4state, fse_decompress_4state, MAGIC_4STATE),
    (fse_compress_8state, fse_decompress_8state, MAGIC_8STATE_FSE),
    (rans_compress_8state, rans_decompress_8state, MAGIC_8STATE_RANS),
]


def _skewed(rng, n, spread=30, center=511, lim=1023):
    return (rng.standard_normal(n) * spread + center).clip(0, lim).astype(np.uint16)


@pytest.mark.parametrize("comp,dec,magic", CODECS, ids=["1s", "2s", "4s", "8s", "rans8"])
def test_roundtrip(comp, dec, magic, rng):
    data = _skewed(rng, 50000)
    blob = comp(data)
    out = dec(blob)
    assert np.array_equal(out, data)
    if magic is not None:
        assert blob[:2] == magic
        assert int.from_bytes(blob[2:6], "little") == len(data)


@pytest.mark.parametrize("comp,dec,magic", CODECS, ids=["1s", "2s", "4s", "8s", "rans8"])
def test_autodetect(comp, dec, magic, rng):
    data = _skewed(rng, 20000)
    blob = comp(data)
    out = fse_decompress_auto(blob)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("comp", [c for c, _, _ in CODECS], ids=["1s", "2s", "4s", "8s", "rans8"])
def test_single_symbol_use_rle(comp):
    with pytest.raises(UseRLEError):
        comp(np.full(1000, 42, np.uint16))


@pytest.mark.parametrize("comp", [c for c, _, _ in CODECS], ids=["1s", "2s", "4s", "8s", "rans8"])
def test_incompressible(comp):
    with pytest.raises(IncompressibleError):
        comp(np.arange(65536, dtype=np.uint16))


@pytest.mark.parametrize("n", [2, 5, 9, 16, 33, 100])
@pytest.mark.parametrize("comp,dec,magic", CODECS, ids=["1s", "2s", "4s", "8s", "rans8"])
def test_tiny_inputs(comp, dec, magic, n, rng):
    data = np.array(([1, 2, 3, 1, 1, 2, 1, 1] * 16)[:n], dtype=np.uint16)
    try:
        blob = comp(data)
    except (IncompressibleError, UseRLEError):
        return
    out = dec(blob)
    assert np.array_equal(out, data)


def test_all_lane_remainders(rng):
    """Exercise every tail-alignment branch (len % 8 in 0..7)."""
    for n in range(64, 80):
        data = _skewed(rng, n, spread=3, center=8, lim=30)
        for comp, dec, _ in CODECS:
            try:
                blob = comp(data)
            except (IncompressibleError, UseRLEError):
                continue
            assert np.array_equal(dec(blob), data), (comp.__name__, n)


def test_16bit_alphabet(rng):
    """Large alphabet (the codec's central thesis: 65535-symbol tANS)."""
    data = (rng.standard_normal(100000) * 2000 + 30000).clip(0, 65000).astype(np.uint16)
    for comp, dec, _ in CODECS:
        blob = comp(data)
        assert np.array_equal(dec(blob), data), comp.__name__


def test_zero_bits_path(rng):
    """A dominant symbol with norm > tableSize/2 triggers the zeroBits path."""
    data = np.concatenate(
        [np.zeros(100000, np.uint16), rng.integers(0, 50, 2000).astype(np.uint16)]
    )
    rng.shuffle(data)
    for comp, dec, _ in CODECS:
        blob = comp(data)
        assert np.array_equal(dec(blob), data), comp.__name__


def test_header_roundtrip(rng):
    """writeCount/readNCount roundtrip across table logs and alphabets."""
    for symbol_len, tl in [(10, 5), (256, 8), (300, 11), (5000, 13), (700, 12)]:
        counts = rng.integers(0, 1000, symbol_len).astype(np.uint32)
        counts[rng.integers(0, symbol_len, symbol_len // 3)] = 0
        counts[0] = max(counts[0], 1)
        counts[symbol_len - 1] = max(counts[symbol_len - 1], 1)
        total = int(counts.sum())
        norm = normalize_count(counts, total, tl, symbol_len)
        hdr = write_count(norm, symbol_len, tl)
        norm2, sl2, tl2, consumed = read_ncount(hdr + b"\x00" * 8)
        assert tl2 == tl
        assert sl2 <= symbol_len
        assert np.array_equal(norm[:sl2], norm2)
        # Symbols beyond sl2 must all be zero-normalized.
        assert np.all(norm[sl2:] == 0)
        assert consumed <= len(hdr) + 1


def test_optimal_table_log_adaptive():
    # Large dense alphabet lifts to 13 (fsecompressu16.go:496-499).
    assert optimal_table_log(11, 512 * 512, 600) == 13
    # Small alphabet stays low.
    assert optimal_table_log(11, 1 << 20, 17) <= 11


def test_norm_sums_to_table_size(rng):
    for _ in range(20):
        symbol_len = int(rng.integers(2, 2000))
        counts = rng.integers(0, 500, symbol_len).astype(np.uint32)
        counts[counts < 3] = 0
        if counts.max() == 0:
            counts[0] = 5
            counts[1] = 3
        present = counts > 0
        if present.sum() < 2:
            counts[0] = 5
            counts[1] = 3
        total = int(counts.sum())
        tl = optimal_table_log(11, total, symbol_len)
        norm = normalize_count(counts, total, tl, symbol_len)
        assert int(np.abs(norm).sum()) == 1 << tl


def test_corrupt_magic_rejected():
    with pytest.raises(ValueError):
        fse_decompress_2state(b"\x00\x00\x01\x00\x00\x00")
    with pytest.raises(ValueError):
        fse_decompress_4state(b"\xff\x02\x01\x00\x00\x00")
    with pytest.raises(ValueError):
        fse_decompress_8state(b"\xff\x04\x01\x00\x00\x00")
    with pytest.raises(ValueError):
        rans_decompress_8state(b"\xff\x84\x01\x00\x00\x00")
