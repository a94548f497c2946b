"""Differential fuzzing across tiers: seeded random inputs swept over
shape x distribution, asserting (a) every successful compress round-trips
bit-exactly, (b) the native C++ tier is byte-identical to the Python
tier wherever both run, and (c) failures are only the documented
exception types.  This is the randomized analog of the reference's
fixed-fixture cross matrix (ojph/mic_c_test.go TestFourWayComparison,
fseu16_test.go random sections) with much wider input coverage.
"""

import zlib

import numpy as np
import pytest

from mic import IncompressibleError, UseRLEError, native
from mic.models.single_frame import (
    compress_single_frame,
    compress_single_frame_4state,
    compress_single_frame_8state,
    compress_single_frame_rans8,
    decompress_single_frame,
)

DOCUMENTED = (IncompressibleError, UseRLEError, ValueError)


def _seed(*parts) -> int:
    """Stable cross-process seed (hash() is salted per interpreter, which
    would make 'deterministic' fuzz inputs irreproducible across runs)."""
    return zlib.crc32(repr(parts).encode()) & 0xFFFF

SHAPES = [(8, 8), (37, 53), (64, 64), (33, 65), (128, 96)]


def gen_image(dist: str, w: int, h: int, seed: int) -> tuple[np.ndarray, int]:
    """Deterministic image generator; returns (pixels, max_value)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if dist == "constant":
        px = np.full(h * w, 777, np.uint16)
    elif dist == "smooth":
        base = (np.sin(xx / 9.0) * 800 + yy * 13 + 2000).astype(np.int32)
        px = (base + r.integers(-6, 7, (h, w))).clip(0, 65535).ravel()
    elif dist == "spiky":
        px = np.zeros(h * w, np.int32)
        idx = r.integers(0, h * w, max(1, h * w // 40))
        px[idx] = r.integers(0, 4096, len(idx))
    elif dist == "random8":
        px = r.integers(0, 256, h * w)
    elif dist == "random16":
        px = r.integers(0, 65536, h * w)
    elif dist == "medical":
        base = 1000 * np.exp(-(((xx - w / 2) / (w / 3.0)) ** 2
                               + ((yy - h / 2) / (h / 3.0)) ** 2))
        px = (base + r.normal(0, 9, (h, w))).clip(0, 65535).astype(np.int32).ravel()
    else:  # pragma: no cover - guard against typos in parametrize
        raise AssertionError(dist)
    px = px.astype(np.uint16)
    return px, int(px.max())


DISTS = ["constant", "smooth", "spiky", "random8", "random16", "medical"]


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_fuzz_single_frame_roundtrip(dist, shape):
    w, h = shape
    px, mx = gen_image(dist, w, h, seed=_seed(dist, w, h))
    for comp in (compress_single_frame, compress_single_frame_4state,
                 compress_single_frame_8state, compress_single_frame_rans8):
        try:
            blob = comp(px, w, h, mx)
        except DOCUMENTED:
            continue  # documented refusal (incompressible etc.)
        out = decompress_single_frame(blob, w, h)
        assert np.array_equal(out, px), (dist, shape, comp.__name__)


@pytest.mark.skipif(not native.available(), reason="libmicfse.so not built")
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("shape", SHAPES[1:])
def test_fuzz_native_frame_byte_identity(dist, shape):
    """Wherever the Python 4-state frame encoder succeeds, the native
    encoder must emit byte-identical blobs and decode them bit-exactly."""
    w, h = shape
    px, mx = gen_image(dist, w, h, seed=_seed("nat", dist, w, h))
    try:
        py = compress_single_frame_4state(px, w, h, mx)
    except DOCUMENTED:
        pytest.skip("python tier refused (documented)")
    nat = native.compress_frame_native(px, w, h, mx, kind=native.PRED_AVG, n_states=4)
    assert nat == py
    out = native.decompress_frame_native(py, w, h, native.PRED_AVG)
    assert np.array_equal(out, px)


@pytest.mark.skipif(not native.available(), reason="libmicfse.so not built")
@pytest.mark.parametrize("n_states", [1, 2, 4, 8])
@pytest.mark.parametrize("alphabet", [2, 3, 40, 1000, 40000])
def test_fuzz_entropy_native_identity(n_states, alphabet):
    """Random zipf-ish symbol streams: python and native entropy blobs
    byte-identical for every state count; roundtrip bit-exact."""
    from mic.ops.fse_codec import (
        fse_compress,
        fse_compress_2state,
        fse_compress_4state,
        fse_compress_8state,
        fse_decompress_auto,
    )

    r = np.random.default_rng(42 + n_states * 7 + alphabet)
    p = min(0.9, max(1e-4, 8.0 / alphabet))
    raw = np.minimum(r.geometric(p, 20000) - 1, alphabet - 1).astype(np.uint16)
    comp = {1: fse_compress, 2: fse_compress_2state,
            4: fse_compress_4state, 8: fse_compress_8state}[n_states]
    try:
        py = comp(raw)
    except DOCUMENTED:
        pytest.skip("python tier refused (documented)")
    nat = native.entropy_compress_native(raw, n_states)
    assert nat == py
    assert np.array_equal(fse_decompress_auto(py), raw)
    assert np.array_equal(native.entropy_decompress_native(py, len(raw) + 8),
                          raw)


def test_fuzz_rans8_roundtrip():
    from mic.ops.rans import rans_compress_8state, rans_decompress_8state

    for alphabet in (2, 300, 5000):
        r = np.random.default_rng(alphabet)
        raw = np.minimum(r.geometric(min(0.9, 8.0 / alphabet), 12000) - 1,
                         alphabet - 1).astype(np.uint16)
        try:
            blob = rans_compress_8state(raw)
        except DOCUMENTED:
            continue
        assert np.array_equal(rans_decompress_8state(blob), raw)


@pytest.mark.skipif(not native.available(), reason="libmicfse.so not built")
@pytest.mark.parametrize("dist", ["smooth", "medical", "spiky"])
def test_fuzz_pics_native_pool_identity(dist):
    """Whole-container PICS encode on the native thread pool must stay
    byte-identical to the Python per-strip assembly on random inputs,
    and the threaded decode bit-exact."""
    from mic.parallel.strips import compress_parallel_strips_4state

    w, h = 96, 120
    px, mx = gen_image(dist, w, h, seed=_seed("pics", dist))
    try:
        py = compress_parallel_strips_4state(px, w, h, mx, 4)
    except DOCUMENTED:
        pytest.skip("python tier refused (documented)")
    nat = native.compress_strips_native(px, w, h, mx, kind=native.PRED_AVG, n_states=4, num_strips=4)
    if nat is not None:
        assert nat == py
    out, ow, oh = native.decompress_strips_native(py)
    assert (ow, oh) == (w, h)
    assert np.array_equal(out, px)


@pytest.mark.parametrize("entropy", ["standard", "alias", "best"])
@pytest.mark.parametrize("dist", ["smooth", "medical", "random8"])
def test_fuzz_micw_host_roundtrip(entropy, dist):
    """Device-format MICW host encode/decode round-trips random inputs
    for every entropy family."""
    from mic.device.strips import micw_compress, micw_decompress_host

    w, h = 128, 64
    px, mx = gen_image(dist, w, h, seed=_seed("micw", entropy, dist))
    blob = micw_compress(px, w, h, mx, entropy=entropy)
    out, ow, oh = micw_decompress_host(blob)
    assert (ow, oh) == (w, h)
    assert np.array_equal(np.asarray(out).ravel(), px)


@pytest.mark.skipif(not native.available(), reason="libmicfse.so not built")
def test_fuzz_native_corruption_no_crash():
    """Mutated blobs must never crash the native tier: decode returns
    garbage (reference parity — no CRC) or raises ValueError, nothing
    else.  A segfault here kills the test run — that is the signal."""
    w, h = 96, 120
    px, mx = gen_image("medical", w, h, seed=99)
    frame = native.compress_frame_native(px, w, h, mx, kind=native.PRED_AVG, n_states=4)
    pics = native.compress_strips_native(px, w, h, mx, kind=native.PRED_AVG, n_states=4, num_strips=4)
    r = np.random.default_rng(99)

    def mutations(blob):
        for n in (0, 1, 4, 12, 20, 21, len(blob) // 2, len(blob) - 1):
            yield blob[:n]
        for _ in range(25):
            b = bytearray(blob)
            i = int(r.integers(0, len(b)))
            b[i] ^= 1 << int(r.integers(0, 8))
            yield bytes(b)
        for _ in range(10):  # header/offset-table region specifically
            b = bytearray(blob)
            b[int(r.integers(0, min(64, len(b))))] = 0xFF
            yield bytes(b)

    for mut in mutations(frame):
        try:
            native.decompress_frame_native(mut, w, h, native.PRED_AVG)
        except ValueError:
            pass
    if pics is not None:
        for mut in mutations(pics):
            try:
                native.decompress_strips_native(mut)
            except ValueError:
                pass


@pytest.mark.skipif(not native.available(), reason="libmicfse.so not built")
@pytest.mark.parametrize("alphabet,tl", [(2, 7), (37, 9), (900, 11),
                                         (4000, 12), (30000, 15)])
def test_fuzz_lane_encode_native_equals_numpy(monkeypatch, alphabet, tl):
    """The native MICT lane encoder (magic-multiply division) must match
    the numpy reference loop word-for-word and state-for-state across
    skews that exercise the whole normalized-frequency range."""
    from mic.ops.fse import histogram, optimal_table_log
    from mic.device.device_rans import (
        _lane_encode,
        _norm_and_header,
        device_tables,
    )

    r = np.random.default_rng(alphabet * 13 + tl)
    raw = np.minimum(r.geometric(min(0.9, 6.0 / alphabet), 40000) - 1,
                     alphabet - 1).astype(np.uint16)
    counts, _mc, sl = histogram(raw)
    tl = optimal_table_log(tl, len(raw), sl)
    try:
        norm, _header = _norm_and_header(counts, len(raw), tl, sl)
        _sym, _fs, _bs, freq, cumul = device_tables(norm, tl)
    except DOCUMENTED:
        pytest.skip("stream not normalizable at this tableLog (documented)")
    sym64 = raw.astype(np.int64)
    st_n, w_n = _lane_encode(sym64, len(raw), 128, tl, freq, cumul)
    monkeypatch.setattr("mic.native.lane_encode_native",
                        lambda *a, **k: None)
    st_p, w_p = _lane_encode(sym64, len(raw), 128, tl, freq, cumul)
    assert np.array_equal(np.asarray(st_n, np.uint64),
                          np.asarray(st_p, np.uint64))
    assert np.array_equal(w_n, w_p)


def test_fuzz_huffman_roundtrip():
    from mic.ops.huffman import can_huffman_compress, can_huffman_decompress

    for alphabet in (2, 100, 3000):
        r = np.random.default_rng(alphabet * 3)
        raw = np.minimum(r.geometric(min(0.9, 6.0 / alphabet), 9000) - 1,
                         alphabet - 1).astype(np.uint16)
        try:
            blob = can_huffman_compress(raw)
        except DOCUMENTED:
            continue
        assert np.array_equal(can_huffman_decompress(blob), raw)
