"""Native (C++) tier tests: cross-tier byte-identity and exactness —
the analog of the reference's Go-vs-C cross matrix
(ojph/mic_c_test.go TestFourWayComparison)."""

import numpy as np
import pytest

from mic import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="libmicfse.so not built (make -C mic/native)"
)


@pytest.fixture(scope="module")
def ct(ct_image_module=None):
    import pathlib

    p = pathlib.Path("/root/reference/testdata/CT_512_512_image.bin")
    if not p.exists():
        pytest.skip("missing CT test data")
    px = np.fromfile(p, dtype="<u2")
    return px, 512, 512, int(px.max())


@pytest.mark.parametrize("n_states", [1, 2, 4, 8])
def test_entropy_blob_byte_identity(n_states, ct, rng):
    """Native encoder must produce byte-identical streams to the Python
    tier for every state count."""
    from mic.ops.fse_codec import (
        fse_compress,
        fse_compress_2state,
        fse_compress_4state,
        fse_compress_8state,
    )

    data = (rng.standard_normal(30000) * 30 + 500).clip(0, 2047).astype(np.uint16)
    py = {1: fse_compress, 2: fse_compress_2state, 4: fse_compress_4state, 8: fse_compress_8state}[
        n_states
    ](data)
    nat = native.entropy_compress_native(data, n_states)
    assert nat == py


def test_four_way_cross_matrix(ct):
    """py-enc→native-dec, native-enc→py-dec, native-enc→native-dec,
    py-enc→py-dec all bit-exact on real CT."""
    from mic.models.single_frame import compress_single_frame_4state, decompress_single_frame

    px, w, h, mx = ct
    blob_py = compress_single_frame_4state(px, w, h, mx)
    blob_nat = native.compress_frame_native(px, w, h, mx, kind=native.PRED_AVG, n_states=4)
    assert blob_py == blob_nat  # byte identity

    out_nat = native.decompress_frame_native(blob_py, w, h, native.PRED_AVG)
    out_py = decompress_single_frame(blob_nat, w, h)
    assert np.array_equal(out_nat, px)
    assert np.array_equal(out_py, px)


@pytest.mark.parametrize(
    "kind", [native.PRED_AVG, native.PRED_GRAD, native.PRED_MED, native.PRED_ZZ]
)
def test_native_predictor_roundtrips(kind, rng):
    h, w = 96, 61
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * 30 + 2000).clip(0, 4095).astype(np.uint16)
    mx = int(img.max())
    blob = native.compress_frame_native(img.ravel(), w, h, mx, kind=kind, n_states=4)
    out = native.decompress_frame_native(blob, w, h, kind)
    assert np.array_equal(out, img.ravel())


def test_native_rans_decode(ct):
    """Native decoder handles the rANS-8 magic too."""
    from mic.ops.rans import rans_compress_8state
    from mic.ops.deltarle import delta_rle_compress

    px, w, h, mx = ct
    rle = delta_rle_compress(px, w, h, mx)
    blob = rans_compress_8state(rle)
    out = native.entropy_decompress_native(blob, len(rle) + 64)
    assert np.array_equal(out, rle)


def test_native_corrupt_rejected(ct):
    px, w, h, mx = ct
    from mic.models.single_frame import compress_single_frame

    blob = bytearray(compress_single_frame(px, w, h, mx))
    blob[8] ^= 0xFF  # header corruption
    with pytest.raises(ValueError):
        native.decompress_frame_native(bytes(blob), w, h, native.PRED_AVG)


def test_native_strips_decode(rng):
    """Threaded native PICS decode matches the Python tier and pixels."""
    from mic.native import available, decompress_strips_native
    from mic.parallel.strips import compress_parallel_strips

    if not available():
        import pytest

        pytest.skip("native library not built")
    img = (rng.standard_normal((96, 80)).cumsum(axis=1) * 18 + 1200).astype(np.int32)
    px = ((img >> 2) << 2).clip(0, 4095).astype(np.uint16).ravel()
    blob = compress_parallel_strips(px, 80, 96, int(px.max()), num_strips=4)
    out, w, h = decompress_strips_native(blob, n_threads=4)
    assert (w, h) == (80, 96)
    assert np.array_equal(out, px)


def test_native_rle_amplification_bounded():
    """A crafted stream of max-width same-run blocks must not amplify
    past the caller's token bound (regression: each 2-word block could
    expand to mid=16383 tokens, ~1 GB from a 120 KB stream, before the
    token-count check ran)."""
    import time

    from mic.native import (
        available,
        decompress_frame_native,
        entropy_compress_native,
        PRED_AVG,
    )

    if not available():
        import pytest

        pytest.skip("native library not built")
    K = 30000
    words = np.empty(1 + 2 * K, dtype=np.uint16)
    words[0] = 0x7FFF  # rle maxValue -> mid = 0x3FFF
    words[1::2] = 0x3FFE  # same-run of 16382
    words[2::2] = 123
    blob = entropy_compress_native(words, 4)
    t0 = time.time()
    # Either a bounded garbage frame or an error -- never an OOM/stall.
    decompress_frame_native(bytes(blob), 128, 128, PRED_AVG)
    assert time.time() - t0 < 2.0


def test_native_lane_encode_bit_identity(rng):
    """mic_lane_encode must mirror the numpy _lane_encode bit for bit
    for both the standard (FF 57) and alias (FF 41) slot layouts."""
    import mic.native as native
    from mic.device import device_rans as dr

    if not native.available() or not hasattr(native._load(), "mic_lane_encode"):
        import pytest

        pytest.skip("native library lacks mic_lane_encode")
    for trial in range(4):
        n = int(rng.integers(500, 40000))
        data = np.minimum(rng.geometric(0.06, n), 800).astype(np.uint16)
        for alias in (False, True):
            blob_nat = dr.mict_encode(data, lanes=128, alias=alias)
            real = native.lane_encode_native
            native.lane_encode_native = lambda *a, **k: None
            try:
                blob_np = dr.mict_encode(data, lanes=128, alias=alias)
            finally:
                native.lane_encode_native = real
            assert blob_nat == blob_np, f"trial {trial} alias={alias}"
            assert np.array_equal(dr.mict_decode_numpy(blob_nat), data)


def test_native_normalize_write_count_bit_identity(rng):
    """mic_normalize_write_count must reproduce the Python
    normalize_count + write_count pair exactly across distribution
    shapes (incl. the normalizeCount2 fallback)."""
    from mic.native import _load, available, normalize_write_count_native
    from mic.ops.fse import (
        histogram,
        normalize_count,
        optimal_table_log,
        write_count,
    )

    if not available() or not hasattr(_load(), "mic_normalize_write_count"):
        import pytest

        pytest.skip("native library lacks mic_normalize_write_count")
    checked = 0
    for t in range(80):
        n = int(rng.integers(100, 50000))
        kind = t % 3
        if kind == 0:
            d = np.minimum(rng.geometric(rng.uniform(0.01, 0.5), n), 2000).astype(np.uint16)
        elif kind == 1:
            d = (rng.standard_normal(n) * rng.uniform(5, 700) + 1000).clip(0, 4095).astype(np.uint16)
        else:
            d = rng.integers(0, int(rng.integers(2, 300)), n).astype(np.uint16)
        counts, mc, sl = histogram(d)
        if mc == len(d) or sl < 2:
            continue
        tl = optimal_table_log(11, len(d), sl)
        counts = np.asarray(counts[:sl], dtype=np.int64)
        try:
            norm_py = normalize_count(counts, len(d), tl, sl)
            # Reference validateNorm gate (fsecompressu16.go:58): a
            # non-summing table is a rejection in both tiers.
            if int(np.abs(norm_py).sum()) != (1 << tl):
                raise ValueError("validateNorm")
            hdr_py = write_count(norm_py, sl, tl)
        except Exception:
            assert normalize_write_count_native(counts, len(d), tl, sl) is None
            continue
        nat = normalize_write_count_native(counts, len(d), tl, sl)
        assert nat is not None
        norm_nat, hdr_nat = nat
        assert np.array_equal(norm_nat, norm_py), f"trial {t}"
        assert bytes(hdr_nat) == bytes(hdr_py), f"trial {t}"
        checked += 1
    assert checked > 40


def test_noise_rejected_not_hung():
    """Pathological histogram (u16 noise after escape expansion: hundreds
    of lowprob symbols at a tiny tableLog) used to drive normalizeCount2's
    fixed-point redistribution to a non-summing table, which spun the
    spread loop forever in the native tier.  The reference rejects these
    via validateNorm (fsecompressu16.go:58); both tiers must now reject
    cleanly (regression: round-4 native encode rework)."""
    import pytest

    from mic.models.single_frame import compress_single_frame_4state
    from mic.native import PRED_AVG, available, compress_frame_native

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 65536, 256).astype(np.uint16)
    with pytest.raises(Exception):
        compress_single_frame_4state(arr, 16, 16, int(arr.max()))
    if available():
        with pytest.raises(ValueError):
            compress_frame_native(arr, 16, 16, int(arr.max()), kind=PRED_AVG, n_states=4)


def test_worker_pool_dispatch_subprocess():
    """Exercise the WorkPool cv-dispatch path explicitly: this container
    exposes one core (pool would be empty and parallel_for inline), so a
    subprocess forces MIC_POOL_THREADS=4 and round-trips a threaded PICS
    container repeatedly, including concurrent callers."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    script = r"""
import sys, threading
sys.path.insert(0, %r)
import numpy as np
from mic import native
r = np.random.default_rng(1)
px = (r.standard_normal(512*256)*300 + 1000).clip(0, 4095).astype(np.uint16)
blob = native.compress_strips_native(px, 512, 256, int(px.max()),
                                     kind=native.PRED_AVG, n_states=4,
                                     num_strips=8)
assert blob is not None
errs = []
def w():
    try:
        for _ in range(10):
            out, _, _ = native.decompress_strips_native(blob)
            assert np.array_equal(out, px)
    except Exception as e:
        errs.append(repr(e))
ts = [threading.Thread(target=w) for _ in range(4)]
[t.start() for t in ts]; [t.join() for t in ts]
assert not errs, errs
b2 = native.compress_strips_native(px, 512, 256, int(px.max()),
                                   kind=native.PRED_AVG, n_states=4,
                                   num_strips=8)
assert b2 == blob
print("POOL_OK")
""" % str(Path(__file__).resolve().parent.parent)
    env = {**os.environ, "MIC_POOL_THREADS": "4"}
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-500:]
    assert "POOL_OK" in r.stdout


def test_compress_frame_kind_states_keyword_only(rng):
    """The API footgun that once produced a retracted perf claim:
    compress_frame_native(px, w, h, mv, 4) passed 4 as the PREDICTOR.  kind/n_states are keyword-only now and invalid
    values raise descriptive errors instead of a silent failure path."""
    img = (rng.standard_normal((16, 16)).cumsum(axis=1) * 20 + 500).clip(
        0, 1023
    ).astype(np.uint16)
    mx = int(img.max())
    with pytest.raises(TypeError):
        native.compress_frame_native(img.ravel(), 16, 16, mx, 4)  # noqa
    with pytest.raises(ValueError, match="n_states=4"):
        native.compress_frame_native(img.ravel(), 16, 16, mx, kind=4)
    with pytest.raises(ValueError, match="n_states"):
        native.compress_frame_native(img.ravel(), 16, 16, mx, n_states=3)
    with pytest.raises(TypeError):
        native.compress_strips_native(img.ravel(), 16, 16, mx, 4)  # noqa
