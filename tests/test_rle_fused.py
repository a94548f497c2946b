"""r-mode device decode (entropy kernel → SoA-RLE expand → direct
inverse) — exactness against the host decoder on shapes small enough
for interpret mode, across both stream families (FF 57 and FF 41) and
all three r-predictors.

The fixtures deliberately include the adversarial run grammars: giant
runs above midCount that split into chunks with short tails, length-1
literal stretches between minimum (3-long) same-runs, and short last
strips.
Reference grammar: ops/rle.py soa_encode (parallelstrips.go's RLE
re-laid-out for device decode).
"""

import numpy as np
import pytest

import mic.device.strips as st
from mic.ops.rle import soa_encode, soa_expand


def _roundtrip(px, w, h, pred, ent):
    blob = st.micw_compress(px, w, h, int(px.max()), predictor=pred,
                            entropy=ent)
    out, ow, oh = st.micw_decompress_device(blob)
    assert (ow, oh) == (w, h)
    np.testing.assert_array_equal(np.asarray(out).ravel(), px)
    return blob


def _runs_image(seed=0):
    """128x64 with long background runs + a noisy band (every r-mode
    compresses it; every strip carries both same and literal runs)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((64, 128), np.uint16)
    img[:, :40] = 100
    img[:, 40:80] = rng.integers(90, 110, (64, 40)).astype(np.uint16)
    img[20:30, :] = 500
    return img.ravel()


@pytest.mark.parametrize("pred", ["zzr", "vdr", "pdr"])
@pytest.mark.parametrize("ent", ["standard", "alias"])
def test_rle_fused_exact(pred, ent):
    px = _runs_image()
    _roundtrip(px, 128, 64, pred, ent)


def test_rle_fused_equals_post_path():
    """The device decode and the host decoder produce identical pixels
    from the same blob."""
    px = _runs_image(3)
    blob = st.micw_compress(px, 128, 64, int(px.max()), predictor="zzr")
    dev, _, _ = st.micw_decompress_device(blob)
    host, _, _ = st.micw_decompress_host(blob)
    np.testing.assert_array_equal(np.asarray(dev), np.asarray(host))
    np.testing.assert_array_equal(np.asarray(dev), px)


def test_rle_fused_giant_runs_chunk_split():
    """A constant region longer than midCount splits into <=mid chunks
    (possibly with a short tail) — the expand must walk the chunk
    sequence exactly."""
    img = np.full((144, 128), 777, np.uint16)  # 18432 px > MID_DIRECT
    img[0, :] = np.arange(128, dtype=np.uint16) * 3 + 1  # non-const strip
    img[-1, 64:] = 12345
    px = img.ravel()
    # sanity: the SoA grammar really split a giant run
    syms = st._zzd_syms(px, 128, 144)
    soa, nr, nsm = soa_encode(syms, st.MID_DIRECT)
    assert nr >= 3
    np.testing.assert_array_equal(
        soa_expand(soa, nr, nsm, st.MID_DIRECT), syms)
    _roundtrip(px, 128, 144, "zzr", "standard")


def test_rle_fused_minimal_runs_dense_rows():
    """Alternating 3-long same-runs and 1-long literal stretches: the
    densest runs-per-row grammar (a 128-px row spans ~32 runs) — stress
    for the run-assignment search."""
    row = np.zeros(128, np.uint16)
    row[3::4] = (np.arange(32, dtype=np.uint16) % 7) * 11 + 1
    img = np.tile(row, (64, 1))
    px = img.ravel()
    _roundtrip(px, 128, 64, "zzr", "standard")
    _roundtrip(px, 128, 64, "zzr", "alias")


def test_rle_fused_short_last_strip():
    """Height not divisible by the strip height: the last strip decodes
    fewer tokens than the bucket; its tail rows are garbage the plan
    slices away."""
    rng = np.random.default_rng(5)
    h = 80  # strips of 64 -> last strip 16 rows
    img = np.zeros((h, 128), np.uint16)
    img[:, :96] = 42
    img[:, 96:] = rng.integers(40, 44, (h, 32)).astype(np.uint16)
    px = img.ravel()
    blob = st.micw_compress(px, 128, h, int(px.max()), num_strips=2,
                            predictor="pdr")
    out, _, _ = st.micw_decompress_device(blob)
    np.testing.assert_array_equal(np.asarray(out).ravel(), px)


def test_rle_fused_vdr_wide():
    """vdr at width 256 through the device decode."""
    rng = np.random.default_rng(7)
    img = np.zeros((32, 256), np.uint16)
    img[:, :160] = 1000
    img[:, 160:224] = rng.integers(995, 1005, (32, 64)).astype(np.uint16)
    px = img.ravel()
    _roundtrip(px, 256, 32, "vdr", "standard")


def test_auto_r_container_mixed_modes():
    """auto-r containers mix direct and r-mode strips; the plan decodes
    each group through its own path, bit-exactly."""
    rng = np.random.default_rng(11)
    img = np.zeros((128, 128), np.uint16)
    img[:64] = 300  # r-modes win: pure runs
    img[64:] = rng.integers(0, 2000, (64, 128)).astype(np.uint16)  # direct wins
    px = img.ravel()
    blob = st.micw_compress(px, 128, 128, int(px.max()), num_strips=2,
                            predictor="auto-r", entropy="best")
    out, _, _ = st.micw_decompress_device(blob)
    np.testing.assert_array_equal(np.asarray(out).ravel(), px)
    host, _, _ = st.micw_decompress_host(blob)
    np.testing.assert_array_equal(np.asarray(host).ravel(), px)


def test_tiny_tablelog_strips_sweep_floor():
    """Strips of tiny near-constant data encode with tableLog <= 6 and
    share a launch with larger tables (regression: an earlier staging
    decoded them to garbage)."""
    from mic.device.device_rans import mict_parse

    rng = np.random.default_rng(6)
    h, w = 16, 128
    img = np.zeros((h, w), np.uint16)
    img[:, :80] = 321
    img[:, 80:112] = rng.integers(318, 324, (h, 32)).astype(np.uint16)
    px = img.ravel()
    seen_tls = []
    for pred in ("zzd", "zzr"):
        blob = st.micw_compress(px, w, h, int(px.max()), num_strips=2,
                                predictor=pred)
        _, _, _, _, _, _, _, strips = st.micw_parse(blob)
        seen_tls += [mict_parse(s[0])[1] for s in strips]
        out, _, _ = st.micw_decompress_device(blob)
        np.testing.assert_array_equal(np.asarray(out).ravel(), px)
    assert min(seen_tls) <= 6, \
        f"fixture must exercise tiny tableLogs, got {seen_tls}"


@pytest.mark.parametrize("seed,pred,ent", [(21, "zzr", "standard"),
                                           (22, "vdr", "alias"),
                                           (23, "pdr", "best")])
def test_rle_fused_random_grammar(seed, pred, ent):
    """Seeded random run grammars (geometric run lengths, random values,
    random literal stretches) through the device path — the
    randomized complement to the hand-built adversarial fixtures."""
    rng = np.random.default_rng(seed)
    h, w = 64, 128
    vals = []
    while sum(len(v) for v in vals) < h * w:
        if rng.random() < 0.6:
            vals.append(np.full(int(rng.geometric(0.02)),
                                rng.integers(0, 1200), np.uint16))
        else:
            vals.append(rng.integers(0, 1200,
                                     int(rng.geometric(0.3))).astype(np.uint16))
    px = np.concatenate(vals)[: h * w]
    _roundtrip(px, w, h, pred, ent)


def _stripe_image(w=256, h=32):
    """Worst-case FLAG_RDENSE density: alternating 16-px same-runs and
    single odd pixels — every 128-px output row spans the maximum run
    count the dense bound allows (~19 runs)."""
    vals = []
    v = 100
    while len(vals) < w:
        vals += [v] * 16 + [v + 1]
        v += 3
    row = np.array(vals[:w], np.uint16)
    return np.tile(row, h)


def test_rdense_flag_set_and_worst_case_roundtrip():
    """New r-mode containers carry FLAG_RDENSE (same-runs >= 16 via
    soa_encode min_same) and the device expand decodes the densest legal
    grammar bit-exactly."""
    px = _stripe_image()
    blob = _roundtrip(px, 256, 32, "zzr", "standard")
    assert blob[22] & st.FLAG_RDENSE


def test_rdense_legacy_blob_uses_window_path():
    """A flag-stripped (pre-v6 grammar) blob still decodes — the expand
    does not depend on the flag, so mixed archives stay correct."""
    px = _stripe_image()
    blob = bytearray(st.micw_compress(px, 256, 32, int(px.max()),
                                      predictor="zzr", entropy="standard"))
    blob[22] &= ~st.FLAG_RDENSE
    out, ow, oh = st.micw_decompress_device(bytes(blob))
    np.testing.assert_array_equal(np.asarray(out).ravel(), px)


def test_rdense_kill_switch():
    """Dense and flag-stripped copies of one blob decode together in one
    plan, to the same pixels."""
    px = _stripe_image()
    blob = st.micw_compress(px, 256, 32, int(px.max()), predictor="zzr",
                            entropy="standard")
    legacy = bytearray(blob)
    legacy[22] &= ~st.FLAG_RDENSE
    outs = st.micw_decode_many([blob, bytes(legacy)])
    for out, _, _ in outs:
        np.testing.assert_array_equal(np.asarray(out).ravel(), px)


def test_rdense_long_run_balanced_split():
    """Same-runs longer than midCount split into balanced chunks (each
    >= min_same) so the density bound survives giant runs."""
    n = st.MID_DIRECT * 2 + 7  # would leave a 7-px tail under greedy split
    syms = np.full(n, 42, np.uint16)
    soa, nr, nsm = soa_encode(syms, st.MID_DIRECT, min_same=16)
    counts = soa[:nr].astype(int)
    same_lens = [c for c in counts if c <= st.MID_DIRECT]
    assert all(c >= 16 for c in same_lens), same_lens
    np.testing.assert_array_equal(soa_expand(soa, nr, nsm, st.MID_DIRECT), syms)
