"""MICW containers with alias-mapped (FF 41) entropy strips.

``micw_compress(..., entropy="alias")`` writes FF 41 strips; every
decode tier must agree bit-exactly with the pixels: the host numpy
decoder and the device plan (micw_decode_many / micw_decompress_device),
whose in-program escape substitution this file exercises."""

import numpy as np
import pytest

pytest.importorskip("jax")

from mic.device.device_rans import mict_parse  # noqa: E402
from mic.device.strips import (  # noqa: E402
    MicwDecodePlan,
    micw_compress,
    micw_decode_many,
    micw_decompress_device,
    micw_decompress_host,
    micw_parse,
    strip_predictor,
)


def _smooth(rng, h, w, scale=11, base=700):
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * scale + base)
    return img.clip(0, 4095).astype(np.uint16)


def _spiky(rng, h, w):
    """Wide-alphabet content: smooth base + salt spikes so the zz-delta
    alphabet exceeds the 255 kept symbols and escape folding triggers."""
    img = _smooth(rng, h, w).astype(np.int32)
    mask = rng.random((h, w)) < 0.03
    img = np.where(mask, rng.integers(0, 4095, (h, w)), img)
    return img.astype(np.uint16)


@pytest.mark.parametrize("pred", ["auto-fast", "zzd", "vdd", "pdd", "zzr", "auto"])
def test_alias_container_all_tiers(rng, pred):
    h, w = 48, 256
    px = _smooth(rng, h, w).ravel()
    blob = micw_compress(px, w, h, int(px.max()), num_strips=3,
                         predictor=pred, entropy="alias")
    parsed = [mict_parse(st[0]) for st in micw_parse(blob)[7]
              if strip_predictor(micw_parse(blob)[5], st[5]) is not None]
    assert all(p[7] is not None for p in parsed), "strips must be FF 41"
    for fn in (micw_decompress_host, micw_decompress_device):
        out, ww, hh = fn(blob)
        assert (ww, hh) == (w, h)
        assert np.array_equal(out, px), fn.__name__
    assert np.array_equal(micw_decode_many([blob, blob])[1][0], px)


def test_alias_escape_folding_roundtrip(rng):
    """Spiky content: the zz-delta alphabet exceeds 255 -> escape-folded
    strips; every tier must substitute ESC values correctly."""
    h, w = 32, 256
    px = _spiky(rng, h, w).ravel()
    blob = micw_compress(px, w, h, int(px.max()), num_strips=2,
                         predictor="zzd", entropy="alias")
    n_esc = sum(len(p[7][1]) for p in
                (mict_parse(st[0]) for st in micw_parse(blob)[7])
                if p[7] is not None)
    assert n_esc > 0, "test content failed to trigger escape folding"
    for fn in (micw_decompress_host, micw_decompress_device):
        out, _, _ = fn(blob)
        assert np.array_equal(out, px), fn.__name__


def test_alias_fused_vdd_pdd_with_escapes(rng):
    """Escape substitution ahead of the vdd (column prefix sum) and pdd
    (two prefix sums) inverses, not just raw/zzd — spiky
    vertical/plane-gradient content forces escape-folded vdd/pdd
    strips."""
    h, w = 32, 256
    base = (np.arange(h)[:, None] * 37
            + (rng.standard_normal((h, w)).cumsum(1) * 3).astype(np.int64)
            + 500)
    m = rng.random((h, w)) < 0.02
    img = np.where(m, rng.integers(0, 4095, (h, w)), base)
    px = np.clip(img, 0, 4095).astype(np.uint16).ravel()
    for pred in ("vdd", "pdd"):
        blob = micw_compress(px, w, h, int(px.max()), num_strips=2,
                             predictor=pred, entropy="alias")
        parsed = micw_parse(blob)
        ent = [mict_parse(st[0]) for st in parsed[7]
               if strip_predictor(parsed[5], st[5]) is not None]
        assert ent, f"{pred}: every strip fell to raw"
        n_esc = sum(len(p[7][1]) for p in ent if p[7] is not None)
        assert n_esc > 0, f"{pred}: no escapes triggered"
        out, _, _ = micw_decompress_device(blob)
        assert np.array_equal(out, px), pred


def test_mixed_standard_alias_plan(rng):
    """One MicwDecodePlan over standard and alias blobs: both families
    share the entropy launch, outputs must all be exact."""
    h, w = 48, 256
    px = _smooth(rng, h, w).ravel()
    mx = int(px.max())
    b_std = micw_compress(px, w, h, mx, num_strips=3)
    b_al = micw_compress(px, w, h, mx, num_strips=3, entropy="alias")
    for out, ww, hh in micw_decode_many([b_std, b_al, b_al, b_std]):
        assert (ww, hh) == (w, h)
        assert np.array_equal(out, px)


def test_best_entropy_mixed_container(rng):
    """entropy="best" keeps the smaller of FF 57/FF 41 per strip; the
    container must be <= both pure modes and decode exactly everywhere."""
    h, w = 64, 256
    px = _spiky(rng, h, w).ravel()
    mx = int(px.max())
    b_std = micw_compress(px, w, h, mx, num_strips=2)
    b_al = micw_compress(px, w, h, mx, num_strips=2, entropy="alias")
    b_best = micw_compress(px, w, h, mx, num_strips=2, entropy="best")
    assert len(b_best) <= min(len(b_std), len(b_al)) + 8
    for fn in (micw_decompress_host, micw_decompress_device):
        out, _, _ = fn(b_best)
        assert np.array_equal(out, px), fn.__name__


def test_best_keeps_wide_alphabet_alias_candidates(rng):
    """Regression: wide-alphabet strips (> MAX_ALPHABET distinct deltas)
    are alias-encodable via escape folding; "best" must not drop them to
    raw just because the standard estimate is infeasible."""
    h, w = 128, 256
    img = np.full((h, w), 800, np.int32)
    m = rng.random((h, w)) < 0.15
    img = np.where(m, rng.integers(0, 40000, (h, w)), img).astype(np.uint16)
    px = img.ravel()
    b_al = micw_compress(px, w, h, int(px.max()), entropy="alias")
    b_best = micw_compress(px, w, h, int(px.max()), entropy="best")
    assert len(b_best) <= len(b_al) + 8
    out, _, _ = micw_decompress_host(b_best)
    assert np.array_equal(out, px)


def test_alias_encoder_caps_table_log_at_12():
    """Regression: optimal_table_log's density rule may bump past the
    request; the alias encoder must hard-cap at 12 (part of the FF 41
    format)."""
    from mic.device.device_rans import mict_encode_alias, mict_parse
    from mic.device.rans_kernel import MAX_TABLE_LOG, FlatStreams

    lrng = np.random.default_rng(7)
    d = (lrng.standard_normal(131072) * 600 + 2000).clip(0, 4095).astype(np.uint16)
    p = mict_parse(mict_encode_alias(d, table_log=11))
    assert p[1] <= 12
    FlatStreams([p])  # must not raise
    # Defensive check: a hand-rolled parse beyond the decoder's table
    # packing is rejected, not silently mispacked.
    bogus = (128, MAX_TABLE_LOG + 1, p[2], p[3], p[4], p[5], p[6], p[7])
    with pytest.raises(ValueError, match="tableLog"):
        FlatStreams([bogus])


def test_alias_timed_runner(rng):
    """A staged plan (what the benchmark times) decodes alias and best
    containers exactly on every run."""
    h, w = 32, 256
    px = _smooth(rng, h, w).ravel()
    for entropy in ("alias", "best"):
        blob = micw_compress(px, w, h, int(px.max()), num_strips=2,
                             entropy=entropy)
        plan = MicwDecodePlan([blob, blob])
        for _ in range(2):
            for out, _w, _h in plan.assemble(plan.run()):
                assert np.array_equal(out, px), entropy


def test_alias_ratio_within_one_pct(rng):
    """FF 41's alias layout preserves the normalized frequencies; with
    tl=12 vs the FF 57 cap 11, the alias blob lands within ~1% of the
    standard blob (measured corpus cost: -0.68%)."""
    h, w = 128, 256
    px = _smooth(rng, h, w).ravel()
    mx = int(px.max())
    b_std = micw_compress(px, w, h, mx, num_strips=2)
    b_al = micw_compress(px, w, h, mx, num_strips=2, entropy="alias")
    assert len(b_al) < len(b_std) * 1.02


def test_replicated_plan_chunk_cycle_dedup(rng):
    """Replicated plans share one copy of each distinct strip's table
    and words (FlatStreams dedups by parse identity) and stay bit-exact
    for every replica, at a strip count that fills no launch group."""
    from mic.device.rans_kernel import FlatStreams

    h, w = 18, 256  # 3 strips/image at num_strips=3
    px = _smooth(rng, h, w).ravel()
    blob = micw_compress(px, w, h, int(px.max()), num_strips=3,
                         entropy="alias")
    k = 22  # 66 strips: not a multiple of the kernel's strip group
    parsed = [mict_parse(st[0]) for st in micw_parse(blob)[7]]
    one = FlatStreams(parsed)
    many = FlatStreams(parsed * k)
    assert len(many.words) == len(one.words)
    assert len(many.tab_sym) == len(one.tab_sym)
    outs = micw_decode_many([blob] * k)
    for o in outs:
        assert np.array_equal(np.asarray(o[0]).ravel(), px)
