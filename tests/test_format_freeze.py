"""Format-freeze golden tests: every encoder's output bytes are pinned by
hash on a fixed synthetic fixture.  A hash change means the stream format
changed — which breaks compatibility with blobs written by earlier
versions (and, for the host formats, with the reference codec).  Only
change a hash deliberately, with a format-version bump.
"""

import hashlib

import numpy as np
import pytest

GOLDEN = {
    "fse1": "5886ca0727de0411",
    "fse2": "a45c6254df623dff",
    "fse4": "26ebf31c1220b90c",
    "fse8": "2b93014260314ef4",
    "rans8": "e3b0157ff4d03aa6",
    "huffman": "63b16e2caa9da982",
    "single_frame_2s": "84d34196f576efbc",
    "single_frame_grad": "9bd49a80e70b6e04",
    "gap": "9b21e945533e44d6",
    "wavelet_v2": "d442800e4a4b5e9c",
    "pics": "69241187924d2c37",
    "pica": "77458032c6c785a9",
    "mic2": "7750a9305c897a16",
    "micr": "2737e26f318b2358",
    "mic3": "8e1b39ca2eb157f6",
    # micw regenerated 2026-08-16 (round 2): v4 bump — per-strip adaptive
    # predictor modes (auto default), tableLog cap 11 -> 12.
    "micw": "ce9ea8e836118647",
    # the fixed-zzd pipeline stays pinned separately (device encode path)
    "micw_zzd": "566abbaa0d28efa7",
    # v5 (round 3): plane-direct strips (STRIP_MODE_PDD), RLE'd direct
    # modes (zzr/vdr/pdr), banded wide containers (FLAG_BANDED + 8-byte
    # orig-geometry extension), default strips 64 -> 128 rows.
    "micw_pdd": "ba32ceeceda22e3f",
    # round 3 (honest-throughput retune): encoder tableLog cap 12 -> 11
    # (+54% measured decode for -1.8% ratio); decoder still reads tl<=12.
    "micw_banded": "3c291679257714b6",
    # FF 41 alias-mapped entropy family pinned.
    "micw_alias": "08c95a5056ba52b7",
    # v6 (round 5): FLAG_RDENSE — r-mode strips use the dense run
    # grammar (soa_encode min_same=16, balanced long-run splits) so the
    # device expand may use the 32-candidate search.  Pinned 2026-08-19.
    "micw_rdense": "e774e6be625d81c3",
}


@pytest.fixture(scope="module")
def fixture_data():
    rng = np.random.default_rng(20260816)
    img = (rng.standard_normal((48, 64)).cumsum(axis=1) * 8 + 1000).astype(np.int32)
    img = (img >> 2 << 2).clip(0, 4095).astype(np.uint16)
    px = img.ravel()
    sym = (rng.standard_normal(5000) * 25 + 300).clip(0, 1023).astype(np.uint16)
    f2 = ((px.astype(np.int32) + rng.integers(-2, 3, px.size) * 4).clip(0, 4095)).astype(
        np.uint16
    )
    rgb = rng.integers(0, 256, 32 * 32 * 3).astype(np.uint8)
    return px, int(px.max()), sym, f2, rgb


def _h(b: bytes) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()[:16]


def _encode(name, fixture_data):
    px, mx, sym, f2, rgb = fixture_data
    import mic
    from mic.models import rgb as rgbm
    from mic.models import wavelet_pipeline as wp
    from mic.ops import gapremoval, huffman
    from mic.parallel import multiframe, strips, strips_adaptive, wsi
    from mic.device import strips as micw

    return {
        "fse1": lambda: mic.fse_compress(sym),
        "fse2": lambda: mic.fse_compress_2state(sym),
        "fse4": lambda: mic.fse_compress_4state(sym),
        "fse8": lambda: mic.fse_compress_8state(sym),
        "rans8": lambda: mic.rans_compress_8state(sym),
        "huffman": lambda: huffman.can_huffman_compress(sym),
        "single_frame_2s": lambda: mic.compress_single_frame(px, 64, 48, mx),
        "single_frame_grad": lambda: mic.compress_single_frame_grad(px, 64, 48, mx),
        "gap": lambda: gapremoval.compress_single_frame_gap_removal(px, 64, 48, mx),
        "wavelet_v2": lambda: wp.wavelet_v2_rle_fse_compress(px, 48, 64, mx, 3),
        "pics": lambda: strips.compress_parallel_strips(px, 64, 48, mx, 2),
        "pica": lambda: strips_adaptive.compress_parallel_strips_adaptive(px, 64, 48, mx, 2),
        "mic2": lambda: multiframe.compress_multi_frame([px, f2], 64, 48, mx, True),
        "micr": lambda: rgbm.compress_rgb(rgb, 32, 32),
        "mic3": lambda: wsi.compress_wsi(
            rgb, 32, 32, 3, 8,
            wsi.WSIOptions(tile_width=16, tile_height=16, pyramid_levels=1, workers=1),
        ),
        "micw": lambda: micw.micw_compress(px, 64, 48, mx, lanes=64),
        "micw_zzd": lambda: micw.micw_compress(px, 64, 48, mx, lanes=64,
                                               predictor="zzd"),
        "micw_pdd": lambda: micw.micw_compress(px, 64, 48, mx, lanes=64,
                                               predictor="pdd"),
        "micw_alias": lambda: micw.micw_compress(px, 64, 48, mx, lanes=64,
                                                 entropy="alias"),
        "micw_rdense": lambda: micw.micw_compress(px, 64, 48, mx, lanes=64,
                                                  predictor="zzr"),
        "micw_banded": lambda: _banded_fixture(micw),
    }[name]()


def _banded_fixture(micw):
    rng = np.random.default_rng(20260817)
    wide = (rng.standard_normal((96, 1024)).cumsum(axis=1) * 8 + 1000).astype(np.int32)
    wide = wide.clip(0, 4095).astype(np.uint16).ravel()
    return micw.micw_compress(wide, 1024, 96, int(wide.max()), lanes=64)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_format_frozen(name, fixture_data):
    assert _h(_encode(name, fixture_data)) == GOLDEN[name], (
        f"{name} stream bytes changed — format drift! If intentional, bump "
        "the format version and regenerate the golden hash."
    )
