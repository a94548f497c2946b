"""Corruption-hardening regression tests (round-2 advisor findings).

The reference enforces a DecompressLimit in every N-state decoder
(fse2state.go:249, rans8state.go:276) and its C tier bounds-checks the
two-pass expand.  These tests pin the same behavior in both tiers:
untrusted count headers must be rejected before allocation, truncated
RLE blocks must not over-read, and exhausted bit readers must not read
below the stream buffer.
"""

import numpy as np
import pytest

from mic import native
from mic.ops.deltarle import delta_rle_compress
from mic.ops.fse_codec import (
    fse_compress_4state,
    fse_decompress_4state,
    fse_decompress_auto,
)
from mic.ops.huffman import can_huffman_compress, can_huffman_decompress
from mic.ops.rans import rans_compress_8state, rans_decompress_8state

needs_native = pytest.mark.skipif(
    not native.available(), reason="libmicfse.so not built"
)


@pytest.fixture()
def sample_syms(rng):
    return (rng.standard_normal(4000) * 20 + 300).clip(0, 1023).astype(np.uint16)


def _with_count(blob: bytes, count: int) -> bytes:
    """Overwrite the u32 count field of an N-state stream."""
    return blob[:2] + int(count).to_bytes(4, "little") + blob[6:]


def test_py_counted_fse_respects_limit(sample_syms):
    blob = fse_compress_4state(sample_syms)
    huge = _with_count(blob, 0xFFFFFFF0)
    with pytest.raises(ValueError, match="DecompressLimit"):
        fse_decompress_4state(huge, limit=1 << 20)
    with pytest.raises(ValueError, match="DecompressLimit"):
        fse_decompress_auto(huge, limit=1 << 20)


def test_py_rans_respects_limit(sample_syms):
    blob = rans_compress_8state(sample_syms)
    huge = _with_count(blob, 0xFFFFFFF0)
    with pytest.raises(ValueError, match="DecompressLimit"):
        rans_decompress_8state(huge, limit=1 << 20)


def test_py_huffman_respects_limit(sample_syms):
    blob = can_huffman_compress(sample_syms)
    # n_out is the first 32 bits, MSB-first.
    huge = int(0xFFFFFFF0).to_bytes(4, "big") + blob[4:]
    with pytest.raises(ValueError, match="DecompressLimit"):
        can_huffman_decompress(huge, limit=1 << 20)


@needs_native
def test_native_counted_huge_count_rejected(sample_syms):
    blob = fse_compress_4state(sample_syms)
    huge = _with_count(blob, 0xFFFFFFF0)
    # Native entropy decode returns 0 symbols (error) instead of
    # allocating 8GB / crashing.
    with pytest.raises(ValueError):
        native.entropy_decompress_native(huge, len(sample_syms) + 64)


@needs_native
def test_native_count_above_frame_limit_rejected(rng):
    img = (rng.standard_normal((32, 32)).cumsum(axis=1) * 9 + 500).clip(
        0, 1023
    ).astype(np.uint16)
    blob = native.compress_frame_native(img.ravel(), 32, 32, int(img.max()),
                                        kind=native.PRED_AVG, n_states=4)
    huge = _with_count(bytes(blob), 0x7FFFFFF0)
    with pytest.raises(ValueError):
        native.decompress_frame_native(huge, 32, 32, native.PRED_AVG)


@needs_native
def test_native_truncated_stream_no_crash(rng):
    """Truncations at every prefix either decode-fail or produce wrong
    pixels — never crash or hang (bit reader parks in the front pad)."""
    img = (rng.standard_normal((48, 40)).cumsum(axis=1) * 14 + 800).clip(
        0, 2047
    ).astype(np.uint16)
    blob = bytes(
        native.compress_frame_native(img.ravel(), 40, 48, int(img.max()),
                                     kind=native.PRED_AVG, n_states=4)
    )
    for cut in list(range(7, min(len(blob), 64))) + [len(blob) - 1]:
        trunc = blob[:cut] + b"\x01"  # keep a nonzero last byte
        try:
            native.decompress_frame_native(trunc, 40, 48, native.PRED_AVG)
        except ValueError:
            pass  # rejection is fine; crashing is not


@needs_native
def test_native_corrupt_rle_literal_run_no_overread(rng):
    """A symbol stream whose trailing literal-run header overruns the
    buffer must not copy out-of-bounds heap memory into pixels."""
    img = (rng.standard_normal((16, 16)) * 5 + 100).clip(0, 255).astype(np.uint16)
    w = h = 16
    mx = int(img.max())
    # Build an RLE stream then corrupt the final block header to claim a
    # huge literal run; re-encode through the entropy stage.
    from mic.ops.deltarle import delta_rle_compress as drc

    rle = np.asarray(drc(img.ravel(), w, h, mx), dtype=np.uint16).copy()
    depth = max(mx.bit_length(), 1)
    mid = (1 << depth) - 1  # delim; rle[0] is the delim for fused streams
    rle[-2] = mid + 200  # literal run far past the end
    blob = fse_compress_4state(rle)
    try:
        native.decompress_frame_native(blob, w, h, native.PRED_AVG)
    except ValueError:
        pass


@needs_native
def test_native_strips_bad_geometry_rejected(rng):
    from mic.parallel.strips import compress_parallel_strips

    img = (rng.standard_normal((64, 128)).cumsum(axis=1) * 18 + 1200).astype(np.int32)
    px = ((img >> 4) << 4).clip(0, 4095).astype(np.uint16).ravel()
    blob = bytearray(compress_parallel_strips(px, 128, 64, int(px.max()), num_strips=4))
    # strip_h lives at offset 16; corrupt it so ns*strip_h no longer
    # covers height (and s*strip_h can pass height).
    blob[16:20] = int(3).to_bytes(4, "little")
    with pytest.raises(ValueError):
        native.decompress_strips_native(bytes(blob))
    # Overflow-bait geometry: huge strip_h.
    blob[16:20] = int(0xF0000000).to_bytes(4, "little")
    with pytest.raises(ValueError):
        native.decompress_strips_native(bytes(blob))


def test_alias_corrupt_escape_stream_rejected(rng):
    """FF 41 hardening: truncated or mis-counted escape side streams must
    fail loudly (bounds check in mict_parse, count check in the
    substitution), never read out of bounds or silently corrupt."""
    import struct

    import pytest

    from mic.device import device_rans as dr

    base = np.minimum(rng.geometric(0.1, 4000), 40).astype(np.uint16)
    tail = rng.integers(0, 30000, 4000).astype(np.uint16)
    data = np.where(rng.random(4000) < 0.1, tail, base)
    blob = dr.mict_encode_alias(data, table_log=11)
    p = dr.mict_parse(blob)
    assert p[7] is not None and len(p[7][1]) > 0

    # Truncated blob: the side stream no longer fits.
    with pytest.raises(ValueError):
        dr.mict_parse(blob[:-10])

    # Inflated nEsc: the claimed side stream overruns the blob.
    b2 = bytearray(blob)
    n_esc = struct.unpack_from("<I", b2, 12)[0]
    struct.pack_into("<I", b2, 12, n_esc + 5)
    with pytest.raises(ValueError):
        dr.mict_parse(bytes(b2))

    # Deflated nEsc parses (stream still in bounds) but the decoded ESC
    # count no longer matches the side stream: substitution must raise.
    b3 = bytearray(blob)
    struct.pack_into("<I", b3, 12, n_esc - 1)
    with pytest.raises(ValueError):
        dr.mict_decode_numpy(bytes(b3))


def test_alias_forged_zero_escape_count_rejected(rng):
    """Regression: nEsc forged to 0 parses (stream in bounds) but the
    decoded ESC placeholders then have no side values — substitution
    must raise, not silently leave placeholders; and an alias blob
    truncated inside its 18-byte header must raise ValueError, not
    struct.error."""
    import struct

    import pytest

    from mic.device import device_rans as dr

    base = np.minimum(rng.geometric(0.1, 4000), 40).astype(np.uint16)
    tail = rng.integers(0, 30000, 4000).astype(np.uint16)
    data = np.where(rng.random(4000) < 0.1, tail, base)
    blob = dr.mict_encode_alias(data, table_log=11)
    b = bytearray(blob)
    struct.pack_into("<I", b, 12, 0)
    with pytest.raises(ValueError):
        dr.mict_decode_numpy(bytes(b))
    with pytest.raises(ValueError):
        dr.mict_parse(blob[:14])


def test_micw_truncated_banded_extension_rejected(rng):
    """A banded container truncated inside the 8-byte orig_w/orig_h
    extension (or inside the strip table) must raise ValueError, not
    struct.error (consistency with the alias-header checks)."""
    from mic.device.strips import (
        MICW_HEADER,
        micw_band_info,
        micw_compress,
        micw_parse,
    )

    img = (rng.standard_normal((64, 1024)).cumsum(axis=1) * 10 + 900)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    blob = micw_compress(px, 1024, 64, int(px.max()))
    assert micw_band_info(blob) == (1024, 64)  # banded by construction
    with pytest.raises(ValueError):  # truncated inside the extension
        micw_band_info(blob[:MICW_HEADER + 3])
    for cut in (MICW_HEADER + 3, MICW_HEADER + 8 + 5):
        with pytest.raises(ValueError):  # extension or strip table cut
            micw_parse(blob[:cut])
