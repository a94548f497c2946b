"""Bit I/O contract tests (reference: bitwriter.go / bitreader.go semantics)."""

import numpy as np
import pytest

from mic.ops.bitio import (
    BitWriterLSB,
    BitWriterMSB,
    ForwardBitReader,
    ReverseBitReader,
    pack_bits_lsb,
    pack_bits_msb,
)


def test_lsb_reverse_roundtrip(rng):
    vals, widths = [], []
    for _ in range(5000):
        w = int(rng.integers(0, 25))
        v = int(rng.integers(0, 1 << max(w, 1)))
        vals.append(v)
        widths.append(w)
    bw = BitWriterLSB()
    for v, w in zip(vals, widths):
        bw.add_bits(v, w)
    data = bw.close()
    r = ReverseBitReader(data)
    for v, w in reversed(list(zip(vals, widths))):
        assert r.get_bits(w) == (v & ((1 << w) - 1))
    assert r.pos == 0
    assert r.finished()


def test_end_mark_alignment():
    # A single 3-bit value: stream should be 1 byte with end mark at bit 3.
    bw = BitWriterLSB()
    bw.add_bits(0b101, 3)
    data = bw.close()
    assert len(data) == 1
    assert data[0] == 0b1101  # value bits 0-2, end mark at bit 3
    r = ReverseBitReader(data)
    assert r.total_bits == 3
    assert r.get_bits(3) == 0b101


def test_empty_close_is_endmark_only():
    bw = BitWriterLSB()
    data = bw.close()
    assert data == b"\x01"
    r = ReverseBitReader(data)
    assert r.total_bits == 0
    assert r.finished()


def test_reverse_reader_rejects_zero_tail():
    with pytest.raises(ValueError):
        ReverseBitReader(b"\x12\x00")


def test_msb_forward_roundtrip(rng):
    vals, widths = [], []
    for _ in range(5000):
        w = int(rng.integers(1, 33))
        v = int(rng.integers(0, 1 << w))
        vals.append(v)
        widths.append(w)
    data = pack_bits_msb(np.array(vals, np.uint64), np.array(widths, np.uint64))
    fr = ForwardBitReader(data)
    for v, w in zip(vals, widths):
        assert fr.get_bits(w) == v


def test_msb_writer_matches_packer(rng):
    bw = BitWriterMSB()
    vals = [(0b1011, 4), (0xFFFF, 16), (1, 1), (0, 3), (0x12345, 20)]
    for v, w in vals:
        bw.add_bits(v, w)
    data = bw.flush_align()
    fr = ForwardBitReader(data)
    for v, w in vals:
        assert fr.get_bits(w) == v


def test_pack_lsb_known_bytes():
    # 0xA (4 bits) then 0x3 (2 bits): byte0 = 0b..11_1010
    out = pack_bits_lsb(np.array([0xA, 0x3], np.uint64), np.array([4, 2], np.uint64))
    assert out == bytes([0b111010])


def test_forward_reader_zero_pad_past_end():
    fr = ForwardBitReader(b"\xff")
    assert fr.get_bits(8) == 0xFF
    assert fr.get_bits(16) == 0  # zero-padded past end
