"""MIC3 — tiled whole-slide-image container with pyramid levels
(reference wsiformat.go + wsicompress.go).

Format (wsiformat.go:14-48)::

    HEADER (48B): "MIC3" | version u32 | width u32 | height u32
                  tileW u32 | tileH u32 | channels u16 | bps u8 | flags u8
                  levelCount u16 | 2 reserved | totalTiles u64 | 8 reserved
    LEVELS (20B each): width, height, tilesX, tilesY, firstTileIdx (u32)
    TILE TABLE (16B each): offset u64, length u64
    DATA: concatenated tile blobs

Tiles are 256×256 by default, zero-padded at edges, compressed in
parallel (worker pool on the host tier; batched device decode on the
device tier).  RGB tiles go through YCoCg-R; constant background tiles collapse
to 15–17 bytes.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..models.rgb import (
    compress_rgb_tile_blob,
    compress_wsi_plane,
    decompress_rgb_tile_blob,
    decompress_wsi_plane,
)
from ..ops.pyramid import downsample2x_grey, downsample2x_rgb

__all__ = [
    "WSIOptions",
    "WSIHeader",
    "WSILevel",
    "compress_wsi",
    "decompress_wsi_tile",
    "decompress_wsi_region",
    "read_wsi_header",
    "write_mic3",
    "read_mic3_header",
    "extract_tile_blob",
]

MIC3_MAGIC = b"MIC3"
MIC3_VERSION = 1
MIC3_HEADER_SIZE = 48
MIC3_LEVEL_SIZE = 20
MIC3_TILE_ENT_SIZE = 16
FLAG_SPATIAL = 0x01
FLAG_COLOR_TRANSFORM = 0x02


@dataclass
class WSILevel:
    width: int
    height: int
    tiles_x: int
    tiles_y: int
    first_tile_idx: int


@dataclass
class WSIHeader:
    width: int
    height: int
    tile_width: int
    tile_height: int
    channels: int
    bits_per_sample: int
    color_transform: bool
    levels: list[WSILevel] = field(default_factory=list)


@dataclass
class WSIOptions:
    tile_width: int = 0
    tile_height: int = 0
    pyramid_levels: int = 0
    color_transform: bool = False
    workers: int = 0

    def defaults(self, channels: int) -> None:
        if self.tile_width == 0:
            self.tile_width = 256
        if self.tile_height == 0:
            self.tile_height = 256
        if channels == 3 and not self.color_transform:
            self.color_transform = True


def auto_level_count(width, height, tile_w, tile_h) -> int:
    levels = 1
    w, h = width, height
    while w > tile_w or h > tile_h:
        w //= 2
        h //= 2
        levels += 1
        if w <= 1 and h <= 1:
            break
    return levels


def compute_levels(width, height, tile_w, tile_h, num_levels) -> list[WSILevel]:
    levels = []
    w, h = width, height
    tile_idx = 0
    for _ in range(num_levels):
        tx = (w + tile_w - 1) // tile_w
        ty = (h + tile_h - 1) // tile_h
        levels.append(WSILevel(w, h, tx, ty, tile_idx))
        tile_idx += tx * ty
        w = max(w // 2, 1)
        h = max(h // 2, 1)
    return levels


def write_mic3(hdr: WSIHeader, tile_blobs: list[bytes]) -> bytes:
    total = sum(lv.tiles_x * lv.tiles_y for lv in hdr.levels)
    if len(tile_blobs) != total:
        raise ValueError(f"MIC3: tile count mismatch: header implies {total}, got {len(tile_blobs)}")
    out = bytearray()
    out += MIC3_MAGIC
    out += struct.pack("<IIIII", MIC3_VERSION, hdr.width, hdr.height, hdr.tile_width, hdr.tile_height)
    flags = FLAG_SPATIAL | (FLAG_COLOR_TRANSFORM if hdr.color_transform else 0)
    out += struct.pack("<HBB", hdr.channels, hdr.bits_per_sample, flags)
    out += struct.pack("<HH", len(hdr.levels), 0)
    out += struct.pack("<QQ", total, 0)
    assert len(out) == MIC3_HEADER_SIZE
    for lv in hdr.levels:
        out += struct.pack("<IIIII", lv.width, lv.height, lv.tiles_x, lv.tiles_y, lv.first_tile_idx)
    offset = 0
    for blob in tile_blobs:
        out += struct.pack("<QQ", offset, len(blob))
        offset += len(blob)
    for blob in tile_blobs:
        out += blob
    return bytes(out)


def read_mic3_header(data: bytes):
    """Returns (header, tile_entries, data_offset)."""
    if len(data) < MIC3_HEADER_SIZE:
        raise ValueError("MIC3: file too small")
    if data[:4] != MIC3_MAGIC:
        raise ValueError(f"MIC3: invalid magic {data[:4]!r}")
    version, width, height, tile_w, tile_h = struct.unpack_from("<IIIII", data, 4)
    if version != MIC3_VERSION:
        raise ValueError(f"MIC3: unsupported version {version}")
    channels, bps, flags = struct.unpack_from("<HBB", data, 24)
    level_count, _ = struct.unpack_from("<HH", data, 28)
    total_tiles = struct.unpack_from("<Q", data, 32)[0]
    hdr = WSIHeader(width, height, tile_w, tile_h, channels, bps, bool(flags & FLAG_COLOR_TRANSFORM))
    pos = MIC3_HEADER_SIZE
    if len(data) < pos + level_count * MIC3_LEVEL_SIZE:
        raise ValueError("MIC3: truncated level descriptors")
    for _ in range(level_count):
        w, h, tx, ty, fidx = struct.unpack_from("<IIIII", data, pos)
        hdr.levels.append(WSILevel(w, h, tx, ty, fidx))
        pos += MIC3_LEVEL_SIZE
    if len(data) < pos + total_tiles * MIC3_TILE_ENT_SIZE:
        raise ValueError("MIC3: truncated tile offset table")
    entries = [struct.unpack_from("<QQ", data, pos + i * MIC3_TILE_ENT_SIZE) for i in range(total_tiles)]
    data_offset = pos + total_tiles * MIC3_TILE_ENT_SIZE
    return hdr, entries, data_offset


def extract_tile_blob(data: bytes, entries, data_offset: int, tile_idx: int) -> bytes:
    if tile_idx < 0 or tile_idx >= len(entries):
        raise ValueError(f"MIC3: tile index {tile_idx} out of range [0, {len(entries)})")
    off, ln = entries[tile_idx]
    start = data_offset + int(off)
    end = start + int(ln)
    if end > len(data):
        raise ValueError(f"MIC3: tile {tile_idx} data extends beyond file")
    return data[start:end]


def _bytes_per_pixel(channels: int, bps: int) -> int:
    return channels * (2 if bps == 16 else 1)


def _bytes_to_u16(data: bytes | np.ndarray, bps: int) -> np.ndarray:
    b = np.asarray(bytearray(data) if isinstance(data, (bytes, bytearray)) else data, dtype=np.uint8)
    if bps <= 8:
        return b.astype(np.uint16)
    return b.view("<u2").astype(np.uint16) if b.flags["C_CONTIGUOUS"] else np.frombuffer(b.tobytes(), "<u2").astype(np.uint16)


def _u16_to_bytes(data: np.ndarray, bps: int) -> bytes:
    if bps <= 8:
        return np.asarray(data, dtype=np.uint16).astype(np.uint8).tobytes()
    return np.asarray(data, dtype="<u2").tobytes()


def _extract_tile(img: np.ndarray, img_w, img_h, tile_w, tile_h, tx, ty, bpp) -> np.ndarray:
    """Zero-padded tile extraction (extractTileRGB, wsicompress.go:529-555)."""
    tile = np.zeros(tile_w * tile_h * bpp, dtype=np.uint8)
    x0, y0 = tx * tile_w, ty * tile_h
    w = min(tile_w, img_w - x0)
    h = min(tile_h, img_h - y0)
    if w <= 0 or h <= 0:
        return tile
    src = img.reshape(img_h, img_w * bpp)
    dst = tile.reshape(tile_h, tile_w * bpp)
    dst[:h, : w * bpp] = src[y0 : y0 + h, x0 * bpp : (x0 + w) * bpp]
    return tile


def _compress_tile_blob(tile: np.ndarray, tile_w, tile_h, channels, bps, color_transform) -> bytes:
    if channels == 3 and bps == 8:
        return compress_rgb_tile_blob(tile, tile_w, tile_h, color_transform)
    plane = _bytes_to_u16(tile, bps)
    return compress_wsi_plane(plane, tile_w, tile_h)


def _decompress_tile_blob(blob: bytes, tile_w, tile_h, channels, bps, color_transform) -> bytes:
    if channels == 3 and bps == 8:
        return bytes(decompress_rgb_tile_blob(blob, tile_w, tile_h, color_transform))
    plane = decompress_wsi_plane(blob, tile_w, tile_h, tile_w * tile_h)
    return _u16_to_bytes(plane, bps)


def compress_wsi(pixels, width, height, channels, bits_per_sample, opts: WSIOptions | None = None) -> bytes:
    """Reference CompressWSI (wsicompress.go:27)."""
    opts = opts or WSIOptions()
    opts.defaults(channels)
    num_levels = opts.pyramid_levels
    if num_levels <= 0:
        num_levels = auto_level_count(width, height, opts.tile_width, opts.tile_height)
    levels = compute_levels(width, height, opts.tile_width, opts.tile_height, num_levels)

    pixels = np.asarray(bytearray(pixels) if isinstance(pixels, (bytes, bytearray)) else pixels, dtype=np.uint8)
    pyramid = [(pixels, width, height)]
    for i in range(1, num_levels):
        prev, pw, ph = pyramid[i - 1]
        if channels == 3:
            d, w, h = downsample2x_rgb(prev, pw, ph)
        else:
            u16 = _bytes_to_u16(prev, bits_per_sample)
            d, w, h = downsample2x_grey(u16, pw, ph)
            d = None if d is None else np.frombuffer(_u16_to_bytes(d, bits_per_sample), np.uint8)
        if d is None:
            num_levels = i
            levels = levels[:num_levels]
            break
        pyramid.append((np.asarray(d, np.uint8), w, h))
        levels[i].width, levels[i].height = w, h
        levels[i].tiles_x = (w + opts.tile_width - 1) // opts.tile_width
        levels[i].tiles_y = (h + opts.tile_height - 1) // opts.tile_height

    idx = 0
    for lv in levels:
        lv.first_tile_idx = idx
        idx += lv.tiles_x * lv.tiles_y
    total_tiles = idx

    bpp = _bytes_per_pixel(channels, bits_per_sample)
    jobs = []
    for lvl, lv in enumerate(levels):
        img, iw, ih = pyramid[lvl]
        for ty in range(lv.tiles_y):
            for tx in range(lv.tiles_x):
                g_idx = lv.first_tile_idx + ty * lv.tiles_x + tx
                tile = _extract_tile(img, iw, ih, opts.tile_width, opts.tile_height, tx, ty, bpp)
                jobs.append((g_idx, tile))

    tile_blobs: list[bytes | None] = [None] * total_tiles
    workers = opts.workers if opts.workers > 0 else (os.cpu_count() or 1)

    def one(job):
        g_idx, tile = job
        tile_blobs[g_idx] = _compress_tile_blob(
            tile, opts.tile_width, opts.tile_height, channels, bits_per_sample, opts.color_transform
        )

    if workers <= 1 or len(jobs) <= 1:
        for j in jobs:
            one(j)
    else:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(one, jobs))

    hdr = WSIHeader(
        width, height, opts.tile_width, opts.tile_height, channels, bits_per_sample,
        opts.color_transform, levels,
    )
    return write_mic3(hdr, tile_blobs)  # type: ignore[arg-type]


def decompress_wsi_tile(data: bytes, level: int, tile_x: int, tile_y: int) -> bytes:
    """Reference DecompressWSITile (wsicompress.go:175) — O(1) per tile,
    edge tiles cropped to the level's actual dimensions."""
    hdr, entries, data_offset = read_mic3_header(data)
    if level < 0 or level >= len(hdr.levels):
        raise ValueError(f"MIC3: level {level} out of range [0, {len(hdr.levels)})")
    lv = hdr.levels[level]
    if not (0 <= tile_x < lv.tiles_x and 0 <= tile_y < lv.tiles_y):
        raise ValueError(f"MIC3: tile ({tile_x},{tile_y}) out of range for level {level}")
    g_idx = lv.first_tile_idx + tile_y * lv.tiles_x + tile_x
    blob = extract_tile_blob(data, entries, data_offset, g_idx)
    tile = _decompress_tile_blob(
        blob, hdr.tile_width, hdr.tile_height, hdr.channels, hdr.bits_per_sample, hdr.color_transform
    )
    actual_w = min(hdr.tile_width, lv.width - tile_x * hdr.tile_width)
    actual_h = min(hdr.tile_height, lv.height - tile_y * hdr.tile_height)
    if actual_w == hdr.tile_width and actual_h == hdr.tile_height:
        return tile
    bpp = _bytes_per_pixel(hdr.channels, hdr.bits_per_sample)
    t = np.frombuffer(tile, np.uint8).reshape(hdr.tile_height, hdr.tile_width * bpp)
    return t[:actual_h, : actual_w * bpp].tobytes()


def decompress_wsi_region(data: bytes, level: int, x: int, y: int, w: int, h: int) -> bytes:
    """Reference DecompressWSIRegion (wsicompress.go:220)."""
    hdr, entries, data_offset = read_mic3_header(data)
    if level < 0 or level >= len(hdr.levels):
        raise ValueError(f"MIC3: level {level} out of range")
    lv = hdr.levels[level]
    w = min(w, lv.width - x)
    h = min(h, lv.height - y)
    if w <= 0 or h <= 0:
        raise ValueError("MIC3: empty region")
    bpp = _bytes_per_pixel(hdr.channels, hdr.bits_per_sample)
    result = np.zeros(h * w * bpp, dtype=np.uint8).reshape(h, w * bpp)

    for ty in range(y // hdr.tile_height, (y + h - 1) // hdr.tile_height + 1):
        for tx in range(x // hdr.tile_width, (x + w - 1) // hdr.tile_width + 1):
            g_idx = lv.first_tile_idx + ty * lv.tiles_x + tx
            blob = extract_tile_blob(data, entries, data_offset, g_idx)
            tile = _decompress_tile_blob(
                blob, hdr.tile_width, hdr.tile_height, hdr.channels, hdr.bits_per_sample,
                hdr.color_transform,
            )
            t = np.frombuffer(tile, np.uint8).reshape(hdr.tile_height, hdr.tile_width * bpp)
            tx0, ty0 = tx * hdr.tile_width, ty * hdr.tile_height
            tw = min(hdr.tile_width, lv.width - tx0)
            th = min(hdr.tile_height, lv.height - ty0)
            ox0, oy0 = max(x, tx0), max(y, ty0)
            ox1, oy1 = min(x + w, tx0 + tw), min(y + h, ty0 + th)
            if ox1 <= ox0 or oy1 <= oy0:
                continue
            result[oy0 - y : oy1 - y, (ox0 - x) * bpp : (ox1 - x) * bpp] = t[
                oy0 - ty0 : oy1 - ty0, (ox0 - tx0) * bpp : (ox1 - tx0) * bpp
            ]
    return result.tobytes()


def read_wsi_header(data: bytes) -> WSIHeader:
    """Reference ReadWSIHeader (wsicompress.go:299)."""
    hdr, _, _ = read_mic3_header(data)
    return hdr
