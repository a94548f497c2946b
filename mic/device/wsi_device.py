"""W3D1 — the device-format whole-slide-image container (MIC3 sibling).

MIC3 (parallel/wsi.py, reference wsicompress.go) tiles a slide, builds a
2x-downsampled pyramid, collapses constant background tiles, and decodes
tiles on a worker pool.  W3D1 keeps that structure but stores every RGB
tile as an MWR3 blob (MICW planes), so any set of tiles — a pyramid
level, a region, a prefetch batch — decodes through the MICW device
decode via micwr_decode_many / micw_decode_many.  The worker pool
becomes a batch axis.

Container::

    "W3D1" | width u32 | height u32 | tileW u32 | tileH u32 | levels u32
    nTiles u32
    per tile: level u32 | tx u32 | ty u32 | mode u32 (0 MWR3, 1 constant)
              off u32 | len u32
    concatenated payloads (constant tiles: 3 bytes RGB)
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.pyramid import downsample2x_rgb
from .rgb_device import micwr_compress, micwr_decode_many

__all__ = [
    "w3d_compress",
    "w3d_decompress_level",
    "w3d_decompress_region",
    "w3d_header",
]

W3D_MAGIC = b"W3D1"
HDR = 28
ENTRY = 24
TILE_MWR3 = 0
TILE_CONST = 1


def _levels(width, height, tile_w, tile_h, num_levels):
    """Level geometry: halve until a level fits one tile (host
    auto_level_count behavior) unless num_levels pins it."""
    levels = [(width, height)]
    while True:
        w, h = levels[-1]
        if num_levels > 0 and len(levels) >= num_levels:
            break
        if num_levels <= 0 and (w <= tile_w and h <= tile_h):
            break
        if w <= 1 and h <= 1:
            break
        levels.append((max(1, w // 2), max(1, h // 2)))
    return levels


def w3d_compress(rgb, width: int, height: int, tile_w: int = 256, tile_h: int = 256, num_levels: int = 0, device_encode: bool = False) -> bytes:
    """Interleaved RGB bytes -> W3D1.  Tiles at slide edges are padded to
    (tile_w, tile_h) by edge replication before compression (the decoder
    crops), keeping every MWR3 blob the same geometry so whole levels
    batch in shared kernel launches.

    ``device_encode=True`` pools every plane of every non-constant tile
    across ALL pyramid levels into one device encode launch
    (micwr_compress_device_many, zzd pipeline) — the WSI-ingest shape."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    if rgb.size != width * height * 3:
        raise ValueError("w3d: pixel count mismatch")
    pyramid = [(rgb, width, height)]
    for w, h in _levels(width, height, tile_w, tile_h, num_levels)[1:]:
        prev, pw, ph = pyramid[-1]
        d, dw, dh = downsample2x_rgb(prev, pw, ph)
        assert (dw, dh) == (w, h)
        pyramid.append((np.asarray(d, np.uint8), w, h))

    tiles = []  # (lvl, tx, ty, mode, flat-or-const-bytes)
    for lvl, (img, iw, ih) in enumerate(pyramid):
        plane = img.reshape(ih, iw, 3)
        for ty in range((ih + tile_h - 1) // tile_h):
            for tx in range((iw + tile_w - 1) // tile_w):
                y0, x0 = ty * tile_h, tx * tile_w
                tile = plane[y0 : y0 + tile_h, x0 : x0 + tile_w]
                if tile.shape[:2] != (tile_h, tile_w):
                    tile = np.pad(
                        tile,
                        ((0, tile_h - tile.shape[0]), (0, tile_w - tile.shape[1]), (0, 0)),
                        mode="edge",
                    )
                if (tile == tile[0, 0]).all():
                    tiles.append((lvl, tx, ty, TILE_CONST, bytes(tile[0, 0].tobytes())))
                else:
                    tiles.append((lvl, tx, ty, TILE_MWR3, tile.reshape(-1)))

    if device_encode:
        from .rgb_device import micwr_compress_device_many

        mwr = iter(micwr_compress_device_many(
            [(t[4], tile_w, tile_h) for t in tiles if t[3] == TILE_MWR3]))
    entries = []
    payloads = []
    offset = 0
    for lvl, tx, ty, mode, data in tiles:
        if mode == TILE_CONST:
            blob = data
        elif device_encode:
            blob = next(mwr)
        else:
            blob = micwr_compress(data, tile_w, tile_h)
        entries.append((lvl, tx, ty, mode, offset, len(blob)))
        payloads.append(blob)
        offset += len(blob)

    out = bytearray()
    out += W3D_MAGIC
    out += struct.pack("<IIIIII", width, height, tile_w, tile_h, len(pyramid), len(entries))
    for e in entries:
        out += struct.pack("<IIIIII", *e)
    return bytes(out) + b"".join(payloads)


def w3d_header(blob: bytes):
    if len(blob) < HDR or blob[:4] != W3D_MAGIC:
        raise ValueError("not a W3D1 container")
    width, height, tile_w, tile_h, levels, n = struct.unpack_from("<IIIIII", blob, 4)
    entries = []
    for i in range(n):
        entries.append(struct.unpack_from("<IIIIII", blob, HDR + i * ENTRY))
    data_off = HDR + n * ENTRY
    return (width, height, tile_w, tile_h, levels), entries, data_off


def _decode_tiles(blob, wanted, tile_w, tile_h, data_off):
    """Decode a set of tile entries; MWR3 tiles batch in shared launches."""
    mwr_blobs = []
    mwr_pos = []
    out = {}
    for e in wanted:
        lvl, tx, ty, mode, off, ln = e
        payload = blob[data_off + off : data_off + off + ln]
        if mode == TILE_CONST:
            out[(lvl, tx, ty)] = np.tile(
                np.frombuffer(payload, np.uint8, 3), tile_w * tile_h
            )
        else:
            mwr_pos.append((lvl, tx, ty))
            mwr_blobs.append(payload)
    if mwr_blobs:
        for key, (rgb, _w, _h) in zip(mwr_pos, micwr_decode_many(mwr_blobs)):
            out[key] = np.asarray(rgb, np.uint8).reshape(-1)
    return out


def w3d_decompress_level(blob: bytes, level: int = 0):
    """Decode one pyramid level.  Returns (rgb bytes, width, height)."""
    (width, height, tile_w, tile_h, levels), entries, data_off = w3d_header(blob)
    lw, lh = width, height
    for _ in range(level):
        lw, lh = max(1, lw // 2), max(1, lh // 2)
    wanted = [e for e in entries if e[0] == level]
    tiles = _decode_tiles(blob, wanted, tile_w, tile_h, data_off)
    img = np.zeros((lh, lw, 3), np.uint8)
    for (lvl, tx, ty), flat in tiles.items():
        t = flat.reshape(tile_h, tile_w, 3)
        y0, x0 = ty * tile_h, tx * tile_w
        sh, sw = min(tile_h, lh - y0), min(tile_w, lw - x0)
        img[y0 : y0 + sh, x0 : x0 + sw] = t[:sh, :sw]
    return img.reshape(-1), lw, lh


def w3d_decompress_region(blob: bytes, x: int, y: int, rw: int, rh: int, level: int = 0):
    """Decode only the tiles intersecting a region (reference MIC3 region
    decode, wsi.go DecodeRegion).  Returns (rgb bytes, rw, rh)."""
    (width, height, tile_w, tile_h, levels), entries, data_off = w3d_header(blob)
    lw, lh = width, height
    for _ in range(level):
        lw, lh = max(1, lw // 2), max(1, lh // 2)
    x = max(0, min(x, lw))
    y = max(0, min(y, lh))
    rw = min(rw, lw - x)
    rh = min(rh, lh - y)
    tx0, tx1 = x // tile_w, (x + rw - 1) // tile_w
    ty0, ty1 = y // tile_h, (y + rh - 1) // tile_h
    wanted = [
        e for e in entries
        if e[0] == level and tx0 <= e[1] <= tx1 and ty0 <= e[2] <= ty1
    ]
    tiles = _decode_tiles(blob, wanted, tile_w, tile_h, data_off)
    img = np.zeros((rh, rw, 3), np.uint8)
    for (lvl, tx, ty), flat in tiles.items():
        t = flat.reshape(tile_h, tile_w, 3)
        gy0, gx0 = ty * tile_h, tx * tile_w
        iy0, ix0 = max(gy0, y), max(gx0, x)
        iy1 = min(gy0 + tile_h, y + rh)
        ix1 = min(gx0 + tile_w, x + rw)
        if iy1 <= iy0 or ix1 <= ix0:
            continue
        img[iy0 - y : iy1 - y, ix0 - x : ix1 - x] = t[iy0 - gy0 : iy1 - gy0, ix0 - gx0 : ix1 - gx0]
    return img.reshape(-1), rw, rh
