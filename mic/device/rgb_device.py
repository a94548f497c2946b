"""MICW-RGB (MWR3): the device-format RGB/WSI-tile container.

The host RGB container (models/rgb.py, reference rgbcompress.go) stores
YCoCg-R planes through the byte-oriented host formats.  MWR3 is its
device sibling: each plane (Y, zigzag Co, zigzag Cg — all u16, reference
ycocgr.go lifting) is a MICW blob, so whole batches of RGB images or WSI
tiles decode through the MICW device decode via micw_decode_many — the
device answer to wsicompress.go's tile worker pool.

Container::

    "MWR3" | width u32 | height u32 | per plane: length u32 | 3 blobs
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.color import ycocgr_forward, ycocgr_inverse
from .strips import micw_compress, micw_decode_many, micw_decompress_host

__all__ = [
    "micwr_compress",
    "micwr_compress_device",
    "micwr_compress_device_many",
    "micwr_decompress_device",
    "micwr_decode_many",
    "micwr_decompress_host",
]

MWR3_MAGIC = b"MWR3"


def _pad_plane(plane: np.ndarray, width: int, height: int):
    """Edge-pad a plane's columns to the next multiple of 128.

    An earlier decode kernel needed width % 128 == 0; the padding stays
    because it is part of the MWR3 encoder's output (frozen blobs in
    web/testdata).  Edge replication makes the padded columns' zzd/vdd
    deltas zero, so the ratio cost is ~0.2% (below the 756->768 pixel
    fraction of 1.6% on the NEMA VL geometry).
    The MWR3 header keeps the TRUE width; each plane blob's own MICW
    header carries the padded width, and every decode path crops —
    pre-padding blobs (padded == true width) crop as a no-op."""
    pw = -(-width // 128) * 128
    if pw == width:
        return plane, width
    p2 = np.asarray(plane, np.uint16).reshape(height, width)
    return np.pad(p2, ((0, 0), (0, pw - width)), mode="edge").ravel(), pw


def _crop_plane(plane, pw: int, width: int, height: int):
    """Undo _pad_plane on a decoded plane (no-op when pw == width)."""
    if pw == width:
        return plane
    return np.asarray(plane, np.uint16).reshape(height, pw)[:, :width].ravel()


def micwr_compress(rgb, width: int, height: int, num_strips: int = 0,
                   predictor: str = "auto", entropy: str = "standard") -> bytes:
    """Interleaved RGB bytes -> MWR3 (three MICW plane blobs).

    Defaults to the ratio-first "auto" trial set: RGB/ultrasound planes
    have large flat regions where the RLE'd modes win big (US1 6.84 vs
    6.19 direct-only), and the delivery tier's host decode handles every
    mode at full speed.  Pass "auto-fast" for device-throughput-first
    planes."""
    y, co, cg = ycocgr_forward(rgb, width, height)
    blobs = []
    for p in (y, co, cg):
        pp, pw = _pad_plane(p, width, height)
        blobs.append(
            micw_compress(pp, pw, height, int(pp.max()), num_strips=num_strips,
                          predictor=predictor, entropy=entropy))
    out = bytearray()
    out += MWR3_MAGIC
    out += struct.pack("<II", width, height)
    for b in blobs:
        out += struct.pack("<I", len(b))
    return bytes(out) + b"".join(blobs)


def micwr_compress_device_many(rgbs, entropy: str = "standard"):
    """Device-encode MANY RGB images/tiles into MWR3 containers with ONE
    device launch for every plane of every image (3 planes x N tiles
    pool into a single mict_encode_device_batch call — the WSI-ingest
    shape; zzd pipeline, like micw_compress_device).  ``rgbs`` is a list
    of (rgb_bytes, width, height); returns the containers in order."""
    from .device_encode import micw_compress_device_many

    images = []
    for rgb, width, height in rgbs:
        for p in ycocgr_forward(rgb, width, height):
            pp, pw = _pad_plane(p, width, height)
            images.append((pp, pw, height, int(pp.max())))
    plane_blobs = micw_compress_device_many(images, entropy=entropy)
    outs = []
    for i, (_rgb, width, height) in enumerate(rgbs):
        blobs = plane_blobs[3 * i : 3 * i + 3]
        out = bytearray()
        out += MWR3_MAGIC
        out += struct.pack("<II", width, height)
        for b in blobs:
            out += struct.pack("<I", len(b))
        outs.append(bytes(out) + b"".join(blobs))
    return outs


def micwr_compress_device(rgb, width: int, height: int,
                          entropy: str = "standard") -> bytes:
    """Single-image wrapper over micwr_compress_device_many."""
    return micwr_compress_device_many([(rgb, width, height)], entropy=entropy)[0]


def _parse(blob: bytes):
    if len(blob) < 24 or blob[:4] != MWR3_MAGIC:
        raise ValueError("not an MWR3 container")
    width, height = struct.unpack_from("<II", blob, 4)
    lens = struct.unpack_from("<III", blob, 12)
    off = 24
    planes = []
    for ln in lens:
        planes.append(blob[off : off + ln])
        off += ln
    return width, height, planes


def micwr_decompress_host(blob: bytes):
    width, height, planes = _parse(blob)
    y, co, cg = (_crop_plane(px, pw, width, height)
                 for px, pw, _ph in (micw_decompress_host(p) for p in planes))
    return ycocgr_inverse(y, co, cg, width, height), width, height


def micwr_decode_many(blobs):
    """Decode MANY RGB images / WSI tiles: all 3*N planes ride the batched
    device decode launches; the YCoCg-R inverse is a vectorized host
    pass.
    Returns [(rgb_bytes, width, height), ...] in blob order.
    """
    metas = [_parse(b) for b in blobs]
    flat = [p for _w, _h, planes in metas for p in planes]
    decoded = micw_decode_many(flat)
    out = []
    for i, (width, height, _planes) in enumerate(metas):
        y, co, cg = (_crop_plane(decoded[3 * i + j][0], decoded[3 * i + j][1],
                                 width, height) for j in range(3))
        out.append((ycocgr_inverse(y, co, cg, width, height), width, height))
    return out


def micwr_decompress_device(blob: bytes):
    return micwr_decode_many([blob])[0]
