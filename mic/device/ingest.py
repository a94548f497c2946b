"""Reference-format ingest: host blobs (MIC1/PICS) → device-format pixels.

The byte-compatible reference formats are bit-serial tANS (fse4state.go,
parallelstrips.go): every symbol's bit count depends on the previous
symbol's decoded state within ONE reversed bitstream, so each stream
carries only 2-8 independent states — far below the wide-lane format's
parallelism.  The device serving design is **transcode-on-ingest**:

1. the reference blob decodes to pixels — native C++ tier (branchless
   hot loop, threaded across strips) or, with ``entropy="device"``, the
   device ANS decode (tans_device) batched across strips, so a whole
   PICS container or archive batch entropy-decodes in a few launches,
2. the pixels are re-packed as MICW (host vectorized encoder, or the
   device encoder, byte for byte the same),
3. every subsequent decode rides the MICW device decode
   (strips.MicwDecodePlan) — the shape of a PACS/archive migration
   or a model-training data path, where each image is ingested once and
   decoded many times.

This is the device answer for the reference's own formats (SURVEY §2.5
inventory): a MIC1/PICS blob decodes bit-exact through a device-involved
path.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .strips import MicwDecodePlan, micw_compress

__all__ = [
    "transcode_frame",
    "transcode_pics",
    "transcode_auto",
    "ingest_plan",
]


def _decode_reference(blob: bytes, width: int, height: int, kind: int,
                      entropy: str = "native"):
    """Decode a reference-format blob to pixels.

    ``entropy="native"`` uses the C++ tier (falling back to the Python
    tier when libmicfse isn't built).  ``entropy="device"`` runs the
    entropy stage on the device (tans_device, batched across strips)
    for the avg/grad pipelines (kind 0/1).
    """
    if entropy == "device" and kind in (0, 1):
        from .ref_decode import decompress_frames_device, decompress_pics_device

        kname = "avg" if kind == 0 else "grad"
        if blob[:4] == b"PICS":
            return decompress_pics_device(blob, kind=kname)
        (px,) = decompress_frames_device([blob], [(width, height)], kind=kname)
        return px, width, height
    if native.available():
        if blob[:4] == b"PICS":
            px, w, h = native.decompress_strips_native(blob)
            return px, w, h
        return (
            native.decompress_frame_native(blob, width, height, kind),
            width,
            height,
        )
    from ..models.single_frame import decompress_single_frame
    from ..parallel.strips import decompress_parallel_strips

    if blob[:4] == b"PICS":
        px, w, h = decompress_parallel_strips(blob)
        return np.asarray(px), w, h
    return np.asarray(decompress_single_frame(blob, width, height)), width, height


def transcode_frame(
    blob: bytes, width: int, height: int, kind: int = 0,
    device_encode: bool = False, entropy: str = "native",
    target_entropy: str = "standard",
) -> bytes:
    """Reference single-frame blob (Delta+RLE+FSE/rANS, any state count)
    → MICW.  ``kind`` is the predictor the frame was encoded with
    (0=avg, 1=grad, 2=med, 3=zz — native.PRED_*); ``entropy`` selects
    the decode tier for the reference blob ("native" or "device");
    ``target_entropy`` the MICW strip stream family ("standard" FF 57 or
    "alias" FF 41 — host encode only)."""
    px, w, h = _decode_reference(blob, width, height, kind, entropy=entropy)
    px = np.asarray(px, dtype=np.uint16)
    mx = int(px.max())
    if device_encode:
        from .device_encode import micw_compress_device

        return micw_compress_device(px, w, h, mx)
    return micw_compress(px, w, h, mx, entropy=target_entropy)


def transcode_pics(blob: bytes, device_encode: bool = False,
                   entropy: str = "native",
                   target_entropy: str = "standard") -> bytes:
    """Reference PICS container → MICW (threaded native strip decode, or
    device-batched entropy with entropy="device")."""
    if blob[:4] != b"PICS":
        raise ValueError("not a PICS container")
    return transcode_frame(blob, 0, 0, 0, device_encode=device_encode,
                           entropy=entropy, target_entropy=target_entropy)


def transcode_auto(
    blob: bytes, width: int = 0, height: int = 0, kind: int = 0,
    device_encode: bool = False, entropy: str = "native",
    target_entropy: str = "standard",
) -> bytes:
    """Magic-sniffing transcode: PICS containers self-describe; bare
    frame blobs need (width, height)."""
    if blob[:4] == b"PICS":
        return transcode_pics(blob, device_encode=device_encode,
                              entropy=entropy, target_entropy=target_entropy)
    return transcode_frame(blob, width, height, kind,
                           device_encode=device_encode, entropy=entropy,
                           target_entropy=target_entropy)


def ingest_plan(ref_blobs, dims=None, kind: int = 0,
                device_encode: bool = False, entropy: str = "native",
                target_entropy: str = "standard", timings: dict | None = None):
    """Transcode a batch of reference blobs and stage them for repeated
    device decode.  ``dims`` supplies (width, height) per bare frame blob
    (ignored for PICS).  Returns a :class:`MicwDecodePlan`.

    ``timings``, when a dict, receives the per-leg wall-clock split
    (``decode_s`` native/device reference decode, ``encode_s`` MICW
    re-encode, ``stage_s`` decode-plan staging) so the ingest benchmark
    can report where the pipeline's time goes (the reference bar is its
    PICS-C pthread decode, mic_parallel.c / README.md:323)."""
    import time as _time

    t0 = _time.time()
    if device_encode:
        # Archive shape: decode all blobs, then ONE device-encode launch
        # for every strip of every image.
        from .device_encode import micw_compress_device_many

        images = []
        for i, blob in enumerate(ref_blobs):
            w, h = (0, 0) if blob[:4] == b"PICS" else dims[i]
            px, w, h = _decode_reference(blob, w, h, kind, entropy=entropy)
            px = np.asarray(px, dtype=np.uint16)
            images.append((px, w, h, int(px.max())))
        t1 = _time.time()
        micw_blobs = micw_compress_device_many(images)
        t2 = _time.time()
        plan = MicwDecodePlan(micw_blobs)
        if timings is not None:
            timings.update(decode_s=t1 - t0, encode_s=t2 - t1,
                           stage_s=_time.time() - t2)
        return plan
    micw_blobs = []
    for i, blob in enumerate(ref_blobs):
        if blob[:4] == b"PICS":
            micw_blobs.append(transcode_pics(blob, device_encode=device_encode,
                                             entropy=entropy,
                                             target_entropy=target_entropy))
        else:
            w, h = dims[i]
            micw_blobs.append(
                transcode_frame(blob, w, h, kind, device_encode=device_encode,
                                entropy=entropy, target_entropy=target_entropy)
            )
    t1 = _time.time()
    plan = MicwDecodePlan(micw_blobs)
    if timings is not None:
        # Host transcode interleaves the decode/encode legs per blob; the
        # combined figure lands in decode_s with encode_s zeroed so
        # downstream reporting stays shape-stable.
        timings.update(decode_s=t1 - t0, encode_s=0.0,
                       stage_s=_time.time() - t1)
    return plan
