"""Multi-device decode and encode: strip/stream batches sharded over a mesh.

The reference's parallelism axes — PICS strips, MIC3 tiles, MIC2 frames
(parallelstrips.go goroutines, wsicompress.go worker pool, mic_parallel.c
pthreads) — are embarrassingly parallel, so on a device mesh they become
a single sharded batch axis: shard_map partitions the strip axis and each
device runs the decode program on its local strips.  No collectives are
needed; compressed blobs scatter host-side (the offset tables in the
containers are exactly the metadata the device→host path needs,
SURVEY.md §5).

Encode-side sharding works the same way (each device compresses its
strips); the ragged compressed outputs gather host-side.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .device_encode import rans_encode_scan
from .strips import decode_strips_impl
from .tans_device import tans_decode_scan

__all__ = [
    "make_strip_mesh",
    "decode_strips_sharded",
    "decode_tans_sharded",
    "encode_strips_sharded",
]


def make_strip_mesh(devices=None, axis: str = "strips") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def _sharded(mesh: Mesh, body, specs, out_specs, *arrays):
    fn = jax.shard_map(body, mesh=mesh, in_specs=specs, out_specs=out_specs,
                       check_vma=False)
    return jax.jit(fn)(*arrays)


def decode_strips_sharded(mesh: Mesh, *arrays, **static):
    """Decode one homogeneous strip group with the strip axis sharded over
    ``mesh``.

    ``arrays`` are the 10 operands of strips.decode_strips_impl (from
    strips.strip_group_operands; the strip count must divide by the mesh
    size); ``static`` its keyword parameters.  The flat word stream and
    slot tables are replicated, every per-strip operand is sharded.
    Returns uint16[S, width*strip_h] with the same sharding.
    """
    s = P(mesh.axis_names[0])
    r = P()
    specs = (s, s, r, r, r, s, s, s, s, s)
    return _sharded(mesh, partial(decode_strips_impl, **static), specs, s, *arrays)


def decode_tans_sharded(mesh: Mesh, *arrays, steps: int, n_states: int):
    """Reference-format ANS decode (tans_device.tans_decode_scan) with the
    STREAM axis sharded over ``mesh`` — each device decodes its shard of
    the blob batch (strips of a PICS archive, frames of a MIC2 file).
    ``arrays`` are the 7 operands from tans_device.build_tans_batch; the
    stream count must divide by the mesh size."""
    s = P(mesh.axis_names[0])
    body = partial(tans_decode_scan, steps=steps, n_states=n_states)
    return _sharded(mesh, body, (s,) * 7, s, *arrays)


def encode_strips_sharded(mesh: Mesh, *arrays, lanes: int):
    """Device ENCODE (device_encode.rans_encode_scan) with the strip axis
    sharded over ``mesh``: each device encodes its local strips; the
    ragged compressed outputs gather host-side from the per-shard word
    planes.  ``arrays`` are its 6 operands; the strip count must divide
    by the mesh size."""
    s = P(mesh.axis_names[0])
    body = partial(rans_encode_scan, lanes=lanes)
    return _sharded(mesh, body, (s,) * 6, (s, s, s), *arrays)
