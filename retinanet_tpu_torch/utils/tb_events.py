"""Minimal TensorBoard event-file writer — no TensorFlow dependency (a copy
of ``retinanet_tpu/utils/tb_events.py``, held equal to it by
``tests/test_torch_trainer.py``).

The reference's observability surface is TensorBoard scalars, histograms and
images written by TF's C++ event writer (the reference ``train.py:123,
164-187``, ``losses.py:160-163``).  This module reproduces the *file format*
from scratch so ``tensorboard --logdir`` renders runs from this framework:

  * protobuf messages (``Event`` → ``Summary`` → ``Value`` with
    ``simple_value`` / ``HistogramProto`` / ``Image``) hand-encoded with
    varint/tag framing — the message subset TensorBoard's event loader
    reads is tiny and stable
  * TFRecord container framing: little-endian uint64 length + masked
    CRC-32C (Castagnoli) of the length and of the payload

Wire format references: tensorflow/core/util/event.proto,
tensorflow/core/framework/summary.proto, tensorflow/core/lib/io/
record_writer.cc (all public Apache-2.0 format specs).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional, Sequence

# --------------------------------------------------------------------------
# CRC-32C (Castagnoli), table-driven, + TFRecord masking.
# --------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# Protobuf wire-format helpers (wire types: 0 varint, 1 fixed64, 2 bytes,
# 5 fixed32).
# --------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_varint(field: int, n: int) -> bytes:
    return _tag(field, 0) + _varint(n)


def _field_double(field: int, x: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", x)


def _field_float(field: int, x: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", x)


def _field_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _field_packed_doubles(field: int, xs: Sequence[float]) -> bytes:
    payload = b"".join(struct.pack("<d", float(x)) for x in xs)
    return _field_bytes(field, payload)


# --------------------------------------------------------------------------
# Message builders (field numbers from the public .proto files).
# --------------------------------------------------------------------------

def _summary_value_scalar(tag: str, value: float) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float)
    return _field_bytes(1, tag.encode()) + _field_float(2, float(value))


def _histogram_proto(counts: Sequence[float],
                     bucket_limits: Sequence[float],
                     vmin: float, vmax: float, total: float,
                     vsum: float, sum_sq: float) -> bytes:
    # HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5
    # bucket_limit=6 (packed double) bucket=7 (packed double)
    return (_field_double(1, vmin) + _field_double(2, vmax)
            + _field_double(3, total) + _field_double(4, vsum)
            + _field_double(5, sum_sq)
            + _field_packed_doubles(6, bucket_limits)
            + _field_packed_doubles(7, counts))


def _summary_value_histogram(tag: str, histo: bytes) -> bytes:
    # Summary.Value: tag=1, histo=5 (HistogramProto)
    return _field_bytes(1, tag.encode()) + _field_bytes(5, histo)


def _summary_value_image(tag: str, png: bytes, height: int,
                         width: int, colorspace: int = 3) -> bytes:
    # Summary.Image: height=1 width=2 colorspace=3 encoded_image_string=4
    img = (_field_varint(1, height) + _field_varint(2, width)
           + _field_varint(3, colorspace) + _field_bytes(4, png))
    # Summary.Value: tag=1, image=4
    return _field_bytes(1, tag.encode()) + _field_bytes(4, img)


def _event(step: int, summary_values: Sequence[bytes] = (),
           file_version: Optional[str] = None,
           wall_time: Optional[float] = None) -> bytes:
    # Event: wall_time=1 (double), step=2 (int64), file_version=3 (string),
    # summary=5 (Summary); Summary: value=1 (repeated Value)
    out = _field_double(1, wall_time if wall_time is not None else time.time())
    out += _field_varint(2, int(step))
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary_values:
        summary = b"".join(_field_bytes(1, v) for v in summary_values)
        out += _field_bytes(5, summary)
    return out


class TBEventWriter:
    """Append TensorBoard events to ``<logdir>/events.out.tfevents.*``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "localhost"
        self._path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}")
        self._file = open(self._path, "ab")
        self._write_record(_event(0, file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_event(step, [_summary_value_scalar(tag, value)]))

    def add_scalars(self, scalars: dict, step: int) -> None:
        """One event holding many scalar values (atomic per step)."""
        values = [_summary_value_scalar(t, v) for t, v in scalars.items()]
        if values:
            self._write_record(_event(step, values))

    def add_histogram_counts(self, tag: str, counts: Sequence[float],
                             bucket_limits: Sequence[float],
                             step: int) -> None:
        """Pre-binned histogram (device-side fixed bins).  ``bucket_limits``
        are the *upper* edges, one per count; moment fields are approximated
        from bin midpoints (TensorBoard only renders the buckets)."""
        import numpy as np
        counts = np.asarray(counts, np.float64)
        limits = np.asarray(bucket_limits, np.float64)
        lowers = np.concatenate([[limits[0] - (limits[1] - limits[0])
                                  if len(limits) > 1 else 0.0], limits[:-1]])
        mids = (lowers + limits) / 2.0
        total = float(counts.sum())
        vsum = float((counts * mids).sum())
        sum_sq = float((counts * mids ** 2).sum())
        histo = _histogram_proto(
            counts.tolist(), limits.tolist(),
            float(lowers[0]), float(limits[-1]), total, vsum, sum_sq)
        self._write_record(_event(step, [_summary_value_histogram(tag,
                                                                  histo)]))

    def add_image_png(self, tag: str, png_bytes: bytes, height: int,
                      width: int, step: int) -> None:
        self._write_record(_event(
            step, [_summary_value_image(tag, png_bytes, height, width)]))

    def close(self) -> None:
        self._file.close()

    @property
    def path(self) -> str:
        return self._path
