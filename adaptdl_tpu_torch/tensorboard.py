"""TensorBoard export of the adaptation metrics — native writer.

The port's copy of ``adaptdl_tpu.tensorboard`` (standard library and
numpy only; it reads the replica rank and the share path from the
port's ``env``). Its records are byte for byte the JAX package's at the
same wall time.

The reference dumps gain, gradient sqr/var, lr factor, batch sizes,
and progress to TensorBoard from inside AdaptiveDataParallel
(reference: adaptdl/adaptdl/torch/parallel.py:176-202,
data.py:381-398). Here it is an explicit writer fed from the train
step's metrics dict — and it depends on NOTHING: scalar summaries are
encoded directly in the TensorBoard on-disk format (protobuf wire
encoding of ``Event``/``Summary`` messages inside TFRecord framing
with masked CRC32C), so the same code works on images without
TensorFlow installed and the output opens in any stock TensorBoard.

Format notes (stable, documented wire contracts):

- TFRecord record = ``len(8B LE) | masked_crc32c(len) (4B) |
  payload | masked_crc32c(payload) (4B)``; mask(c) =
  ``((c >> 15 | c << 17) + 0xa282ead8) mod 2^32``; CRC32C is the
  Castagnoli polynomial (reflected 0x82F63B78).
- Event proto fields used: 1 wall_time (double), 2 step (int64),
  3 file_version (string, first record only), 5 summary (message).
  Summary: repeated field 1 value; Value: 1 tag (string),
  2 simple_value (float).
"""

from __future__ import annotations

import os
import socket
import struct
import time

from adaptdl_tpu_torch import env

# ---- CRC32C (Castagnoli), table-driven ------------------------------

_CRC_TABLE = []
for _i in range(256):
    _crc = _i
    for _ in range(8):
        _crc = (_crc >> 1) ^ (0x82F63B78 if _crc & 1 else 0)
    _CRC_TABLE.append(_crc)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal protobuf wire encoding ---------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_bytes(number: int, payload: bytes) -> bytes:
    return _varint((number << 3) | 2) + _varint(len(payload)) + payload


def _field_double(number: int, value: float) -> bytes:
    return _varint((number << 3) | 1) + struct.pack("<d", value)


def _field_float(number: int, value: float) -> bytes:
    return _varint((number << 3) | 5) + struct.pack("<f", value)


def _field_varint(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def _scalar_event(step: int, scalars: dict[str, float]) -> bytes:
    values = b"".join(
        _field_bytes(
            1,
            _field_bytes(1, tag.encode())
            + _field_float(2, float(value)),
        )
        for tag, value in scalars.items()
    )
    return (
        _field_double(1, time.time())
        + _field_varint(2, int(step))
        + _field_bytes(5, values)
    )


def _encode_png(image) -> bytes:
    """Minimal stdlib PNG encoder (8-bit RGB/grayscale, zlib-deflated
    scanlines) — enough for TensorBoard image summaries without a
    Pillow dependency (this image has no network egress; the reference
    leans on torch/PIL for the same job)."""
    import zlib

    import numpy as _np

    arr = _np.asarray(image)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    assert c in (1, 3), f"PNG encoder supports 1 or 3 channels, got {c}"
    arr = _np.clip(arr, 0, 255).astype(_np.uint8)
    color_type = 0 if c == 1 else 2
    raw = b"".join(
        b"\x00" + arr[row].tobytes() for row in range(h)
    )

    def chunk(tag: bytes, payload: bytes) -> bytes:
        body = tag + payload
        return (
            struct.pack(">I", len(payload))
            + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def _image_event(step: int, tag: str, image) -> bytes:
    """Summary.Value.image (field 4): Summary.Image {height=1,
    width=2, colorspace=3, encoded_image_string=4} with a PNG
    payload — the wire format TensorBoard's image dashboard reads."""
    import numpy as _np

    arr = _np.asarray(image)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    image_proto = (
        _field_varint(1, h)
        + _field_varint(2, w)
        + _field_varint(3, 1 if c == 1 else 3)
        + _field_bytes(4, _encode_png(arr))
    )
    value = _field_bytes(1, tag.encode()) + _field_bytes(
        4, image_proto
    )
    return (
        _field_double(1, time.time())
        + _field_varint(2, int(step))
        + _field_bytes(5, _field_bytes(1, value))
    )


def _version_event() -> bytes:
    return _field_double(1, time.time()) + _field_bytes(
        3, b"brain.Event:2"
    )


class EventFileWriter:
    """Appends TensorBoard event records to one tfevents file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}"
        )
        self._path = os.path.join(logdir, name)
        self._file = open(self._path, "ab")
        self._write_record(_version_event())

    @property
    def path(self) -> str:
        return self._path

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalars(self, step: int, scalars: dict[str, float]) -> None:
        if scalars:
            self._write_record(_scalar_event(step, scalars))

    def add_image(self, step: int, tag: str, image) -> None:
        """``image``: [h, w] or [h, w, {1,3}] array, values in [0, 255]
        (float inputs in [0, 1] or [-1, 1] should be rescaled by the
        caller). Lands in TensorBoard's Images dashboard — the DCGAN
        example's sample grids (reference family: examples/dcgan)."""
        self._write_record(_image_event(step, tag, image))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def read_events(path: str) -> list[tuple[int, dict[str, float]]]:
    """Parse a tfevents file back into (step, {tag: value}) rows —
    used by tests and by ``adaptdl-tpu`` tooling to sanity-check
    writer output; verifies every complete record's CRCs. A truncated
    TAIL record (a writer killed mid-write — this framework's normal
    preemption mode) ends parsing cleanly, like stock TensorBoard;
    corruption inside a complete record still raises."""
    rows = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            break  # truncated tail: header incomplete
        header = data[pos : pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8 : pos + 12])
        if hcrc != _masked_crc(header):
            raise ValueError("corrupt record header")
        if pos + 16 + length > len(data):
            break  # truncated tail: payload/CRC incomplete
        payload = data[pos + 12 : pos + 12 + length]
        (pcrc,) = struct.unpack(
            "<I", data[pos + 12 + length : pos + 16 + length]
        )
        if pcrc != _masked_crc(payload):
            raise ValueError("corrupt record payload")
        pos += 16 + length
        step, scalars = _parse_event(payload)
        if scalars:
            rows.append((step, scalars))
    return rows


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _parse_event(buf: bytes) -> tuple[int, dict[str, float]]:
    step = 0
    scalars: dict[str, float] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
            if number == 2:
                step = value
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            chunk = buf[pos : pos + length]
            pos += length
            if number == 5:  # summary
                scalars.update(_parse_summary(chunk))
        else:  # pragma: no cover - unknown wire type
            raise ValueError(f"unsupported wire type {wire}")
    return step, scalars


def _parse_summary(buf: bytes) -> dict[str, float]:
    scalars: dict[str, float] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if number == 1 and wire == 2:
            length, pos = _read_varint(buf, pos)
            value_buf = buf[pos : pos + length]
            pos += length
            tag, simple = None, None
            vpos = 0
            while vpos < len(value_buf):
                vkey, vpos = _read_varint(value_buf, vpos)
                vnum, vwire = vkey >> 3, vkey & 7
                if vnum == 1 and vwire == 2:
                    vlen, vpos = _read_varint(value_buf, vpos)
                    tag = value_buf[vpos : vpos + vlen].decode()
                    vpos += vlen
                elif vwire == 5:
                    if vnum == 2:
                        (simple,) = struct.unpack(
                            "<f", value_buf[vpos : vpos + 4]
                        )
                    vpos += 4
                elif vwire == 0:
                    _, vpos = _read_varint(value_buf, vpos)
                elif vwire == 1:
                    vpos += 8
                else:
                    vlen, vpos = _read_varint(value_buf, vpos)
                    vpos += vlen
            if tag is not None and simple is not None:
                scalars[tag] = simple
        else:  # skip unknown summary fields
            if wire == 2:
                length, pos = _read_varint(buf, pos)
                pos += length
            elif wire == 0:
                _, pos = _read_varint(buf, pos)
            elif wire == 1:
                pos += 8
            elif wire == 5:
                pos += 4
    return scalars


class MetricsWriter:
    """Writes per-step adaptation metrics for one replica group under
    the same tags the reference exports."""

    TAGS = (
        "loss",
        "gain",
        "lr_factor",
        "grad_sqr",
        "grad_var",
        "progress",
        "scale",
    )

    def __init__(self, logdir: str | None = None):
        logdir = logdir or env.share_path()
        self._writer = None
        if logdir is None:
            return
        path = os.path.join(
            logdir, f"replica-{env.replica_rank()}", "adaptdl"
        )
        self._writer = EventFileWriter(path)

    @property
    def path(self) -> str | None:
        return self._writer.path if self._writer else None

    def write(self, step: int, metrics: dict, dataloader=None) -> None:
        """Log a train step's metrics (and the loader's batch
        geometry)."""
        if self._writer is None:
            return
        scalars = {
            f"adaptdl/{key}": float(metrics[key])
            for key in self.TAGS
            if key in metrics
        }
        if dataloader is not None:
            scalars["adaptdl/batch_size"] = float(
                dataloader.current_batch_size
            )
            scalars["adaptdl/atomic_bsz"] = float(
                dataloader.current_atomic_bsz
            )
            scalars["adaptdl/accum_steps"] = float(
                dataloader.current_accum_steps
            )
        self._writer.add_scalars(int(step), scalars)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
