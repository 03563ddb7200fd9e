"""Partition log store: Python facade over the native C++ segmented log.

The port's own copy of ``langstream_tpu/topics/log/store.py``. One
partition log = one topic partition on disk. The native library
(``langstream_tpu_torch/native/logstore.cpp``) owns the file format
(framed + crc32-checked segments with an O(1) offset index) and is the
only store the broker opens: a failed build raises, nothing falls back.
:class:`_PyPartitionLog` writes the *same on-disk format* in pure Python;
it is the plain reference the tests hold the native store against, and
nothing on the served path uses it.
"""

from __future__ import annotations

import ctypes
import pathlib
import struct
import threading
import zlib
from typing import List, Tuple

from langstream_tpu_torch import native

_FRAME = struct.Struct("<II")  # len, crc32
_IDX = struct.Struct("<Q")  # file position

DEFAULT_SEGMENT_BYTES = 64 << 20


class _NativePartitionLog:
    def __init__(self, lib: ctypes.CDLL, directory: str, segment_bytes: int):
        self._lib = lib
        self._handle = lib.ls_open(directory.encode(), segment_bytes)
        if not self._handle:
            raise OSError(f"cannot open log store at {directory}")
        self._read_buf = ctypes.create_string_buffer(1 << 20)

    def append(self, payload: bytes) -> int:
        offset = self._lib.ls_append(self._handle, payload, len(payload))
        if offset < 0:
            raise OSError("log append failed")
        return offset

    def end_offset(self) -> int:
        return self._lib.ls_end_offset(self._handle)

    def read_batch(self, start: int, max_records: int) -> List[Tuple[int, bytes]]:
        while True:
            used = ctypes.c_uint64(0)
            n = self._lib.ls_read_batch(
                self._handle,
                start,
                max_records,
                self._read_buf,
                len(self._read_buf),
                ctypes.byref(used),
            )
            if n == -2:  # first record larger than the buffer: grow and retry
                self._read_buf = ctypes.create_string_buffer(
                    len(self._read_buf) * 4
                )
                continue
            break
        out: List[Tuple[int, bytes]] = []
        data = self._read_buf.raw[: used.value]
        pos = 0
        for i in range(n):
            (length,) = struct.unpack_from("<I", data, pos)
            pos += 4
            out.append((start + i, data[pos : pos + length]))
            pos += length
        return out

    def sync(self) -> None:
        self._lib.ls_sync(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.ls_close(self._handle)
            self._handle = None


class _PyPartitionLog:
    """Pure-Python reference writing the identical segment/index format."""

    def __init__(self, directory: str, segment_bytes: int):
        self._dir = pathlib.Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._segment_bytes = segment_bytes
        self._lock = threading.Lock()
        self._segments: List[Tuple[int, int]] = []  # (base, count)
        self._recover()

    def _paths(self, base: int) -> Tuple[pathlib.Path, pathlib.Path]:
        return (
            self._dir / f"{base:020d}.log",
            self._dir / f"{base:020d}.idx",
        )

    def _recover(self) -> None:
        bases = sorted(
            int(p.stem) for p in self._dir.glob("*.log") if p.stem.isdigit()
        )
        if not bases:
            bases = [0]
            for path in self._paths(0):
                path.touch()
        self._segments = []
        for base in bases:
            log_path, idx_path = self._paths(base)
            idx = idx_path.read_bytes() if idx_path.exists() else b""
            log = log_path.read_bytes() if log_path.exists() else b""
            n = len(idx) // _IDX.size
            valid = 0
            for i in range(n - 1, -1, -1):
                (pos,) = _IDX.unpack_from(idx, i * _IDX.size)
                if pos + _FRAME.size > len(log):
                    continue
                length, crc = _FRAME.unpack_from(log, pos)
                payload = log[pos + _FRAME.size : pos + _FRAME.size + length]
                if len(payload) == length and zlib.crc32(payload) == crc:
                    valid = i + 1
                    break
            # truncate torn tails
            with open(idx_path, "ab") as f:
                f.truncate(valid * _IDX.size)
            end = 0
            if valid:
                (pos,) = _IDX.unpack_from(idx, (valid - 1) * _IDX.size)
                length, _ = _FRAME.unpack_from(log, pos)
                end = pos + _FRAME.size + length
            with open(log_path, "ab") as f:
                f.truncate(end)
            self._segments.append((base, valid))

    def append(self, payload: bytes) -> int:
        with self._lock:
            base, count = self._segments[-1]
            log_path, idx_path = self._paths(base)
            size = log_path.stat().st_size if log_path.exists() else 0
            if size > 0 and size + _FRAME.size + len(payload) > self._segment_bytes:
                base, count = base + count, 0
                self._segments.append((base, 0))
                log_path, idx_path = self._paths(base)
                size = 0
            with open(log_path, "ab") as lf, open(idx_path, "ab") as xf:
                lf.write(_FRAME.pack(len(payload), zlib.crc32(payload)))
                lf.write(payload)
                xf.write(_IDX.pack(size))
            self._segments[-1] = (base, count + 1)
            return base + count

    def end_offset(self) -> int:
        with self._lock:
            base, count = self._segments[-1]
            return base + count

    def read_batch(self, start: int, max_records: int) -> List[Tuple[int, bytes]]:
        with self._lock:
            out: List[Tuple[int, bytes]] = []
            for base, count in self._segments:
                if start >= base + count or len(out) >= max_records:
                    continue
                if start < base:
                    start = base
                first = start - base
                upto = min(count, first + (max_records - len(out)))
                log_path, idx_path = self._paths(base)
                # seek-read only the needed span — that's what the .idx
                # position index is for; reading whole (up to 64 MB)
                # segments per poll would swamp the consumer loop.
                with open(idx_path, "rb") as xf:
                    xf.seek(first * _IDX.size)
                    idx = xf.read((upto - first + 1) * _IDX.size)
                (first_pos,) = _IDX.unpack_from(idx, 0)
                if upto < count:
                    (end_pos,) = _IDX.unpack_from(idx, (upto - first) * _IDX.size)
                else:
                    end_pos = log_path.stat().st_size
                with open(log_path, "rb") as lf:
                    lf.seek(first_pos)
                    log = lf.read(end_pos - first_pos)
                pos = 0
                while start < base + upto:
                    length, _ = _FRAME.unpack_from(log, pos)
                    out.append(
                        (start, log[pos + _FRAME.size : pos + _FRAME.size + length])
                    )
                    pos += _FRAME.size + length
                    start += 1
            return out

    def sync(self) -> None:
        ...

    def close(self) -> None:
        ...


def open_partition_log(
    directory: str, segment_bytes: int = DEFAULT_SEGMENT_BYTES
):
    """Open (creating/recovering) a partition log on the native store,
    building it on first use; a failed build raises."""
    return _NativePartitionLog(native.load("logstore"), directory, segment_bytes)
