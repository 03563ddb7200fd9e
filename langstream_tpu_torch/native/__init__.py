"""The port's native (C++) libraries, built with ``g++`` at first use.

The port's own copy of ``langstream_tpu/native/``: ``logstore.cpp`` is
the segmented log store under the ``tpulog`` broker (``topics/log/``),
``kafkacodec.cpp`` the CRC32C (Castagnoli) of the Kafka record batches
(``topics/kafka/protocol.py``). Each source is compiled on first use into
``build/native/`` at the repository root (git-ignored), the library name
carrying a hash of the source and the flags, as ``ops/_build.py`` names
the CUDA libraries, and loaded with ``ctypes``.

Nothing falls back quietly: a missing compiler or a failed build raises.
The pure-Python store and CRC of ``topics/log/store.py`` and
``topics/kafka/protocol.py`` are plain references for the tests only.
:data:`LOADED` names each library once it is loaded, so that a caller
can show that the native code was the one that ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
PACKAGE_DIR = os.path.dirname(NATIVE_DIR)
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "native")

GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
# logstore.cpp frames each record with zlib's crc32
LINK_FLAGS = {"logstore": ["-lz"], "kafkacodec": []}

_P, _U32, _U64, _I64, _SZ = (ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64,
                             ctypes.c_int64, ctypes.c_size_t)
# name -> {symbol: (restype, argtypes)}
SIGNATURES = {
    "logstore": {
        "ls_open": (_P, [ctypes.c_char_p, _U64]),
        "ls_append": (_I64, [_P, ctypes.c_char_p, _U32]),
        "ls_end_offset": (_I64, [_P]),
        "ls_base_offset": (_I64, [_P]),
        "ls_read_batch": (_I64, [_P, _I64, _I64, ctypes.c_char_p, _U64,
                                 ctypes.POINTER(_U64)]),
        "ls_sync": (ctypes.c_int, [_P]),
        "ls_close": (None, [_P]),
    },
    "kafkacodec": {
        "ls_crc32c": (_U32, [ctypes.c_char_p, _SZ, _U32]),
        "ls_varint_encode": (ctypes.c_int, [_I64, ctypes.c_char_p]),
        "ls_varint_decode": (ctypes.c_int, [ctypes.c_char_p, _SZ, ctypes.POINTER(_I64)]),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> the path of the library loaded in this process
LOADED: Dict[str, str] = {}


def _command(name: str, out: str) -> List[str]:
    return ["g++", *GXX_FLAGS, os.path.join(NATIVE_DIR, name + ".cpp"), "-o", out,
            *LINK_FLAGS[name]]


def library_path(name: str) -> str:
    with open(os.path.join(NATIVE_DIR, name + ".cpp"), "rb") as handle:
        digest = hashlib.sha256(handle.read())
    digest.update(" ".join(GXX_FLAGS + LINK_FLAGS[name]).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``native/<name>.cpp`` unless its library exists; raise on
    any failure. Processes that build at once each write a temporary file
    and rename it into place."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    if shutil.which("g++") is None:
        raise RuntimeError(f"g++ not found: the port's native {name} library is built from "
                           f"langstream_tpu_torch/native/{name}.cpp on first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    try:
        done = subprocess.run(_command(name, tmp), capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            raise RuntimeError(f"building native {name} failed:\n{done.stderr[-4000:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load(name: str) -> ctypes.CDLL:
    """The library of ``native/<name>.cpp``, built if needed, with its
    C signatures set."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = build(name)
        lib = ctypes.CDLL(path)
        for symbol, (restype, argtypes) in SIGNATURES[name].items():
            function = getattr(lib, symbol)
            function.restype = restype
            function.argtypes = argtypes
        _loaded[name] = lib
        LOADED[name] = path
        return lib
