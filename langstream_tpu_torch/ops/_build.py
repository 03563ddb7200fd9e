"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain C entry points and is compiled on
first use by ``nvcc`` into its own shared library under ``build/kernels/``
at the repository root (git-ignored), then loaded with ``ctypes``. No
PyTorch headers are involved, so a build takes seconds. The library name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.

Wrappers call :func:`load` inside the function that launches the kernel,
never at import time: the CPU tests import every module on a machine with
no ``nvcc``. A build or load failure raises; nothing falls back to the
plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and shared memory of each kernel, kept in the log
]

# C signatures: every pointer and the stream are c_void_p (a bare int
# would be cut to 32 bits), counts are c_int, scalars c_float
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_prefill": {
        "flash_prefill": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
        # q, k, k_scale, v, v_scale, out, lengths, then as flash_prefill
        "flash_prefill_quant": [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P,
        ],
    },
    "flash_decode": {
        "flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
        # q, k, k_scale, v, v_scale, out, lengths, then as flash_decode
        "flash_decode_quant": [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P,
        ],
    },
    "paged_attention": {
        "paged_attention": [
            _P, _P, _P, _P, _P, _P, _P,          # q, pools, out, tables, starts, lengths
            _I, _I, _I, _I, _I, _I, _I, _I, _I,  # batch, seq, heads, kv_heads, dim,
                                                 # blocks, block size, table width, dtype
            _F, _F, _I, _P,                      # scale, softcap, window, stream
        ],
        "paged_attention_quant": [
            _P, _P, _P, _P, _P, _P,              # q, k pool, k scales, v pool, v scales, out
            _P, _P, _P,                          # tables, starts, lengths
            _I, _I, _I, _I, _I, _I, _I, _I, _I,  # as paged_attention
            _F, _F, _I, _P,
        ],
        "paged_attention_ragged_q": [
            _P, _P, _P, _P, _P, _P, _P, _P,      # q, pools, out, tables, starts,
                                                 # lengths, q_offsets
            _I, _I, _I, _I, _I, _I,              # batch, flat q rows, max_q_len,
                                                 # block_q, heads, kv_heads,
            _I, _I, _I, _I, _I,                  # dim, blocks, block size, table
                                                 # width, dtype
            _F, _F, _I, _P,                      # scale, softcap, window, stream
        ],
        "paged_attention_ragged_q_quant": [
            _P, _P, _P, _P, _P, _P,              # q, k pool, k scales, v pool, v scales, out
            _P, _P, _P, _P,                      # tables, starts, lengths, q_offsets
            _I, _I, _I, _I, _I, _I,              # as paged_attention_ragged_q
            _I, _I, _I, _I, _I,
            _F, _F, _I, _P,
        ],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source on first use"
    )


def library_path(name: str) -> str:
    source = os.path.join(CSRC_DIR, name + ".cu")
    with open(source, "rb") as handle:
        digest = hashlib.sha256(handle.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    """nvcc's output for the current library of ``name`` (``ptxas -v``)."""
    return library_path(name) + ".log"


def _start(name: str):
    """Start one nvcc for ``name`` (None when its library is current)."""
    target = library_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    partial = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    command = [
        nvcc_path(), *NVCC_FLAGS, "-o", partial,
        os.path.join(CSRC_DIR, name + ".cu"),
    ]
    process = subprocess.Popen(
        command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return name, target, partial, process


def _finish(job) -> None:
    name, target, partial, process = job
    output, _ = process.communicate()
    if process.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{output}")
    with open(target + ".log", "w") as handle:
        handle.write(output)
    os.replace(partial, target)  # atomic: a concurrent build never loads half a file


def build(names: Iterable[str]) -> None:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together."""
    jobs = [job for job in (_start(name) for name in names) if job is not None]
    errors: List[str] = []
    for job in jobs:
        try:
            _finish(job)
        except RuntimeError as error:
            errors.append(str(error))
    if errors:
        raise RuntimeError("\n".join(errors))


def build_all() -> None:
    build(SIGNATURES)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        build([name])
        lib = ctypes.CDLL(library_path(name))
        for symbol, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
        return lib


# a C entry point that cannot encode a TMA tensor map returns this plus
# the CUresult of the encode
ENCODE_FAILED = 10000


def check(status: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status >= ENCODE_FAILED:
        raise RuntimeError(f"{kernel}: tensor map encode failed (CUresult {status - ENCODE_FAILED})")
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA error {status} at launch")
