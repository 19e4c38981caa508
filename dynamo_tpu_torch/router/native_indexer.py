"""ctypes binding for the C++ KV indexer (csrc/kv_indexer.cc).

The port's copy of dynamo_tpu/router/native_indexer.py, with its own
build: the source is compiled with the host C++ compiler (`$CXX`, else
`c++`, else `g++`) at first use,

    c++ -O3 -std=c++17 -fPIC -shared -o _build/libkv_indexer-<hash>.so \\
        csrc/kv_indexer.cc

into the git-ignored `dynamo_tpu_torch/_build/`, named by a hash of the
source and the flags as ops/_build.py names the kernels' libraries, so an
edited source is rebuilt and a stale library never loaded.  A failed
build raises with the compiler's output.  Same interface as
indexer.PyKvIndexer; `make_indexer("native")` builds it, and `auto`
takes it when it is already built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "kv_indexer.cc"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_loaded: Optional[ctypes.CDLL] = None


def compiler() -> str:
    for name in (os.environ.get("CXX", ""), "c++", "g++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no C++ compiler ($CXX, c++ or g++ on PATH): the "
                       "native KV indexer cannot be built on this machine")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libkv_indexer-{digest[:12]}.so"


def is_built() -> bool:
    return library_path().exists()


def build() -> Path:
    """The library, compiled first when it is missing.  Raises
    RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise RuntimeError(f"building the native KV indexer failed (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _loaded
    with _lock:
        if _loaded is None:
            lib = ctypes.CDLL(str(build()))
            lib.kvi_new.restype = ctypes.c_void_p
            lib.kvi_free.argtypes = [ctypes.c_void_p]
            lib.kvi_apply_stored.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ]
            lib.kvi_apply_removed.argtypes = lib.kvi_apply_stored.argtypes
            lib.kvi_remove_worker.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int64]
            lib.kvi_find_matches.restype = ctypes.c_int
            lib.kvi_find_matches.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ]
            lib.kvi_num_blocks.restype = ctypes.c_uint64
            lib.kvi_num_blocks.argtypes = [ctypes.c_void_p]
            lib.kvi_worker_block_count.restype = ctypes.c_int64
            lib.kvi_worker_block_count.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_int64]
            _loaded = lib
        return _loaded


def _pack(hashes: Sequence[int]):
    """128-bit ints -> contiguous u64 pairs.  Byte order doesn't matter as
    long as it's consistent (the C++ side only hashes/compares keys), so one
    to_bytes per hash + a buffer copy beats per-word shifting."""
    n = len(hashes)
    buf = b"".join(h.to_bytes(16, "big") for h in hashes)
    arr = (ctypes.c_uint64 * (2 * n)).from_buffer_copy(buf)
    return arr, n


class NativeKvIndexer:
    MAX_MATCH_WORKERS = 1024

    def __init__(self) -> None:
        self._lib = _lib()
        self._ptr = self._lib.kvi_new()
        self._workers: set[int] = set()
        self.last_event_id: Dict[int, int] = {}
        self._out_w = (ctypes.c_int64 * self.MAX_MATCH_WORKERS)()
        self._out_o = (ctypes.c_int32 * self.MAX_MATCH_WORKERS)()

    def __del__(self) -> None:
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.kvi_free(ptr)
            self._ptr = None

    def apply_stored(self, worker_id: int, hashes: Sequence[int]) -> None:
        if not hashes:
            return
        arr, n = _pack(hashes)
        self._lib.kvi_apply_stored(self._ptr, worker_id, arr, n)
        self._workers.add(worker_id)

    def apply_removed(self, worker_id: int, hashes: Sequence[int]) -> None:
        if not hashes:
            return
        arr, n = _pack(hashes)
        self._lib.kvi_apply_removed(self._ptr, worker_id, arr, n)

    def remove_worker(self, worker_id: int) -> None:
        self._lib.kvi_remove_worker(self._ptr, worker_id)
        self._workers.discard(worker_id)
        self.last_event_id.pop(worker_id, None)

    def clear_worker(self, worker_id: int) -> None:
        self._lib.kvi_remove_worker(self._ptr, worker_id)

    def find_matches(self, hashes: Sequence[int]) -> Dict[int, int]:
        if not hashes:
            return {}
        arr, n = _pack(hashes)
        out_w, out_o = self._out_w, self._out_o
        k = self._lib.kvi_find_matches(self._ptr, arr, n, out_w, out_o,
                                       self.MAX_MATCH_WORKERS)
        return {out_w[i]: out_o[i] for i in range(k) if out_o[i] > 0}

    def worker_block_count(self, worker_id: int) -> int:
        return int(self._lib.kvi_worker_block_count(self._ptr, worker_id))

    @property
    def num_blocks(self) -> int:
        return int(self._lib.kvi_num_blocks(self._ptr))

    @property
    def workers(self) -> List[int]:
        return list(self._workers)
