"""Build and load the port's CUDA sources.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc into
its own shared library at first use, then loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

(`torch.utils.cpp_extension.load` would include PyTorch's headers and
take minutes per build; a plain C interface builds in seconds.)  The
library name carries a hash of the source and flags, so an edited source
is rebuilt and a stale library is never loaded.  `_build/` is listed in
.gitignore.  A failed build raises with nvcc's output: there is no
fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (name, argtypes, restype) per exported C function
Signature = Tuple[str, Sequence, object]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built on this machine")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def compile_sources(names: Iterable[str]) -> Dict[str, str]:
    """Build every named source whose library is missing: one nvcc process
    per source, all started together.  Returns {name: nvcc's output}
    (register and shared-memory use from -Xptxas -v); a name that was
    already built maps to ""."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs: List[tuple] = []
    logs: Dict[str, str] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load_library(name: str, signatures: Sequence[Signature]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed, with
    argtypes/restype set for each exported function."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            compile_sources([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, argtypes, restype in signatures:
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _loaded[name] = lib
        return lib


def check_status(lib: ctypes.CDLL, error_fn: str, status: int,
                 what: str) -> None:
    """Raise when a C entry returned a CUDA error (its cudaGetLastError
    right after the launch)."""
    if status != 0:
        msg = getattr(lib, error_fn)(status)
        raise RuntimeError(f"{what}: CUDA error {status}: "
                           f"{msg.decode() if msg else 'unknown'}")
