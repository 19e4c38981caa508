"""Host-RAM weight cache: a restarted worker skips the disk reload.

The counterpart of dynamo_tpu/models/weight_cache.py, with its rules: the
cache lives in tmpfs (/dev/shm, which outlives the process) unless
DYN_WEIGHT_CACHE_DIR moves it, DYN_WEIGHT_CACHE=0 turns it off, an entry
is keyed by the checkpoint's absolute path and invalidated by the same
fingerprint (names, sizes and mtimes of the *.safetensors and *.json
files), and writes are atomic (a temporary directory renamed into place,
its index written last).

What is cached is the port's parameter tree as the loader finished it
(cast, transposed): one raw-bytes file per tensor plus a JSON index of
(tree path, shape, dtype).  Nothing is pickled.  A read maps each file
and copies it to the device through the loader's staging (models/
loader.py Placer).  The port's entries live under `torch/` in the cache
directory, beside the JAX package's entries (16 hex digits each, holding
the JAX tree), so neither package ever reads the other's.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import shutil
import time
from typing import Any, Dict, Optional

import torch

from ..device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

DEFAULT_DIR = "/dev/shm/dynamo_weight_cache"
# the port's entries, under the cache directory
SUBDIR = "torch"
# tensor dtypes an entry may hold, by their index names
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def default_cache_dir() -> Optional[str]:
    """tmpfs when present (the point is RAM residency); None disables.
    The DYN_WEIGHT_CACHE=0 kill switch wins over DYN_WEIGHT_CACHE_DIR so
    an operator can force a clean checkpoint reload without unsetting
    the relocation variable."""
    if os.environ.get("DYN_WEIGHT_CACHE", "1").lower() in ("0", "false",
                                                           "off", "no"):
        return None
    env = os.environ.get("DYN_WEIGHT_CACHE_DIR")
    if env:
        return env
    return DEFAULT_DIR if os.path.isdir("/dev/shm") else None


def checkpoint_fingerprint(model_path: str) -> str:
    """Identity of the on-disk checkpoint: names, sizes and mtimes of its
    weight and config files (hashing their contents would cost the full
    disk read the cache exists to avoid)."""
    parts = []
    for f in sorted(os.listdir(model_path)):
        if f.endswith((".safetensors", ".json")):
            st = os.stat(os.path.join(model_path, f))
            parts.append(f"{f}:{st.st_size}:{int(st.st_mtime)}")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()


def _entry_dir(cache_dir: str, model_path: str) -> str:
    h = hashlib.sha1(os.path.abspath(model_path).encode()).hexdigest()[:16]
    return os.path.join(cache_dir, SUBDIR, h)


# -- tree path <-> string ---------------------------------------------------


def _flatten_with_paths(tree, prefix=""):
    """Yield (path, leaf) of a dict/list tree ('layers.3.wq' form)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _insert_path(root: Dict[str, Any], path: str, value) -> None:
    parts = path.split(".")
    node = root
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _listify(node):
    """Dicts whose keys are all consecutive ints become lists (restores
    the params['layers'] list)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        idx = sorted(out, key=int)
        if [int(k) for k in idx] == list(range(len(idx))):
            return [out[k] for k in idx]
    return out


# -- write ------------------------------------------------------------------


def write_cache(cache_dir: str, model_path: str, params) -> bool:
    """Persist the parameter tree leaf by leaf (one host copy at a time).
    Returns False, and cleans up, on any failure: the cache is an
    optimization, never a correctness dependency."""
    entry = _entry_dir(cache_dir, model_path)
    tmp = entry + ".tmp"
    try:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        index = {"fingerprint": checkpoint_fingerprint(model_path),
                 "tensors": {}}
        for i, (path, leaf) in enumerate(_flatten_with_paths(params)):
            host = leaf.detach().to("cpu").contiguous()
            dtype = str(host.dtype).removeprefix("torch.")
            if dtype not in _DTYPES:
                raise TypeError(f"{path}: dtype {dtype} is not cached")
            fname = f"t{i}.bin"
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(host.view(-1).view(torch.uint8).numpy().data)
            index["tensors"][path] = {"file": fname,
                                      "shape": list(host.shape),
                                      "dtype": dtype}
        with open(os.path.join(tmp, "index.json.tmp"), "w") as f:
            json.dump(index, f)
        # the index is written LAST and atomically: readers key on it
        os.replace(os.path.join(tmp, "index.json.tmp"),
                   os.path.join(tmp, "index.json"))
        shutil.rmtree(entry, ignore_errors=True)
        os.replace(tmp, entry)
        logger.info("weight cache written for %s (%d tensors) -> %s",
                    model_path, len(index["tensors"]), entry)
        return True
    except Exception:
        logger.warning("weight cache write failed for %s", model_path,
                       exc_info=True)
        shutil.rmtree(tmp, ignore_errors=True)
        return False


# -- read -------------------------------------------------------------------


def read_cache(cache_dir: str, model_path: str,
               device: DeviceLike = "cuda"):
    """The parameter tree from the cache on `device`, or None on a miss,
    a stale entry or a failed read (the caller then loads the
    checkpoint)."""
    from .loader import Placer, map_file, tensor_view

    dev = resolve_device(device)
    entry = _entry_dir(cache_dir, model_path)
    try:
        with open(os.path.join(entry, "index.json")) as f:
            index = json.load(f)
    except (OSError, ValueError):
        return None
    if index.get("fingerprint") != checkpoint_fingerprint(model_path):
        logger.info("weight cache stale for %s (checkpoint changed)",
                    model_path)
        return None
    t0 = time.perf_counter()
    placer = Placer(dev)
    stats = {"copies": 0}
    root: Dict[str, Any] = {}
    nbytes = 0
    try:
        for path, meta in index["tensors"].items():
            dtype = _DTYPES[meta["dtype"]]
            shape = tuple(meta["shape"])
            fname = os.path.join(entry, meta["file"])
            size = math.prod(shape) * dtype.itemsize
            if os.path.getsize(fname) != size:
                raise ValueError(f"{fname}: size does not match {shape}")
            src = (tensor_view(map_file(fname), dtype, shape, 0, stats)
                   if size else torch.empty(shape, dtype=dtype))
            _insert_path(root, path, placer.put(src, dtype))
            nbytes += size
        placer.finish()
    except Exception:
        logger.warning("weight cache read failed for %s; falling back to "
                       "the checkpoint", model_path, exc_info=True)
        return None
    logger.info("weights restored from host cache for %s to %s: %d tensors, "
                "%.3f GB in %.2f s", model_path, dev, len(index["tensors"]),
                nbytes / 1e9, time.perf_counter() - t0)
    return _listify(root)


def clear_cache(cache_dir: str, model_path: Optional[str] = None) -> None:
    """Drop the port's entry for `model_path`, or every entry of the port
    (the JAX package's entries stay)."""
    if model_path is not None:
        shutil.rmtree(_entry_dir(cache_dir, model_path), ignore_errors=True)
    else:
        shutil.rmtree(os.path.join(cache_dir, SUBDIR), ignore_errors=True)
