"""Content-hashed cache for converted checkpoints and memoised weights.

Counterpart of gaitlab/weights/cache.py, with `torch.save` files (read
back with `torch.load(weights_only=True)`) in place of Orbax checkpoint
directories: a source checkpoint is converted once and the result is
stored under a key made of the source file's content hash, so later runs
skip the conversion. The cache is best effort: a failed write prints and
goes on uncached, and an entry that does not load is converted again.
$GAITLAB_WEIGHT_CACHE names its directory.
"""

from __future__ import annotations

import hashlib
import os
import os.path as osp
from typing import Any, Callable, Optional

import torch

DEFAULT_CACHE_DIR = os.environ.get(
    "GAITLAB_WEIGHT_CACHE", osp.expanduser("~/.cache/gaitlab/weights"))


def file_hash(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()[:16]


def _entry(src_path: str, tag: str, cache_dir: Optional[str]) -> str:
    root = cache_dir or DEFAULT_CACHE_DIR
    return osp.join(root,
                    f"{osp.basename(src_path)}.{tag}.{file_hash(src_path)}.pt")


def save(tree: Any, path: str) -> None:
    """Write a tree of tensors (dicts, lists, tuples) to `path`, whole or
    not at all."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load(path: str) -> Any:
    """Read a tree `save` wrote (tensors and plain containers only: a
    torch file needs no template, where gaitlab's Orbax restore takes
    one)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def memo_tree(cache_key: str, builder: Callable[[], Any],
              cache_dir: Optional[str] = None) -> Any:
    """Disk-memoise a tree of tensors by a string key (e.g. a random
    model initialisation)."""
    root = cache_dir or DEFAULT_CACHE_DIR
    key = hashlib.sha256(cache_key.encode()).hexdigest()[:16]
    path = osp.join(root, f"memo.{key}.pt")
    if osp.isfile(path):
        try:
            return load(path)
        except Exception:
            pass  # corrupt entry -> rebuild
    tree = builder()
    try:
        os.makedirs(root, exist_ok=True)
        save(tree, path)
    except Exception as e:
        print(f"memo_tree cache write failed ({e}); continuing uncached")
    return tree


def convert_cached(src_path: str, like: Any,
                   convert: Callable[[str, Any], Any], tag: str = "torch",
                   cache_dir: Optional[str] = None) -> Any:
    """Return `convert(src_path, like)`, memoised by the source file's
    content hash."""
    path = _entry(src_path, tag, cache_dir)
    if osp.isfile(path):
        try:
            return load(path)
        except Exception:
            pass  # corrupt/stale cache entry -> reconvert
    tree = convert(src_path, like)
    try:
        os.makedirs(osp.dirname(path), exist_ok=True)
        save(tree, path)
    except Exception as e:  # the cache is best effort
        print(f"weight-cache write failed ({e}); continuing uncached")
    return tree
