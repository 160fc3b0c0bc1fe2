"""Host frame loader: native C++ batch decoder + prefetch pipeline.

Counterpart of gaitlab/pipeline/loader.py. Decode is a C++ thread pool
(gaitlab_torch/native/loader.cc, GIL released, libpng/libjpeg) writing
straight into a caller-given buffer, and `PrefetchLoader` decodes chunk
i+1 on a worker thread while chunk i runs on the device. The library is
built with g++ at first use, from the checkout's source, into
`build/gaitlab_torch_native/` (listed in .gitignore), named by the hash of
the source. Without the toolchain or the codec headers it warns on stderr
and decodes with cv2, as gaitlab does; `native_status()` says which.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import os.path as osp
import queue
import subprocess
import sys
import sysconfig
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

_PKG_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
SRC = osp.join(_PKG_DIR, "native", "loader.cc")
BUILD_DIR = osp.join(osp.dirname(_PKG_DIR), "build", "gaitlab_torch_native")

_lock = threading.Lock()
_mod = None
_mod_error: Optional[str] = None


def _native():
    """Compile (once) and import the _gaitloader extension; None if the
    toolchain or codec libraries are unavailable."""
    global _mod, _mod_error
    with _lock:
        if _mod is not None or _mod_error is not None:
            return _mod
        try:
            with open(SRC, "rb") as f:
                tag = hashlib.sha256(f.read()).hexdigest()[:12]
            so = osp.join(BUILD_DIR, f"_gaitloader-{tag}.so")
            if not osp.isfile(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SRC,
                       "-o", tmp, f"-I{sysconfig.get_paths()['include']}",
                       "-lpng", "-ljpeg", "-pthread"]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed: {proc.stderr.strip()}")
                os.replace(tmp, so)
            spec = importlib.util.spec_from_file_location("_gaitloader", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _mod = mod
        except (OSError, RuntimeError, ImportError) as e:
            _mod_error = str(e) or type(e).__name__
            print(f"native loader unavailable ({_mod_error}); falling back "
                  f"to cv2", file=sys.stderr)
    return _mod


def native_status() -> tuple[str, Optional[str]]:
    """("native", None) when the C++ decoder is in use, else ("cv2", why
    the build or load failed). Builds the library if it is not yet."""
    return ("native", None) if _native() is not None else ("cv2", _mod_error)


def image_size(path: str) -> tuple[int, int]:
    """(height, width) of an image file."""
    mod = _native()
    if mod is not None:
        return tuple(mod.image_size(path))
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img.shape[0], img.shape[1]


def load_frames(paths: Sequence[str], n_threads: int = 16,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode a batch of same-size images -> (N, H, W, 3) uint8 RGB, into
    `out` when it is a C-contiguous array of that shape (a new array
    otherwise)."""
    paths = list(paths)
    if not paths:
        raise ValueError("empty path list")
    mod = _native()
    if mod is None:
        from gaitlab_torch.pipeline.video import load_frames as cv2_load

        frames = cv2_load(paths)
        if out is None or out.shape != frames.shape:
            return frames
        out[...] = frames
        return out
    h, w = image_size(paths[0])
    if out is None or out.shape != (len(paths), h, w, 3) \
            or not out.flags.c_contiguous:
        out = np.empty((len(paths), h, w, 3), np.uint8)
    mod.decode_batch(paths, memoryview(out).cast("B"), h, w, n_threads)
    return out


class PrefetchLoader:
    """Iterate (chunk_paths -> decoded frames) with one-chunk lookahead on
    a worker thread, so host decode overlaps device compute.

    With `pin`, each chunk is decoded into a new pinned uint8 tensor (the
    caching host allocator's), so that its copy to the card is
    asynchronous and the block is reused only once that copy has run;
    without it, chunks are numpy arrays."""

    def __init__(self, paths: Sequence[str], chunk: int = 32,
                 n_threads: int = 16, pin: bool = False):
        self.paths = list(paths)
        self.chunk = chunk
        self.n_threads = n_threads
        self.pin = pin

    def __len__(self):
        return -(-len(self.paths) // self.chunk)

    def _load(self, paths: list):
        if not self.pin:
            return load_frames(paths, n_threads=self.n_threads)
        h, w = image_size(paths[0])
        buf = torch.empty((len(paths), h, w, 3), dtype=torch.uint8,
                          pin_memory=True)
        load_frames(paths, n_threads=self.n_threads, out=buf.numpy())
        return buf

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue an item unless the consumer has left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for s in range(0, len(self.paths), self.chunk):
                    if not put(self._load(self.paths[s:s + self.chunk])):
                        return
                put(None)
            except Exception as e:  # raised in the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
