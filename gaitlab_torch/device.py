"""Device selection and the TF32 gate of the port.

Entry points run on the card unless the caller asks for the CPU; they
never drop to the CPU on their own.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Raises when CUDA is absent and the caller did not
    ask for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' (demo: --cpu_only) to "
            "run on the CPU")
    return device


def upload(x, device) -> torch.Tensor:
    """A host array or tensor on `device`. To the card it goes through
    pinned memory as an asynchronous copy: a copy from pageable memory
    makes the host wait until the card has run everything queued before
    it. The pinned block is the caching host allocator's, which reuses it
    only once the copy has run, so the caller need not keep it."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    device = torch.device(device)
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def constant(values: tuple, dtype: str, device) -> torch.Tensor:
    """A tensor of fixed values (an index list, a normalisation constant)
    on `device`, made once per device and shared: never write to it. A
    Python list turned into a card tensor, or used to index one, is copied
    to the card at every call, and that copy waits for the card's queue.
    Made outside inference mode, so that autograd may save it. While
    `torch.export` traces, the tensor is made on `device` as a constant of
    the program and not cached (the trace's tensors are fake)."""
    if torch.compiler.is_exporting():
        return torch.tensor(np.asarray(values, dtype), device=device)
    return _constant(values, dtype, device)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: str, device) -> torch.Tensor:
    with torch.inference_mode(False):
        return upload(np.asarray(values, dtype), device)


class _MathGate:
    """The TF32 switches of cuDNN and cuBLAS
    (`torch.backends.cudnn.allow_tf32`, `torch.backends.cuda.matmul.
    allow_tf32`) as a gate that threads enter with the setting they want.
    The switches are process-wide and read when an op is launched, and
    forwards run on several threads at once (ForwardStream's worker, the
    data-parallel replicas, the pipeline's stages). Threads that want the
    setting in force share it; a thread that wants the other one waits
    until the threads inside have left. Waiting threads are let in, in
    order of arrival, in turns of one setting: once a thread waits,
    threads that arrive later queue behind it, so neither setting starves
    the other. When the last thread leaves and none waits, the switches
    go back to what they were before the first entered.

    A thread inside asks again for the setting it holds without waiting;
    asking for the other one raises (it would wait for itself). Helper
    threads that a thread inside starts and joins share its turn
    (`shared_math_mode`)."""

    def __init__(self):
        self.cond = threading.Condition()
        self.tf32 = None     # the setting in force, None when no thread is in
        self.users = 0
        self.queue = collections.deque()  # [want, admitted] of waiting threads
        self.prev = None     # the switches before the first thread entered
        self.local = threading.local()

    def held(self):
        return getattr(self.local, "tf32", None)

    def _set(self, tf32: bool) -> None:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def _admit_front(self) -> None:
        """With nobody inside: let in every waiting thread that wants the
        setting of the first one waiting."""
        want = self.queue[0][0]
        for ticket in self.queue:
            if ticket[0] == want:
                ticket[1] = True
                self.users += 1
        self.queue = collections.deque(t for t in self.queue if not t[1])
        self.tf32 = want
        self._set(want)
        self.cond.notify_all()

    @contextlib.contextmanager
    def enter(self, tf32: bool):
        tf32 = bool(tf32)
        held = self.held()
        if held is not None:
            if held != tf32:
                raise RuntimeError(
                    f"this thread holds TF32={held} and asks for TF32="
                    f"{tf32}: switch between segments, not inside one")
            yield
            return
        with self.cond:
            if self.users == 0 and not self.queue:
                self.prev = (torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32)
                self.users, self.tf32 = 1, tf32
                self._set(tf32)
            elif self.users and self.tf32 == tf32 and not self.queue:
                self.users += 1
            else:
                ticket = [tf32, False]
                self.queue.append(ticket)
                while not ticket[1]:
                    self.cond.wait()
        self.local.tf32 = tf32
        try:
            yield
        finally:
            self.local.tf32 = None
            with self.cond:
                self.users -= 1
                if self.users == 0:
                    if self.queue:
                        self._admit_front()
                    else:
                        self.tf32 = None
                        (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32) = self.prev

    @contextlib.contextmanager
    def share(self, tf32):
        """Run as part of another thread's turn (`tf32` is what that thread
        holds, None for none)."""
        if tf32 is None:
            yield
            return
        self.local.tf32 = tf32
        try:
            yield
        finally:
            self.local.tf32 = None


_gate = _MathGate()


def math_mode(tf32: bool):
    """A context in which cuDNN convolutions and cuBLAS matmuls launched by
    this thread run with TF32 on (`tf32=True`) or in full float32 (False),
    whatever other threads want: see `_MathGate`. The port switches it at
    segment boundaries (a backbone region, the head, the gait corrector,
    the SMPL regression), never inside one."""
    return _gate.enter(tf32)


def float32_math():
    """Full float32 for cuDNN convolutions and cuBLAS matmuls: TF32 off for
    both (cuDNN convolutions default to TF32 on Hopper); `math_mode(False)`."""
    return _gate.enter(False)


def held_math_mode():
    """The TF32 setting this thread holds (True, False), None outside."""
    return _gate.held()


def shared_math_mode(tf32):
    """Run a helper thread inside the turn of the thread that started it,
    which holds `tf32` (from its `held_math_mode()`) and joins the helper
    before it leaves."""
    return _gate.share(tf32)
