"""Data parallelism over a list of devices, in one process: what GSPMD gave
gaitlab for free when it sharded a batch over the mesh's "data" axis.

  * `Replicas`: one copy of a module per device, the first the module
    itself, each with its own CUDA stream;
  * `scatter`: a batch in contiguous equal row blocks, block i to device i
    (gaitlab's P("data") on dim 0);
  * `parallel_apply`: one call per replica, each launched from its own
    thread on its own stream;
  * `gather`: the replicas' outputs joined in order on one device.

One thread per replica, because one launching thread serializes them: the
card's launch queue holds about 1,000 launches, fewer than one GRNet
forward, so a single thread would block inside replica 0's forward before
it reached replica 1. One stream per replica, so that two replicas on one
card (a device list with repeats) run side by side.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Callable, Sequence

import torch
from torch import nn

from gaitlab_torch.device import held_math_mode, shared_math_mode
from gaitlab_torch.parallel.mesh import canonical


def _tensors(tree):
    """The tensors of an output: a tensor, or a dict, list or tuple of
    them."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _on(device: torch.device, stream) -> contextlib.AbstractContextManager:
    """The replica's device and stream made current (nothing on the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def parallel_apply(fns: Sequence[Callable], inputs: Sequence[tuple],
                   devices: Sequence[torch.device],
                   streams: Sequence) -> list:
    """fns[i](*inputs[i]) for every i at once, each on its own thread (the
    only one, in the caller's thread, when there is one call), with
    devices[i] and streams[i] current (None on the CPU), the caller's grad
    and inference modes, and the caller's turn at the TF32 gate when it
    holds one (device.shared_math_mode): the calls then run at its setting
    and may not ask for the other. Otherwise each call's segments set the
    switches themselves.

    Each stream first waits for the caller's current stream on its device,
    where the inputs were made, and the inputs are recorded on it for the
    caching allocator; when the calls have returned, the caller's stream
    waits for each replica's stream, and the outputs are recorded on it.
    The first error, in replica order, is raised again here."""
    n = len(fns)
    grad, infer = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
    tf32 = held_math_mode()
    callers = [None if s is None else torch.cuda.current_stream(d)
               for d, s in zip(devices, streams)]
    for args, stream, caller in zip(inputs, streams, callers):
        if stream is not None:
            stream.wait_stream(caller)
            for t in _tensors(args):
                if t.device == stream.device:
                    t.record_stream(stream)
    results, errors = [None] * n, [None] * n

    def run(i: int) -> None:
        try:
            with _on(devices[i], streams[i]), \
                    torch.inference_mode(infer), \
                    torch.set_grad_enabled(grad), shared_math_mode(tf32):
                results[i] = fns[i](*inputs[i])
        except BaseException as e:  # raised again in the caller below
            errors[i] = e

    if n == 1:
        run(0)
    else:
        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for stream, caller, out in zip(streams, callers, results):
        if stream is not None:
            caller.wait_stream(stream)
            for t in _tensors(out):
                if t.device == caller.device:
                    t.record_stream(caller)
    for e in errors:
        if e is not None:
            raise e
    return results


def replicate(module: nn.Module, devices: Sequence[torch.device]
              ) -> list[nn.Module]:
    """One copy of `module` per device: the first is the module itself when
    it lies on devices[0], every other a deepcopy moved to its device
    (bit-equal). A device named twice gets two copies."""
    params = list(module.parameters()) or list(module.buffers())
    home = canonical(params[0].device) if params else None
    out = []
    for i, dev in enumerate(devices):
        if i == 0 and canonical(dev) == home:
            out.append(module)
        else:
            out.append(copy.deepcopy(module).to(dev))
    return out


class Replicas:
    """A module's replicas over a device list (`replicate`), with one CUDA
    stream each (None on the CPU)."""

    def __init__(self, module: nn.Module, devices: Sequence):
        self.devices = [canonical(d) for d in devices]
        self.modules = replicate(module, self.devices)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]

    def __len__(self) -> int:
        return len(self.devices)

    def apply(self, fn: Callable, inputs: Sequence[tuple]) -> list:
        """fn(replica i, *inputs[i]) for every replica at once
        (parallel_apply)."""
        return parallel_apply(
            [lambda *a, m=m: fn(m, *a) for m in self.modules], inputs,
            self.devices, self.streams)


def scatter(batch: torch.Tensor, devices: Sequence[torch.device]
            ) -> list[torch.Tensor]:
    """`batch` in len(devices) contiguous equal row blocks, block i on
    devices[i] (a view where it already lies there). The rows must divide
    evenly."""
    n = len(devices)
    if len(batch) % n:
        raise ValueError(f"{len(batch)} rows do not split evenly over "
                         f"{n} devices")
    k = len(batch) // n
    return [batch[i * k:(i + 1) * k].to(d, non_blocking=True)
            for i, d in enumerate(devices)]


def gather(outputs: list, device: torch.device, dim: int = 0):
    """The replicas' outputs joined in replica order on `device`: tensors
    concatenated along `dim`, dicts key by key. Differentiable."""
    first = outputs[0]
    if isinstance(first, dict):
        return {k: gather([o[k] for o in outputs], device, dim)
                for k in first}
    if len(outputs) == 1:
        return first.to(device, non_blocking=True)
    return torch.cat([o.to(device, non_blocking=True) for o in outputs], dim)
