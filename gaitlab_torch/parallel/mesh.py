"""Device mesh and sharding helpers: a ("data", "model") grid of torch
devices.

Counterpart of gaitlab/parallel/mesh.py. gaitlab annotates shardings on a
jax Mesh and GSPMD places the arrays and inserts the collectives; the port
keeps the mesh, the sharding specs and the placement rule, and runs data
parallelism itself (parallel/replicas.py) in one process over a list of
devices. A list may name a device more than once: two replicas on one card
then run side by side on separate streams.

The "model" axis only places parameters (param_shardings, shard_params),
as in gaitlab, where no entry point computes with more than one model
shard.

gaitlab's rule picks a dim of each parameter in its Flax layout, where the
output features come last (Dense (in, out), convolutions HWIO); torch keeps
them first (Linear (out, in), Conv2d OIHW). param_shardings therefore
computes the spec on the Flax-layout shape of each state_dict tensor and
maps it through the axes that weights/convert.py permutes (`flax_axes`), so
that both packages split the same logical dim.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gaitlab_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
MIN_ELEMS = 1 << 14


def default_devices() -> list[torch.device]:
    """Every visible card, in index order; raises without CUDA. Tests and
    the smoke may swap it for a list with repeats."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def devices_for(device) -> list[torch.device]:
    """The devices that a model on `device` spreads over when the caller
    names none: every visible card (default_devices()) for a model on a
    card, its own device otherwise (the CPU alone)."""
    device = torch.device(device)
    return default_devices() if device.type == "cuda" else [device]


def canonical(device) -> torch.device:
    """`device` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceMesh:
    """A 2-D grid of torch devices with the axes ("data", "model"): row i
    holds the devices of data index i. `shape` is a dict, as jax's
    Mesh.shape."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: np.ndarray):
        self.devices = devices  # (data, model) object array of torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> list[torch.device]:
        """One device per data index (the first of its row): where a
        data-parallel replica runs."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {self.devices.tolist()})"


def make_mesh(n_devices: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ("data", "model") mesh over the first `n_devices` of `devices`
    (default: every visible card; without CUDA this raises, it never takes
    the CPU). `model` is the model-axis size; the data axis is
    n_devices // model."""
    if devices is None:
        devices = default_devices()
    devices = [canonical(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % model:
        raise ValueError(f"n_devices={n_devices} not divisible by "
                         f"model={model}")
    if not 0 < n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices} of {len(devices)} devices")
    grid = np.empty(n_devices, object)
    grid[:] = devices[:n_devices]
    return DeviceMesh(grid.reshape(n_devices // model, model))


class NamedSharding(NamedTuple):
    """Where a tensor lies on a mesh: `spec` names, for each leading dim,
    the mesh axis it is split over (None: not split); () replicates it on
    every device (jax's NamedSharding with a PartitionSpec)."""

    mesh: DeviceMesh
    spec: tuple


def data_sharding(mesh: DeviceMesh, ndim: int = 4,
                  axis: int = 0) -> NamedSharding:
    """Dim `axis` (the batch/frame dim) split over the data axis."""
    spec = [None] * ndim
    spec[axis] = DATA_AXIS
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _model_spec(shape: tuple, model_size: int, min_elems: int) -> tuple:
    """gaitlab's model-parallel spec of one parameter of Flax-layout
    `shape`: the last (output-features) dim, else the largest one that
    the model axis divides, for tensors of at least `min_elems` elements;
    () replicates the rest (biases, BN statistics, small kernels)."""
    if model_size <= 1 or math.prod(shape) < min_elems:
        return ()
    order = [len(shape) - 1] + sorted(range(len(shape) - 1),
                                      key=lambda i: -shape[i])
    for i in order:
        if shape[i] % model_size == 0 and shape[i] >= 2 * model_size:
            spec = [None] * len(shape)
            spec[i] = MODEL_AXIS
            return tuple(spec)
    return ()


def flax_axes(key: str, ndim: int) -> tuple:
    """For each dim of the state_dict tensor `key`, the dim of its gaitlab
    (Flax) leaf that it holds, or None for a dim the converter adds
    (weights/convert.py::_convert_leaf): a convolution's OIHW weight holds
    HWIO, a Dense's (out, in) weight (in, out), the PARE head's locally
    connected (1, O, I, J, 1, 1) weight (J, I, O). Every other tensor keeps
    its layout: BN, biases, SMPL's fields, the gait corrector's token-wise
    weights. The gait corrector's packed GRU and attention matrices, which
    the converter builds from several Flax leaves, count as Dense."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf.startswith("weight"):
        if ndim == 4:
            return (3, 2, 0, 1)
        if ndim == 2:
            return (1, 0)
        if ndim == 6:
            return (None, 2, 1, 0, None, None)
    return tuple(range(ndim))


def _leaf_sharding(x, axes: tuple, mesh: DeviceMesh,
                   min_elems: int) -> NamedSharding:
    shape = tuple(x.shape)
    flax_shape = [0] * sum(a is not None for a in axes)
    for n, a in zip(shape, axes):
        if a is not None:
            flax_shape[a] = n
    spec = _model_spec(tuple(flax_shape), mesh.shape[MODEL_AXIS], min_elems)
    if not spec:
        return NamedSharding(mesh, ())
    return NamedSharding(mesh, tuple(None if a is None else spec[a]
                                     for a in axes))


def param_shardings(params, mesh: DeviceMesh,
                    min_elems: int = MIN_ELEMS):
    """The sharding of each parameter, split over "model" and replicated
    over "data": for a state_dict (a mapping of name -> tensor), spec by
    spec gaitlab's on the same logical dim (`flax_axes`); for SMPLParams
    (or another named tuple of arrays, whose layout both packages share),
    field by field, None staying None."""
    if isinstance(params, Mapping):
        return {k: _leaf_sharding(v, flax_axes(k, v.dim()), mesh, min_elems)
                for k, v in params.items()}
    return type(params)(*(
        None if v is None else _leaf_sharding(
            v, tuple(range(np.ndim(v))), mesh, min_elems) for v in params))


class ShardedTensor(NamedTuple):
    """A tensor placed on a mesh: one shard per mesh device, in mesh order
    (row by row), each on its device."""

    sharding: NamedSharding
    shards: list

    def full(self) -> torch.Tensor:
        """The tensor reassembled from the first data row's shards, on its
        first device."""
        mesh, spec = self.sharding
        row = self.shards[:mesh.shape[MODEL_AXIS]]
        if MODEL_AXIS not in spec:
            return row[0]
        dev = row[0].device
        return torch.cat([s.to(dev) for s in row], spec.index(MODEL_AXIS))


def place(x, sharding: NamedSharding) -> ShardedTensor:
    """`x` split as `sharding` says, each mesh device's block copied onto
    it."""
    x = torch.as_tensor(x)
    mesh, spec = sharding
    n = {DATA_AXIS: mesh.shape[DATA_AXIS], MODEL_AXIS: mesh.shape[MODEL_AXIS]}
    shards = []
    for (i, j), dev in np.ndenumerate(mesh.devices):
        at = {DATA_AXIS: i, MODEL_AXIS: j}
        index = []
        for dim, axis in enumerate(spec):
            if axis is None:
                index.append(slice(None))
            else:
                size = x.shape[dim] // n[axis]
                index.append(slice(at[axis] * size, (at[axis] + 1) * size))
        shards.append(x[tuple(index)].to(dev, copy=True))
    return ShardedTensor(sharding, shards)


def shard_params(params, mesh: DeviceMesh, min_elems: int = MIN_ELEMS):
    """Place a state_dict or SMPLParams onto the mesh with the
    model-parallel layout of param_shardings: the same structure, each
    tensor a ShardedTensor."""
    shardings = param_shardings(params, mesh, min_elems)
    if isinstance(params, Mapping):
        return {k: place(v, shardings[k]) for k, v in params.items()}
    return type(params)(*(None if v is None else place(v, s)
                          for v, s in zip(params, shardings)))
