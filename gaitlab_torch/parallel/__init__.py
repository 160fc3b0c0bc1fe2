"""Parallelism over a list of devices in one process (counterpart of
gaitlab/parallel): the ("data", "model") mesh and its sharding helpers
(mesh.py), data-parallel replicas (replicas.py) and the 2-stage pipeline
(pipeline.py: GRNetPipeline, split_state_dict, which imports the model
code and so is not loaded here)."""

from gaitlab_torch.parallel.mesh import (  # noqa: F401
    data_sharding,
    make_mesh,
    param_shardings,
    replicated,
    shard_params,
)
