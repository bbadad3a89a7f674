"""Device mesh and axis conventions.

Port of `handsonvlm_tpu/parallel/mesh.py` on `torch.distributed`'s
`DeviceMesh`. The mesh is 2-D, ``('data', 'model')``:

- ``data``: the batch / FSDP axis. Parameters and optimizer state shard
  along it (`parallel/partition.shard_model`, FSDP2), each rank takes its
  rows of the global batch.
- ``model``: the tensor-parallel axis (attention heads, weight columns and
  rows; `parallel/tp.py`), of decode and of training: a training rank
  holds its Megatron cut of the decoder (`tp.shard_for_training`), FSDP2
  shards those slices over ``data``, and `model_group` gives the axis's
  ranks as a `tp.TPGroup`.

With ``seq > 1`` the mesh is ``('data', 'seq')`` instead: the sequence-
parallel ring of `parallel/ring_attention.py`. ``seq`` and ``model`` above 1
together are refused, as in the JAX package. A mesh spans the ranks of the
default process group (one device each); a single process gets a one-rank
group of its own (`distributed.ensure_process_group`).
"""

from __future__ import annotations

from typing import Dict, Optional, TYPE_CHECKING

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from handsonvlm_torch.parallel.distributed import device_type, ensure_process_group

if TYPE_CHECKING:
    from handsonvlm_torch.parallel.tp import TPGroup

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
MESH_AXES = (DATA_AXIS, MODEL_AXIS)


def create_mesh(
    data: Optional[int] = None,
    model: int = 1,
    seq: int = 1,
    device: Optional[str] = None,
) -> DeviceMesh:
    """A ('data', 'model') mesh, or ('data', 'seq') when ``seq > 1``, over
    every rank of the process group, ranks laid out row-major as the JAX
    package lays out its devices (the minor axis holds consecutive ranks).
    ``data=None`` takes every rank left after the model / seq axis.
    ``device`` ("cuda" or "cpu") defaults to cuda when the card is there."""
    ensure_process_group(device)
    n = torch.distributed.get_world_size()
    if seq > 1 and model > 1:
        raise ValueError("seq and model axes are mutually exclusive")
    minor = seq if seq > 1 else model
    if data is None:
        if n % minor != 0:
            raise ValueError(f"{n} devices not divisible by {minor}")
        data = n // minor
    if data * minor != n:
        raise ValueError(f"mesh {data}x{minor} != {n} devices")
    ranks = np.arange(n).reshape(data, minor)
    names = (DATA_AXIS, SEQ_AXIS) if seq > 1 else MESH_AXES
    return DeviceMesh(device_type(device), torch.as_tensor(ranks), mesh_dim_names=names)


def single_device_mesh(device: Optional[str] = None) -> DeviceMesh:
    return create_mesh(data=1, model=1, device=device)


def mesh_shape(mesh: Optional[DeviceMesh]) -> Dict[str, int]:
    """{axis name: size}, the JAX mesh's `shape` ({} without a mesh)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate on `axis` (0 where the mesh has no such axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def model_group(mesh: Optional[DeviceMesh]) -> Optional["TPGroup"]:
    """The mesh's 'model' axis as a `tp.TPGroup` (this rank's coordinate,
    the axis's size, its process group); None where the axis is absent or
    1 wide."""
    from handsonvlm_torch.parallel.tp import TPGroup

    n = mesh_shape(mesh).get(MODEL_AXIS, 1)
    if n == 1:
        return None
    return TPGroup(mesh.get_local_rank(MODEL_AXIS), n, mesh.get_group(MODEL_AXIS))


def data_group(mesh: Optional[DeviceMesh]):
    """The process group whose ranks hold other rows of a batch: the 'data'
    axis's when the mesh has a model axis above 1 (its ranks hold the
    same rows), else None, the default group (the data axis, or data x
    seq, every rank)."""
    if model_group(mesh) is None:
        return None
    return mesh.get_group(DATA_AXIS)
