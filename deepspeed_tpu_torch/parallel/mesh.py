"""Device mesh and parallelism topology (JAX ``deepspeed_tpu/parallel/mesh.py``).

One named-axis grid over the ranks of the process group, in place of JAX's
``jax.sharding.Mesh`` over devices.  Each reference "group" is a mesh axis,
or a tuple of axes, that collectives run over (``comm/groups.py``):

  reference group                     mesh axis
  ------------------------------      -------------------
  data_parallel_group                 ("data",) (+ "fsdp" when ZeRO shards there)
  model_parallel_group (TP)           ("tensor",)
  pipe_parallel_group                 ("pipe",)
  expert_parallel_group               ("expert",)
  sequence_parallel_group             ("sequence",)
  sequence_data_parallel_group        ("data", "sequence")

The sizes are checked against the world size of the process group (one rank
a device) where JAX checks them against a device list, with JAX's
resolution of ``-1`` and JAX's errors.  Rank ``r`` sits at the coordinate
that JAX gives device ``r`` in ``np.asarray(devices).reshape(shape)``: row
major over ``axis_order``.  Above one rank the grid is also a
``torch.distributed.device_mesh.DeviceMesh`` (``init_device_mesh``) with the
same dims, whose per-axis process groups the collectives use.
"""

from typing import Dict, Optional, Tuple

import numpy as np

from ..runtime.config import MeshConfig
from ..utils.logging import logger

# Canonical axis names (every subsystem refers to these).
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQUENCE_AXIS = "sequence"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"

ALL_AXES = (PIPE_AXIS, DATA_AXIS, FSDP_AXIS, EXPERT_AXIS, SEQUENCE_AXIS, TENSOR_AXIS)


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class MeshTopology:
    """Named-axis cartesian grid of the ranks: ``shape`` maps each axis, in
    ``axis_order``, to its size; ``device_mesh`` is the torch DeviceMesh above
    one rank (None at one rank)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.device_mesh = device_mesh

    # ---- construction -------------------------------------------------------
    @classmethod
    def build(cls, config: Optional[MeshConfig] = None, world_size: Optional[int] = None,
              device_type: Optional[str] = None) -> "MeshTopology":
        """The mesh of ``config`` over ``world_size`` ranks (the process
        group's, 1 without one).  ``device_type`` is the DeviceMesh's
        ("cuda" under NCCL, else "cpu")."""
        n = _world_size() if world_size is None else int(world_size)
        shape = cls.resolve(config or MeshConfig(), n)
        order = list(shape)
        device_mesh = None
        if n > 1:
            import torch.distributed as dist
            from torch.distributed.device_mesh import init_device_mesh
            if device_type is None:
                device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
            device_mesh = init_device_mesh(device_type, tuple(shape.values()),
                                           mesh_dim_names=tuple(order))
        logger.info(f"MeshTopology: {shape} over {n} ranks")
        return cls(shape, device_mesh)

    @staticmethod
    def resolve(config: MeshConfig, n: int) -> Dict[str, int]:
        """The axis sizes of ``config`` over ``n`` ranks, in ``axis_order``:
        JAX's resolution of -1 and its errors."""
        sizes = dict(config.axis_sizes())
        fixed = 1
        wild_axis = None
        for a, s in sizes.items():
            if s == -1:
                wild_axis = a
            else:
                fixed *= s
        if wild_axis is None:
            if fixed != n:
                raise ValueError(f"mesh axes {sizes} multiply to {fixed} but {n} devices are present")
        else:
            if n % fixed != 0:
                raise ValueError(f"{n} devices not divisible by fixed axes product {fixed}")
            sizes[wild_axis] = n // fixed
        order = list(config.axis_order)
        for a in ALL_AXES:
            if a not in order:
                order.append(a)
        return {a: sizes[a] for a in order}

    @classmethod
    def from_axis_dict(cls, axes: Dict[str, int], world_size: Optional[int] = None,
                       device_type: Optional[str] = None) -> "MeshTopology":
        cfg = {a: axes.get(a, 1) for a in ALL_AXES}
        return cls.build(MeshConfig(**cfg), world_size=world_size, device_type=device_type)

    # ---- accessors (groups.py parity) ---------------------------------------
    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    @property
    def world_size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def get_data_parallel_world_size(self) -> int:
        """ZeRO's dp world: data x fsdp (replicated 'data', sharded 'fsdp')."""
        return self.axis_size(DATA_AXIS) * self.axis_size(FSDP_AXIS)

    def get_model_parallel_world_size(self) -> int:
        return self.axis_size(TENSOR_AXIS)

    def get_pipe_parallel_world_size(self) -> int:
        return self.axis_size(PIPE_AXIS)

    def get_expert_parallel_world_size(self) -> int:
        return self.axis_size(EXPERT_AXIS)

    def get_sequence_parallel_world_size(self) -> int:
        return self.axis_size(SEQUENCE_AXIS)

    def get_sequence_data_parallel_world_size(self) -> int:
        """The group ZeRO shards across when Ulysses is active."""
        return self.get_data_parallel_world_size() * self.get_sequence_parallel_world_size()

    def data_parallel_axes(self) -> Tuple[str, ...]:
        axes = tuple(a for a in (DATA_AXIS, FSDP_AXIS) if self.axis_size(a) > 1)
        return axes or (DATA_AXIS, )

    # ---- rank layout ----------------------------------------------------------
    def coordinate(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The mesh coordinate of ``rank`` (this process's by default):
        row major over the axes, as JAX lays device ``rank`` out."""
        rank = _rank() if rank is None else rank
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def __enter__(self):
        self._prev = get_topology_or_none()
        set_topology(self)
        return self

    def __exit__(self, *exc):
        set_topology(self._prev)
        return False

    def __repr__(self):
        return f"MeshTopology({self.shape})"


_GLOBAL_TOPOLOGY: Optional[MeshTopology] = None


def set_topology(topo: Optional[MeshTopology]):
    global _GLOBAL_TOPOLOGY
    _GLOBAL_TOPOLOGY = topo


def get_topology_or_none() -> Optional[MeshTopology]:
    return _GLOBAL_TOPOLOGY


def get_topology() -> MeshTopology:
    global _GLOBAL_TOPOLOGY
    if _GLOBAL_TOPOLOGY is None:
        _GLOBAL_TOPOLOGY = MeshTopology.build()
    return _GLOBAL_TOPOLOGY


def reset_topology():
    global _GLOBAL_TOPOLOGY
    _GLOBAL_TOPOLOGY = None

