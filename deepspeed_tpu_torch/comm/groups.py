"""Process groups over mesh axes (JAX ``deepspeed_tpu/comm/groups.py``).

A group is a SCOPE OVER NAMED MESH AXES: an ordered tuple of axes of the
topology (``parallel/mesh.py``), with rank/size queries.  The ranks that
share this process's coordinate on every other axis form its group; the
rank within the group is the coordinate over the group's axes linearised
first axis slowest, as JAX's ``axis_index`` over a tuple is.

Under ``torch.distributed`` a group needs a communicator: ``torch_group()``
gives the torch ``ProcessGroup`` of this process's group, one for each tuple
of axes and topology, cached.  A single axis takes the DeviceMesh's own
per-dim group; a tuple of several axes of size > 1 is made with
``new_subgroups_by_enumeration`` the first time any rank asks, which every
rank of the world must then do in the same order (as every collective
already is).  torch orders a group's ranks by global rank; ``members()``
keeps the linear order, and the collectives reorder their chunks by it.

Arbitrary rank subsets are unsupported, as in JAX: ``new_group(ranks=...)``
raises with guidance.
"""

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..parallel.mesh import (DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, PIPE_AXIS, SEQUENCE_AXIS,
                             TENSOR_AXIS, MeshTopology, get_topology)

# (id(topology), axes) -> (topology, torch ProcessGroup); the topology is held so
# that its id stays unique while the entry lives
_TORCH_GROUPS: dict = {}


def reset_group_cache() -> None:
    """Forget the torch subgroups (after ``destroy_process_group``)."""
    _TORCH_GROUPS.clear()


class ProcessGroup:
    """A communication scope = an ordered tuple of mesh axes."""

    def __init__(self, axes: Union[str, Sequence[str]], topology: Optional[MeshTopology] = None):
        self.axes: Tuple[str, ...] = (axes, ) if isinstance(axes, str) else tuple(axes)
        self._topo = topology
        for a in self.axes:
            if a not in self.topology.axis_names:
                raise ValueError(f"unknown mesh axis {a!r}; mesh has {self.topology.axis_names}")

    @property
    def topology(self) -> MeshTopology:
        return self._topo or get_topology()

    # ------------------------------------------------------------------ sizes
    def size(self) -> int:
        s = 1
        for a in self.axes:
            s *= self.topology.axis_size(a)
        return s

    # ------------------------------------------------------------------ ranks
    def rank(self, global_rank: Optional[int] = None) -> int:
        """This process's rank in the group (or ``global_rank``'s): its
        coordinate over the group's axes, first axis slowest."""
        coord = self.topology.coordinate(global_rank)
        r = 0
        for a in self.axes:
            r = r * self.topology.axis_size(a) + coord[a]
        return r

    def axis_index(self) -> int:
        """The rank along this group (JAX's in-graph ``axis_index``; eager here)."""
        return self.rank()

    def members(self, global_rank: Optional[int] = None) -> List[int]:
        """The global ranks of this process's group (or ``global_rank``'s),
        in group-rank order."""
        topo = self.topology
        coord = topo.coordinate(global_rank)
        shape = tuple(topo.shape.values())
        out = []
        for i in range(self.size()):
            c = dict(coord)
            for a in reversed(self.axes):
                c[a] = i % topo.axis_size(a)
                i //= topo.axis_size(a)
            out.append(int(np.ravel_multi_index(tuple(c[a] for a in topo.axis_names), shape)))
        return out

    def torch_group(self):
        """The torch ProcessGroup of this process's group, cached.  None at
        size 1 (a collective over one rank is the identity), but for a world
        of one rank with a process group up: then the world group, so that
        the collectives still run through the backend."""
        import torch.distributed as dist
        topo = self.topology
        if self.size() == 1:
            return dist.group.WORLD if topo.world_size == 1 and dist.is_initialized() else None
        wide = tuple(a for a in self.axes if topo.axis_size(a) > 1)
        key = (id(topo), wide)
        hit = _TORCH_GROUPS.get(key)
        if hit is not None:
            return hit[1]
        if topo.device_mesh is None:
            raise RuntimeError(f"{self!r} spans {self.size()} ranks but the topology has no "
                               f"DeviceMesh: build it after init_distributed()")
        if self.size() == topo.world_size:
            pg = dist.group.WORLD
        elif len(wide) == 1:
            pg = topo.device_mesh.get_group(wide[0])
        else:
            groups, seen = [], set()
            for r in range(topo.world_size):
                ranks = tuple(sorted(ProcessGroup(wide, topo).members(r)))
                if ranks not in seen:
                    seen.add(ranks)
                    groups.append(list(ranks))
            pg, _ = dist.new_subgroups_by_enumeration(groups)
        _TORCH_GROUPS[key] = (topo, pg)
        return pg

    def __repr__(self):
        return f"ProcessGroup(axes={self.axes}, size={self.size()})"


def new_group(axes: Union[str, Sequence[str], None] = None, ranks=None,
              topology: Optional[MeshTopology] = None) -> ProcessGroup:
    """A group scope (reference ``comm.new_group``): pass ``axes`` (a mesh
    axis name or tuple).  torch-style ``ranks`` raise: re-factor the mesh
    instead (``MeshTopology.from_axis_dict``)."""
    if ranks is not None:
        raise NotImplementedError(
            "rank-list groups are not supported - declare a mesh axis for the scope "
            "(MeshTopology.from_axis_dict) and pass axes=...; every reference subgroup "
            "(dp/tp/ep/sp, hpZ secondary, local a2a) is an axis or an axis factoring")
    if axes is None:
        # torch.distributed.new_group() with no args means ALL ranks
        return get_world_group(topology)
    return ProcessGroup(axes, topology)


# ---------------------------------------------------------- named accessors
def get_world_group(topology: Optional[MeshTopology] = None) -> ProcessGroup:
    topo = topology or get_topology()
    return ProcessGroup(tuple(topo.axis_names), topo)


def get_data_parallel_group(topology: Optional[MeshTopology] = None) -> ProcessGroup:
    """dp = data x fsdp (the ZeRO sharding scope)."""
    return ProcessGroup((DATA_AXIS, FSDP_AXIS), topology)


def get_model_parallel_group(topology: Optional[MeshTopology] = None) -> ProcessGroup:
    return ProcessGroup((TENSOR_AXIS, ), topology)


def get_expert_parallel_group(topology: Optional[MeshTopology] = None) -> ProcessGroup:
    return ProcessGroup((EXPERT_AXIS, ), topology)


def get_sequence_parallel_group(topology: Optional[MeshTopology] = None) -> ProcessGroup:
    return ProcessGroup((SEQUENCE_AXIS, ), topology)


def get_pipe_parallel_group(topology: Optional[MeshTopology] = None) -> ProcessGroup:
    return ProcessGroup((PIPE_AXIS, ), topology)
