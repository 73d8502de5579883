from .mesh import (ALL_AXES, DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, PIPE_AXIS, SEQUENCE_AXIS, TENSOR_AXIS,
                   MeshTopology, get_topology, reset_topology, set_topology)
