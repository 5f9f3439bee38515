"""Process meshes on ``torch.distributed`` and the launcher of local
ranks (``launch/mesh.py``)."""

from repro_torch.launch.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    POD_AXIS,
    Mesh,
    make_host_mesh,
    make_lattice_mesh,
    make_mesh,
    mesh_num_devices,
    spawn_ranks,
)

__all__ = [
    "POD_AXIS", "DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh",
    "make_lattice_mesh", "make_host_mesh", "mesh_num_devices", "spawn_ranks",
]
