"""The device mesh: sharded transform steps over several shards.

The port of transferia_tpu/parallel/: `make_mesh` and
`sharded_transform_step` (mesh.py, kernel K13) and the mesh-sharded
fused mask+filter program (fusedmesh.py, kernel K14).
"""

from transferia_tpu_torch.parallel.mesh import (
    make_mesh,
    sharded_transform_step,
)

__all__ = ["make_mesh", "sharded_transform_step"]
