"""Multi-chip execution: meshes, edge-partitioned graphs, distributed ops."""
from loops_tpu.parallel.dist_ops import DistGCN, DistGraphSAGE, DistSpMM  # noqa: F401
from loops_tpu.parallel.graph_partition import EdgePartition  # noqa: F401
from loops_tpu.parallel.halo import DistSpMMHalo, HaloPlan  # noqa: F401
from loops_tpu.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_mesh_2d,
)
