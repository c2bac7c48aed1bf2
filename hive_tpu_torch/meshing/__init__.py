"""Triangle-mesh data structures and glTF export (host side)."""

from hive_tpu_torch.meshing.mesh import Scene, TriangleMesh
