"""Device-mesh / sharding layer: block rows, frame batches and
correspondences split over CUDA devices (``hive_tpu.parallel``)."""

from hive_tpu_torch.parallel.mesh import (DeviceMesh, get_device_mesh, pad_to_multiple,
                                          replicate, shard_batch, shard_volume)
from hive_tpu_torch.parallel.fusion import (get_mesh_sharded, integrate_frames_sharded,
                                            shard_sparse_state)
