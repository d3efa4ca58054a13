from evoworld_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh, shard_batch

__all__ = ["Mesh", "init_distributed", "make_mesh", "shard_batch"]
