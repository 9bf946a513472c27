"""Several cards (counterpart of idgrec_tpu/parallel/): the process group
(`distributed`), the ("data", "model") mesh and its placement rule
(`mesh`), the row-padded storage of the sharded state (`padding`), the
sharded propagation (`spmm_shard`) and the top-k over sharded items
(`topk`): ROADMAP A.9. Importing this package starts no process group."""

from idgrec_torch.parallel.mesh import get_active_mesh, make_mesh, mesh_shape, use_mesh

__all__ = ["get_active_mesh", "make_mesh", "mesh_shape", "use_mesh"]
