"""Multi-device execution: meshes of shards, halo-exchange sharded stencils, sharded fits
and statistics.

Counterpart of xdem_tpu/parallel/. One process drives every device of a mesh (a numpy array
of ``torch.device``, one entry per shard; a device may repeat); the collectives move tensors
between cards and add partial results on the mesh's root (``_collectives.py``), and
``parallel.distributed`` extends them across processes with ``torch.distributed``. Users
reach it through ``mesh=`` on the terrain attributes, ``Coreg.fit``, ``CoregPipeline``,
``BlockwiseNuthKaab``, ``estimate_uncertainty`` and the spatial statistics. A ``mesh=``
terrain call returns ``ShardedArray`` planes whose blocks stay on their cards until the
caller assembles them.
"""

from xdem_tpu_torch.parallel.mesh import Mesh, as_mesh_1d, as_mesh_2d, make_mesh
from xdem_tpu_torch.parallel.sharded import ShardedArray, shard
from xdem_tpu_torch.parallel.halo import sharded_stencil, sharded_surface_attributes
from xdem_tpu_torch.parallel.cpd import cpd_em_step_sharded
from xdem_tpu_torch.parallel.neff import weighted_rho_sum_sharded

__all__ = [
    "Mesh",
    "make_mesh",
    "as_mesh_1d",
    "as_mesh_2d",
    "ShardedArray",
    "shard",
    "sharded_stencil",
    "sharded_surface_attributes",
    "cpd_em_step_sharded",
    "weighted_rho_sum_sharded",
]
