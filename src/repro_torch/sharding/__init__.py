"""The mesh record the protocols read (the counterpart of
``repro.sharding``): ``MeshInfo`` and ``make_mesh_info``. The parameter and
activation specs of the model axis are not ported: the port's mesh has
client axes only."""
from repro_torch.sharding.rules import MeshInfo, make_mesh_info  # noqa: F401
