"""The mesh and the sharding rules (the counterpart of
``repro.sharding``): ``MeshInfo``, ``make_mesh_info``, the parameter,
activation and cache specs of the model axis (``rules``), the activation
context (``context``) and the placement of blocks on ranks (``place``)."""
from repro_torch.sharding.context import (  # noqa: F401
    activation_spec, current_mesh_info, current_rules, shard, use_rules,
)
from repro_torch.sharding.rules import (  # noqa: F401
    MeshInfo, choose_strategy, make_activation_rules, make_mesh_info,
    make_param_specs,
)
