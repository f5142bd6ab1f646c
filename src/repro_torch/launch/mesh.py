"""Shim: mesh construction and sharding rules live in
``repro_torch.dist.mesh`` (the reference keeps this module as a
re-export too, ``repro.launch.mesh``)."""
from repro_torch.dist.mesh import (  # noqa: F401
    apply_fsdp, fsdp_tree, make_debug_mesh, make_production_mesh, rules_for,
    sanitize_pspec, sharding_tree_for,
)
