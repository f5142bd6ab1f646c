"""Heavy-hitter attribution — signed count-sketch planes and the dyadic
findHH drill-down (port of ``repro.attribution``); see
``repro_torch.attribution.sketch``.  Its point estimates and its
drill-down run on the two kernels of ``csrc/attr_estimate.cu``
(``repro_torch.kernels.ops.attr_estimate`` and ``attr_find_hh``).
"""
from repro_torch.attribution.sketch import (AttrConfig, AttrTables,
                                            chunk_energy, chunk_planes,
                                            drift_vector, estimate,
                                            estimate_level, find_hh,
                                            init_plane, l2estimate,
                                            level_tables, make_tables,
                                            observe_flat, observe_fleet,
                                            observe_fleet_window,
                                            observe_window, sketch_vector,
                                            sketch_vectors, tenant_drift_l2)

__all__ = [
    "AttrConfig", "AttrTables", "chunk_energy", "chunk_planes",
    "drift_vector", "estimate", "estimate_level", "find_hh", "init_plane",
    "l2estimate", "level_tables", "make_tables", "observe_flat",
    "observe_fleet", "observe_fleet_window", "observe_window",
    "sketch_vector", "sketch_vectors", "tenant_drift_l2",
]
