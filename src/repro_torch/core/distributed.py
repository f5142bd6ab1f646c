"""Shim: the distributed ACE primitives live in
``repro_torch.dist.sketch_parallel`` (the reference keeps this module as
a re-export too, ``repro.core.distributed``)."""
from repro_torch.dist.sketch_parallel import (  # noqa: F401
    local_histogram, make_shardmap_update, make_table_sharded_mean_mu,
    make_table_sharded_score, make_table_sharded_update, mean_mu_table_sharded,
    score_global, score_table_sharded, sketch_shardings,
    table_sharded_shardings, update_global, update_table_sharded,
)
