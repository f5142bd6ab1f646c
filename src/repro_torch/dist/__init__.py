"""repro_torch.dist — distributed ACE on ``torch.distributed``: port of
``repro.dist``.

* ``repro_torch.dist.mesh``           meshes (a ``DeviceMesh`` with named
                                      dims, or a shape-only ``MeshShape``),
                                      logical-axis rules, the pspec layouts
                                      of the sketch states.
* ``repro_torch.dist.collectives``    every collective, with a tally of its
                                      bytes by kind.
* ``repro_torch.dist.sketch_parallel`` replicated, table-sharded and
                                      tenant-sharded insert / score / μ,
                                      and ``ShardedSketch``, the hooks the
                                      entry points hand to
                                      ``kernels.ops`` under a mesh.
* ``repro_torch.dist.pipeline``       GPipe over a ``pipe`` axis.
* ``repro_torch.dist.roofline``       the dry run's three-term roofline.

The reference runs each primitive in two modes: explicit ``shard_map``
collectives, and jit/SPMD, where GSPMD places the state and inserts the
collectives.  PyTorch has no GSPMD, so the port has the first mode only:
each rank runs its block, and the collectives are explicit calls of
``collectives``.  The reference's jit/SPMD entry points
(``Guardrail(mesh=…)``, ``StreamRunner(mesh=…)``,
``make_train_step(sketch_layout=…)``) map onto that mode.

``repro.dist.hlo_analysis`` parses compiled HLO text, which a PyTorch
program does not produce: ``collectives.TALLY`` counts the same bytes by
kind as the calls run, on a live mesh or, over a shape-only
``MeshShape``, on ``meta`` without communicating.
``repro_torch.dist.roofline`` reads the dry run's cells
(``repro_torch.launch.dryrun``) at an H100's rates.
"""
from repro_torch.dist import collectives, mesh, pipeline, sketch_parallel  # noqa: F401
from repro_torch.dist.sketch_parallel import (  # noqa: F401
    ShardedSketch, local_histogram, make_shardmap_update,
    make_table_sharded_mean_mu, make_table_sharded_score,
    make_table_sharded_update, score_global, sketch_shardings,
    table_shard_info, table_sharded_mean_mu, table_sharded_shardings,
    update_global,
)
