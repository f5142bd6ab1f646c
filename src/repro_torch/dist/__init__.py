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

The reference runs each primitive in two modes: explicit ``shard_map``
collectives, and jit/SPMD, where GSPMD places the state and inserts the
collectives.  PyTorch has no GSPMD, so the port has the first mode only:
each rank runs its block, and the collectives are explicit calls of
``collectives``.  The reference's jit/SPMD entry points
(``Guardrail(mesh=…)``, ``StreamRunner(mesh=…)``,
``make_train_step(sketch_layout=…)``) map onto that mode.

Left out: ``repro.dist.hlo_analysis`` parses compiled HLO text, which a
PyTorch program does not produce; ``collectives.TALLY`` counts the same
bytes by kind as the calls run.  ``repro.dist.roofline``, with the dry
run (``launch.dryrun``) it reads, is ROADMAP.md queue 1 item 13's
remainder.
"""
from repro_torch.dist import collectives, mesh, pipeline, sketch_parallel  # noqa: F401
from repro_torch.dist.sketch_parallel import (  # noqa: F401
    ShardedSketch, local_histogram, make_shardmap_update,
    make_table_sharded_mean_mu, make_table_sharded_score,
    make_table_sharded_update, score_global, sketch_shardings,
    table_shard_info, table_sharded_mean_mu, table_sharded_shardings,
    update_global,
)
