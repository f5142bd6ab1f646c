"""Launchers (port of ``repro.launch``): ``train``, the training launcher.
The reference's ``dryrun`` and ``mesh`` import ``repro.dist`` and come
with it (ROADMAP.md queue 1 item 13)."""
