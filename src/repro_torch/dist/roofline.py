"""The three-term (compute / HBM / interconnect) roofline over the dry
run's artifacts (port of ``repro.dist.roofline``).  ROADMAP.md queue 1
item 13's remainder, with ``launch.dryrun``: it raises until then."""
from repro_torch import not_ported


def build_all(results_dir: str):
    not_ported("dist.roofline (the dry run's roofline)", 13)


def format_table(rows) -> str:
    not_ported("dist.roofline (the dry run's roofline)", 13)
