"""The dry run (port of ``repro.launch.dryrun``): every (arch × shape) cell
built on an abstract production mesh, its collectives and roofline
tallied.  ROADMAP.md queue 1 item 13's remainder: it raises until then."""
from repro_torch import not_ported


def run_cell(arch_name: str, shape_name: str, multi_pod: bool):
    not_ported("launch.dryrun (the 40-cell dry run)", 13)


def main(argv=None) -> None:
    not_ported("launch.dryrun (the 40-cell dry run)", 13)


if __name__ == "__main__":
    main()
