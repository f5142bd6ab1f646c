"""Phase 12 of ``chip_smoke.py`` (the open-loop front end) in rounds that
alternate the cyclic collector on and off inside the measured loops, on
one CUDA card.  Each load line names its worst batch (latency, host
assembly, whole pump) and the collector's pauses, so a p999 past the
bound can be laid to a collection, a slow assembly or the admit.

    python3 scripts/frontend_tail_ab.py [rounds]     # default 4
"""
import contextlib
import gc
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def collector_on():
    """``chip_smoke.frozen_heap`` without ``gc.disable``."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def main() -> int:
    if not torch.cuda.is_available():
        print("frontend_tail_ab: needs a CUDA device", file=sys.stderr)
        return 1
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    mods = cs.import_port()
    from repro_torch.kernels import build
    build.build_all()
    for name in build.sources():
        build.load(name)
    print(cs.card_line())
    collector_off = cs.frozen_heap
    # an earlier heap of a few million objects, as the full script leaves
    heap = [(i, str(i)) for i in range(2_000_000)]
    dev = torch.device("cuda")
    failed = 0
    for rnd in range(rounds):
        mode = "on" if rnd % 2 == 0 else "off"
        cs.frozen_heap = collector_on if mode == "on" else collector_off
        print(f"=== round {rnd}: collector {mode} in the loops", flush=True)
        t0 = time.perf_counter()
        for kind in cs.FE_LOADS:
            try:
                cs.phase_frontend(mods, dev, kind)
            except cs.CheckFailed as e:
                failed += 1
                print(f"  FAILED ({mode}): {e}", flush=True)
        print(f"  round took {time.perf_counter() - t0:.1f} s", flush=True)
    del heap
    print(f"{failed} failed checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
