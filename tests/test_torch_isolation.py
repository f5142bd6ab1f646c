"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the port's
scripts import neither JAX nor the JAX package, every module of the port
imports and a guardrail admit runs with JAX blocked, and without a CUDA
device the entry points raise instead of falling back to the CPU."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro_torch.core import estimators as est  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.data.pipeline import AceDataFilter  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py", REPO / "scripts" / "kernel_ab.py",
       REPO / "scripts" / "frontend_tail_ab.py",
       REPO / "examples" / "train_lm_ace_monitor_torch.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_port_imports_and_admits_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import numpy as np
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch.serve.engine import Guardrail, GuardrailConfig
        g = Guardrail(GuardrailConfig(d_model=8, num_bits=5, num_tables=4,
                                      warmup_items=4.0), device="cpu")
        e = np.random.default_rng(0).normal(size=(6, 2, 8)).astype("f4")
        mask = g.admit(e)
        assert mask.shape == (6,) and mask.all() and float(g.state.n) == 6
        # the resilience slice too: audit, repair, a CRC'd checkpoint
        import tempfile
        from repro_torch.train import checkpoint as ck
        assert g.health_check().ok and not g.degraded
        g.repair()
        with tempfile.TemporaryDirectory() as d:
            ck.save(d, 1, g.state)
            back, man = ck.CheckpointManager(d).restore_latest(g.state)
        assert man["step"] == 1 and bool((back.counts == g.state.counts).all())
        assert not any(k == "repro" or k.startswith("repro.")
                       for k in sys.modules), "the JAX package was imported"
        print("ISOLATED_OK")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED_OK" in out.stdout


def test_cluster_runs_with_jax_blocked():
    """The cluster (``repro_torch.cluster``) and the narrow projections run
    with JAX and ``ml_dtypes`` blocked: a node serves a chunk, publishes
    its epoch's gossip and a peer reads it back."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["ml_dtypes"] = None
        import numpy as np, torch
        from repro_torch.cluster import (ClusterConfig, ClusterNode,
                                         GossipBus, MemStore)
        from repro_torch.core import srp
        cfg = srp.SrpConfig(dim=8, num_bits=4, num_tables=3)
        assert srp.make_projections(cfg, dtype=torch.bfloat16).dtype \\
            == torch.bfloat16
        store = MemStore()
        node = ClusterNode(ClusterConfig(
            host_id="h0", hosts=("h0", "h1"), num_tenants=4, d_model=6,
            num_bits=5, num_tables=4, chunk_T=2, epoch_chunks=1),
            store, device="cpu")
        t = node.owned()[0]
        feats = np.random.default_rng(0).normal(size=(2, 8, 7))
        _, keeps = node.ingest_chunk(feats.astype("f4"),
                                     np.full((2, 8), t, "i4"))
        epoch, states, _ = GossipBus(store, "h1").latest("h0")
        assert keeps.shape == (2, 8) and epoch == 1
        assert float(states[t].n) == 16.0
        assert not any(k == "repro" or k.startswith("repro.")
                       for k in sys.modules), "the JAX package was imported"
        print("CLUSTER_ISOLATED_OK")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLUSTER_ISOLATED_OK" in out.stdout


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.Guardrail(engine.GuardrailConfig(d_model=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.AceEstimator(sk.AceConfig(dim=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AceDataFilter(d_model=8)
    # asking for the CPU is the one way onto it
    g = engine.Guardrail(engine.GuardrailConfig(d_model=8), device="cpu")
    assert g.state.counts.device.type == "cpu"
    mask = g.admit(np.ones((2, 1, 8), np.float32))
    assert mask.shape == (2,)


def test_train_entry_points_without_cuda_raise(monkeypatch):
    """The training stack defaults to the card as well: the train state,
    the gradient monitor and the launcher raise without one."""
    from repro_torch.launch import train as launcher
    from repro_torch.models.registry import Arch
    from repro_torch.train import fault, train_loop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = Arch("olmo_1b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop.init_train_state(a, train_loop.TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fault.GradMonitor(feature_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "olmo_1b", "--reduced", "--steps", "1"])
    state = train_loop.init_train_state(
        a, train_loop.TrainConfig(device="cpu"))
    assert all(t.device.type == "cpu" for t in
               [*state.params["blocks"][0][0]["mixer"].values(),
                state.step, state.monitor_w, state.filter_w])
