"""The port's chaos drill (``scripts/chaos_report_torch.py``) against the
reference's (``scripts/chaos_report.py``), both run in this process on
the same numpy traffic, each writing its report under ``tmp_path``: the
same stages in the same order, every one passing, the same injected and
quarantined counts, the flipped tables ``[1, L-2]`` exactly the masked
ones, the torn step skipped for step 100; and both exit 1 when a stage
fails (a tear of every checkpoint, which no fallback can skip)."""
import importlib.util
import json
import sys
from pathlib import Path

import jax
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

import repro.resilience  # noqa: E402
import repro_torch.resilience  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only
    contend with the other test workers' (several times the run time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name: str):
    """``scripts/<name>.py`` as a module (scripts/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(package: str, out: Path, monkeypatch) -> int:
    """One drill, its report written to ``out``; returns its exit code."""
    if package == "reference":
        monkeypatch.setattr(sys, "argv", ["chaos_report.py", "--json",
                                          str(out)])
        return _script("chaos_report").main()
    return _script("chaos_report_torch").main(["--json", str(out),
                                               "--device", "cpu"])


def test_drill_against_reference(tmp_path, monkeypatch, capsys):
    rc_ref = _run("reference", tmp_path / "ref.json", monkeypatch)
    rc = _run("port", tmp_path / "port.json", monkeypatch)
    assert rc == rc_ref == 0
    ref, got = (json.loads((tmp_path / f).read_text())
                for f in ("ref.json", "port.json"))
    assert [s["stage"] for s in got["stages"]] \
        == [s["stage"] for s in ref["stages"]] \
        == ["baseline", "quarantine", "degrade", "repair",
            "checkpoint_fallback"]
    assert got["ok"] and all(s["ok"] for s in got["stages"])
    assert ref["ok"] and all(s["ok"] for s in ref["stages"])
    stages = [{s["stage"]: s for s in r["stages"]} for r in (got, ref)]
    for key in ("baseline", "quarantine", "checkpoint_fallback"):
        # the same numpy traffic: the same evidence, key for key
        assert stages[0][key] == stages[1][key], key
    assert stages[0]["quarantine"]["injected"] \
        == stages[0]["quarantine"]["quarantined"] > 0
    L = _script("chaos_report_torch").NUM_TABLES
    for s in stages:
        assert s["degrade"]["flipped"] == s["degrade"]["masked"] \
            == [1, L - 2]
        assert s["checkpoint_fallback"]["intact_step"] == 100
        assert set(s["repair"]) == {"stage", "ok", "rewarmed_n"}
    assert got["quarantined_total"] == ref["quarantined_total"]
    assert "admission programs built: 2" in capsys.readouterr().out


@pytest.mark.parametrize("package", ["reference", "port"])
def test_drill_exits_1_when_a_stage_fails(package, tmp_path, monkeypatch):
    """Every checkpoint torn as the drill tears its newest: no intact step
    is left to fall back to, so the last stage fails and the drill exits
    1 with ``ok`` false in its report."""
    rz = repro.resilience if package == "reference" \
        else repro_torch.resilience
    tear = rz.tear_checkpoint

    def tear_all(ckpt_dir, step, **kw):
        for s in (100, step):
            path = tear(ckpt_dir, s, **kw)
        return path

    monkeypatch.setattr(rz, "tear_checkpoint", tear_all)
    out = tmp_path / "report.json"
    assert _run(package, out, monkeypatch) == 1
    report = json.loads(out.read_text())
    last = report["stages"][-1]
    assert not report["ok"] and last["stage"] == "checkpoint_fallback"
    assert not last["ok"] and last["intact_step"] is None
    assert all(s["ok"] for s in report["stages"][:-1])
