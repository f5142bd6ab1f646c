"""The port's four examples (``examples/*_torch.py``) against the
reference's (``examples/*.py``), in one process on the same numpy data,
the reference's W carried across (``core.convert.params_from_numpy``).

Every dense hash the port computes in a run is recorded (its
``srp_bits``) and hashed again by the reference on the same rows and W:
the bucket ids must agree on >= 0.999 of (row, table) pairs, the
reference's floor (``tests/test_kernels.py``).  Then the integer figures
(flagged, caught, missed, false flags, per-step anomaly counts, planted
coordinates, the offender, trace counts) are equal, or differ by at most
the number of rows whose ids differ; μ, σ, scores and margins agree
within rtol 1e-5; fleet isolation is bitwise within each package.  The
reference's figures come from its own functions, its chunk summaries
recorded at its one ``jax.device_get`` a chunk.
"""
import contextlib
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import exact_score as jexact_score  # noqa: E402
from repro.core import mean_mu as jmean_mu  # noqa: E402
from repro.core import srp as jsrp  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.pipeline import AceDataFilter as JFilter  # noqa: E402
from repro.fleet import tenant_view as jtenant_view  # noqa: E402
from repro_torch.core import srp as psrp  # noqa: E402
from repro_torch.data.synthetic import make_paper_dataset  # noqa: E402
from repro_torch.kernels import srp_hash as psrp_kernel  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only
    contend with the other test workers' (several times the run time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name: str):
    """``examples/<name>.py`` as a module (examples/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def port_hashes(monkeypatch):
    """Record every dense hash the port computes in the block: a list of
    (rows (N, d), W, K, L, the port's bits (N, K·L))."""
    seen = []
    plain = psrp.srp_bits

    def recorded(x, w, cfg):
        bits = plain(x, w, cfg)
        seen.append((x.detach().float().reshape(-1, x.shape[-1]).numpy()
                     .copy(), w.detach().float().numpy().copy(),
                     cfg.num_bits, cfg.num_tables,
                     bits.reshape(-1, bits.shape[-1]).numpy().copy()))
        return bits

    monkeypatch.setattr(psrp, "srp_bits", recorded)
    monkeypatch.setattr(psrp_kernel, "srp_bits", recorded)
    yield seen


def ids_agree(seen) -> int:
    """The port's recorded ids against the reference's hash of the same
    rows and W: asserts >= 0.999 agreement and returns the number of rows
    with any differing id."""
    assert seen, "the port hashed nothing"
    same = total = rows_differ = 0
    for x, w, K, L, bits in seen:
        cfg = jsrp.SrpConfig(dim=x.shape[1], num_bits=K, num_tables=L)
        want = np.asarray(jsrp.srp_bits(jnp.asarray(x), jnp.asarray(w), cfg))
        eq = (want.reshape(-1, L, K) == bits.reshape(-1, L, K)).all(-1)
        same += int(eq.sum())
        total += eq.size
        rows_differ += int((~eq.all(-1)).sum())
    assert same / total >= 0.999, f"bucket ids agree {same}/{total}"
    return rows_differ


def near(got: int, want: int, slack: int, what: str) -> None:
    assert abs(int(got) - int(want)) <= slack, \
        f"{what}: port {got}, reference {want} ({slack} rows' ids differ)"


def close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               err_msg=what)


@contextlib.contextmanager
def reference_summaries(monkeypatch):
    """The reference's chunk summaries, recorded at ``jax.device_get``."""
    got = []
    fetch = jax.device_get

    def recorded(x):
        out = fetch(x)
        got.append(out)
        return out

    monkeypatch.setattr(jax, "device_get", recorded)
    yield got


def test_quickstart(monkeypatch, capsys):
    """Build, score, μ−σ rule, exact statistic, delete + re-insert, merge
    on the shuttle analogue (seed 0, both packages' bitwise data)."""
    ref, port = _example("quickstart"), _example("quickstart_torch")
    monkeypatch.setattr(ref, "make_paper_dataset",
                        lambda name, n=None: jsyn.make_paper_dataset(
                            name, n=n, seed=0))
    made = []

    class Recorded(ref.AceEstimator):
        def __init__(self, cfg):
            super().__init__(cfg)
            made.append(self)

    monkeypatch.setattr(ref, "AceEstimator", Recorded)
    ref.main()
    ref_out = capsys.readouterr().out
    est = made[0]
    ds = make_paper_dataset("shuttle", n=20_000, seed=0)
    X = jnp.asarray(ds.x)
    with port_hashes(monkeypatch) as seen:
        got = port.run(ds, CPU, w=np.asarray(est.w))
    slack = ids_agree(seen)
    port_out = capsys.readouterr().out

    scores = np.asarray(est.score(X))
    mu, sd = scores.mean(), scores.std()
    flagged = scores < mu - sd
    close(got["scores"], scores, "scores")
    close([got["mu"], got["sd"]], [mu, sd], "mu, sigma")
    near(got["flagged"], flagged.sum(), slack, "flagged")
    near(got["caught"], (flagged & (ds.y == 1)).sum(), slack, "caught")
    close(got["exact"], jexact_score(X[:5], X, 15), "exact S(q, D)")
    close(got["ace"], est.score(X[:5]), "ACE scores")
    close([got["mu_before"], got["mu_after"]],
          [float(jmean_mu(est.state))] * 2, "mu before and after")
    assert got["exact_inverse"] and got["merge_equal"]
    # the printed receipt: the reference's lines, figure for figure
    for pat in (r"flagged (\d+) \((\d+)/(\d+)", r"exact inverse: (\w+)",
                r"bulk build: (\w+)", r"sketch: ([\d.]+) MB"):
        assert re.search(pat, port_out).groups() \
            == re.search(pat, ref_out).groups(), pat


def _fleet_figures(mod, masks):
    tids = np.repeat(np.arange(mod.T), mod.B_PER)
    burst = tids == mod.BURSTY
    caught = sum(int((~masks[i][burst]).sum()) for i in mod.BURST_AT)
    return caught, int((~masks[:, ~burst]).sum())


def test_fleet_serving(monkeypatch, capsys):
    """8 tenants, one admit program: masks, caught bursts, neighbour
    flags, per-tenant sketches and trace counts against the reference;
    isolation bitwise in each package; the port's ``main`` end to end."""
    ref, port = _example("fleet_serving"), _example("fleet_serving_torch")
    rb, rmb = ref.run_stream(bursts=True)
    rc, rmc = ref.run_stream(bursts=False)
    w = np.asarray(rb.w)
    with port_hashes(monkeypatch) as seen:
        pb, pmb = port.run_stream(bursts=True, device=CPU, w=w)
        pc, pmc = port.run_stream(bursts=False, device=CPU, w=w)
    slack = ids_agree(seen)

    for got, want in ((pmb, rmb), (pmc, rmc)):
        near((got != want).sum(), 0, slack, "admit masks")
        for g, r, what in zip(_fleet_figures(port, got),
                              _fleet_figures(ref, want),
                              ("caught", "neighbour flags")):
            near(g, r, slack, what)
    for p, r in ((pb, rb), (pc, rc)):
        assert p.trace_count == r.trace_count == 1
        near((p.state.counts.numpy() != np.asarray(r.state.counts)).sum(),
             0, slack, "fleet counts")
        close(p.state.n, r.state.n, "per-tenant n")
        close(p.state.welford_mean, r.state.welford_mean, "Welford mean")
    for t in range(port.T):
        if t == port.BURSTY:
            continue
        assert port.tenants_equal(pb.state, pc.state, t)
        for a, b in zip(jtenant_view(rb.state, t), jtenant_view(rc.state, t)):
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    burst = np.repeat(np.arange(port.T), port.B_PER) == port.BURSTY
    np.testing.assert_array_equal(pmb[:, ~burst], pmc[:, ~burst])

    capsys.readouterr()
    port.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "trace_count=1" in out and out.rstrip().endswith("OK")


def _stream_figures(summaries, steps, chunk_T, batch, poison):
    """(caught, missed, false flags) of the main stream's summaries."""
    caught = missed = false_pos = 0
    for c, s in zip(range(0, steps, chunk_T), summaries):
        for i, t in enumerate(range(c, c + chunk_T)):
            flagged = int(s.anom_counts[i]) > batch // 2
            caught += t in poison and flagged
            missed += t in poison and not flagged
            false_pos += t not in poison and flagged
    return caught, missed, false_pos


def test_streaming_detection(monkeypatch, capsys):
    """The drifting stream through the flat filter's runner (per-chunk
    n, kept fraction, anomaly counts, top-4 margins) and the drift demo
    (frozen against windowed, pre- and post-shift bursts)."""
    ref = _example("streaming_detection")
    port = _example("streaming_detection_torch")
    with reference_summaries(monkeypatch) as rsum:
        ref.main()
    ref_out = capsys.readouterr().out
    chunks = ref.STEPS // ref.CHUNK_T
    w_main = np.asarray(JFilter(d_model=ref.DIM, num_bits=13,
                                num_tables=40).init()[1])
    w_drift = np.asarray(JFilter(d_model=ref.DIM, num_bits=12,
                                 num_tables=32).init()[1])
    with port_hashes(monkeypatch) as seen:
        got = port.run(CPU, w=w_main)
        drift = port.drift_demo(CPU, w=w_drift)
    slack = ids_agree(seen)

    assert len(rsum) == chunks + 2 * 120 // ref.CHUNK_T
    for p, r in zip(got["summaries"], rsum[:chunks]):
        close(p.n, r.n, "n")
        close(p.kept_frac, r.kept_frac, "kept fraction")
        for i in range(ref.CHUNK_T):
            near(p.anom_counts[i], r.anom_counts[i], slack, "anomalies")
        valid = np.isfinite(np.asarray(r.topk_margin))
        if slack == 0:
            np.testing.assert_array_equal(p.topk_step, r.topk_step)
            np.testing.assert_array_equal(p.topk_item, r.topk_item)
        close(p.topk_margin[valid], np.asarray(r.topk_margin)[valid],
              "top-k margins")
    poison = {t for t in range(ref.STEPS) if t % 10 == 9 and t > 20}
    want = _stream_figures(rsum[:chunks], ref.STEPS, ref.CHUNK_T, ref.BATCH,
                           poison)
    for g, r, what in zip((got["caught"], got["missed"], got["false_pos"]),
                          want, ("caught", "missed", "false flags")):
        near(g, r, slack, what)
    assert got["trace_count"] == 1 and "traced 1x" in ref_out
    for name, (cp, mp, cq, mq, traces) in drift.items():
        line = re.search(rf"{name}\s*: bursts pre-shift (\d+)/(\d+)\s+"
                         r"post-shift \(re-adapted\) (\d+)/(\d+)",
                         ref_out).groups()
        rp, rtot, rq, rqtot = map(int, line)
        near(cp, rp, slack, f"{name} caught pre-shift")
        near(cq, rq, slack, f"{name} caught post-shift")
        assert (cp + mp, cq + mq, traces) == (rtot, rqtot, 1)
    assert drift["frozen"][2] == 0 and drift["windowed"][2] == 4


def test_drift_postmortem(monkeypatch, capsys):
    """The flat and 4-tenant fleet post-mortems: flagged rows, the named
    planted dims, the offender first in the tenant ranking and the exact
    per-tenant drift magnitudes against the reference's."""
    ref = _example("drift_postmortem")
    port = _example("drift_postmortem_torch")
    with reference_summaries(monkeypatch) as rsum:
        ref.main()
    capsys.readouterr()
    flat, fleet = rsum
    w = np.asarray(JFilter(d_model=ref.DIM, num_bits=6, num_tables=16,
                           attr_rows=5, attr_bits=8).init()[1])
    rng = np.random.default_rng(0)
    with port_hashes(monkeypatch) as seen:
        got = port.flat_postmortem(rng, CPU, w=w)
        fgot = port.fleet_postmortem(rng, CPU, w=w)
    slack = ids_agree(seen)

    near(got["flagged"], flat.anom_counts.sum(), slack, "flat flagged")
    near(fgot["flagged"], fleet.anom_counts.sum(), slack, "fleet flagged")
    for named, s in ((got["named"], flat), (fgot["named"], fleet)):
        ref_named = {int(c) for c, v in zip(s.hh_coord, s.hh_valid) if v}
        assert set(named) == ref_named == set(ref.PLANTED)
    assert fgot["tenants"] == [int(t) for t in fleet.hh_tenant]
    assert fgot["tenants"][0] == port.OFFENDER
    assert got["trace_count"] == fgot["trace_count"] == 1
    close(fgot["tenant_drift"], fleet.hh_tenant_est, "tenant drift L2")
