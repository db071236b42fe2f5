"""Solver-health diagnostics of the port (`repro_torch.diag`) against the
reference's (`repro.diag`) on the same numpy inputs, case for case with
tests/test_diag.py where a case exists on one card, plus the Lemma 1
helpers of `core.problem` against tests/test_theory.py's.

Tolerances: the host analyses (kkt, forensics, report) take the same
numpy series and must give equal JSON and equal markdown; the engine's
kkt_vec and post-mortem from the reference's partitions rel 1e-5
(float32 sums in another order; for kkt_vec rel 1e-5 of the gradient it
is formed from, so also abs 1e-5 where |g_j +- 1| cancels); safep's rho rel 1e-5 against the
reference's certify and rel 1e-4 against numpy.linalg.eigvalsh, omega,
P_spectral and P_eso exactly.
"""
import json

import numpy as np
import pytest
import torch

import torch_parity as tp_
from repro import obs as jobs
from repro.core import pcdn as jpcdn
from repro.core import problem as jprob
from repro.data import make_classification
from repro.diag import forensics as jforensics
from repro.diag import kkt as jkkt
from repro.diag import report as jreport
from repro.diag import safep as jsafep
from repro.engine import LocalBackend as JLocalBackend
from repro.engine import loop as jloop
from repro_torch import obs as tobs
from repro_torch.core import pcdn as tpcdn
from repro_torch.core import problem as tprob
from repro_torch.diag import forensics as tforensics
from repro_torch.diag import kkt as tkkt
from repro_torch.diag import report as treport
from repro_torch.diag import safep as tsafep
from repro_torch.engine import LocalBackend as TLocalBackend
from repro_torch.engine import bridge
from repro_torch.engine import loop as tloop

ENGINE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a case: under pytest-xdist several workers share
    the machine's cores, and torch's default of a thread a core in each of
    them makes these small problems wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _obs_off():
    """Neither package's telemetry planes leak into (or out of) a case."""
    for o in (jobs, tobs):
        o.disable()
        o.registry.reset()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.registry.reset()


def _jsonable(x):
    return json.loads(json.dumps(x))


def _toy_series():
    return np.array([[1.0, 0.5, 0.0, 2.0],
                     [0.5, 0.0, 0.1, 1.0],
                     [0.2, 0.0, 0.0, 0.6]])


def _random_series(seed):
    rng = np.random.default_rng(seed)
    v = np.abs(rng.standard_normal((6, 40))) * 10.0 ** rng.integers(
        -9, 3, size=(6, 40))
    v[rng.random((6, 40)) < 0.3] = 0.0
    return v


SERIES = {"toy": _toy_series(), "random0": _random_series(0),
          "random1": _random_series(1), "one_row": _random_series(2)[-1]}


def _bundle_series(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 9, size=(5, 7))
    q[rng.random((5, 7)) < 0.2] = -1
    alpha = 0.5 ** q.astype(np.float64)
    alpha[q < 0] = np.nan
    return q, alpha


# ---------------------------------------------------------------------------
# host analyses: equal JSON from the same series


@pytest.mark.parametrize("name", sorted(SERIES))
@pytest.mark.parametrize("tol", [0.0, 1e-3, 0.3])
def test_kkt_analyses_equal_reference(name, tol):
    v = SERIES[name]
    for fn in ("top_offenders", "active_churn"):
        kw = {"tol": tol} if fn == "active_churn" else {"k": 3, "tol": tol}
        assert _jsonable(getattr(tkkt, fn)(v, **kw)) == \
            _jsonable(getattr(jkkt, fn)(v, **kw)), fn
    assert _jsonable(tkkt.violation_histogram(v)) == \
        _jsonable(jkkt.violation_histogram(v))
    assert _jsonable(tkkt.attribution(v, tol=tol, top_k=5)) == \
        _jsonable(jkkt.attribution(v, tol=tol, top_k=5))
    assert tkkt.VIOL_BOUNDS == jkkt.VIOL_BOUNDS


def test_kkt_units_as_in_reference():
    off = tkkt.top_offenders(_toy_series(), k=2, tol=0.0)
    assert [o["feature"] for o in off] == [3, 0]
    assert off[0]["viol_max"] == 2.0 and off[0]["iters_violating"] == 3
    h = tkkt.violation_histogram(_toy_series())
    assert h["zeros"] == 2 and len(h["counts"]) == len(h["bounds"]) + 1
    ch = tkkt.active_churn(_toy_series(), tol=0.3)
    assert ch["n_violating"] == [3, 2, 1] and ch["total_churn"] == 2
    with pytest.raises(ValueError, match="kkt_vec"):
        tkkt.attribution(np.zeros((2, 2, 2)), tol=0.1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forensics_equal_reference(seed):
    q, alpha = _bundle_series(seed)
    assert _jsonable(tforensics.backtrack_heatmap(q)) == \
        _jsonable(jforensics.backtrack_heatmap(q))
    assert _jsonable(tforensics.alpha_trajectory(alpha)) == \
        _jsonable(jforensics.alpha_trajectory(alpha))
    assert tforensics.worst_bundles(q, k=4) == \
        jforensics.worst_bundles(q, k=4)
    assert tforensics.DEEP_Q == jforensics.DEEP_Q


POSTMORTEM_HISTORIES = {
    "growth": ([10.0, 8.0, 9.0, 30.0], [1.0, 0.5, 2.0, 9.0],
               [1.0, 2.0, 5.0, 4.0]),
    "nonfinite_first": ([float("nan")], [float("nan")], [float("nan")]),
    "nonfinite_late": ([5.0, 4.0, float("nan")], [1.0, 0.5, float("nan")],
                       [0.5, 1.5, 3.0]),
}


@pytest.mark.parametrize("name", sorted(POSTMORTEM_HISTORIES))
@pytest.mark.parametrize("with_aux", [False, True])
def test_divergence_postmortem_equal_reference(name, with_aux):
    obj, kkt_s, ls = POSTMORTEM_HISTORIES[name]
    kw = {}
    if with_aux:
        q, alpha = _bundle_series(len(obj))
        kw = dict(bundle_q=q[:len(obj)], bundle_alpha=alpha[:len(obj)])
    got = tforensics.divergence_postmortem(obj, kkt_s, ls, **kw)
    want = jforensics.divergence_postmortem(obj, kkt_s, ls, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], float):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        else:
            assert _jsonable(got[k]) == _jsonable(want[k]), k
    json.dumps(got)


def _fake_report(with_postmortem=True, with_safep=True):
    hist = {"outer_iter": [0, 1, 2], "objective": [3.0, 2.0, 1.5],
            "kkt": [1.0, 0.5, 0.1], "nnz": [20, 15, 12],
            "ls_steps": [0.0, 1.0, 0.5], "wall_time": [0.1, 0.2, 0.3],
            "n_active": [24, 24, 24],
            "bundle_q": [[0, 0], [1, 2], [0, 1]],
            "bundle_alpha": [[1.0, 1.0], [0.5, 0.25], [1.0, 0.5]],
            "kkt_vec": np.abs(np.random.default_rng(0).standard_normal(
                (3, 24))).tolist()}
    rep = {"provenance": {"solver": "pcdn", "P": 8, "tol_kkt": 1e-3,
                          "dataset": "toy"},
           "loss": "logistic", "n_features": 24, "objective": 1.5,
           "converged": True, "nnz": 12, "seconds": 0.3, "history": hist}
    if with_postmortem:
        rep["postmortem"] = jforensics.divergence_postmortem(
            hist["objective"], hist["kkt"], hist["ls_steps"],
            bundle_q=hist["bundle_q"], bundle_alpha=hist["bundle_alpha"])
    if with_safep:
        rep["diag"] = {"safep": {
            "n_samples": 30, "n_features": 24, "rho_normalized": 3.25,
            "power_iters": 1000, "power_converged": False,
            "P_spectral": 7, "omega": 9, "beta_max": 2.0, "P_eso": 3,
            "P_cert": 7}}
    return rep


REPORT_CASES = {
    "full": dict(report=_fake_report()),
    "no_postmortem": dict(report=_fake_report(with_postmortem=False,
                                              with_safep=False),
                          tol_kkt=0.6),
    "path_points": dict(report={"points": [
        {"history": _fake_report()["history"]}], "provenance": {"P": 4}}),
    "metrics_trace": dict(
        metrics_records=[{"ts": "t", "cli": "solve", "metrics": {
            "counters": {"solver.outer_iters": 5}, "gauges": {},
            "histograms": {"solver.iter_seconds": {
                "count": 5, "mean": 0.1, "p50": 0.1, "p99": 0.2,
                "max": 0.2}}}}],
        trace={"traceEvents": [
            {"name": "engine.outer", "ph": "X", "ts": 0, "dur": 1500,
             "pid": 1, "tid": 1},
            {"name": "engine.nonfinite_guard", "ph": "i", "ts": 2}]}),
}


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
def test_report_payload_and_markdown_equal_reference(case):
    kw = REPORT_CASES[case]
    got = treport.build_payload(**json.loads(json.dumps(kw)))
    want = jreport.build_payload(**json.loads(json.dumps(kw)))
    assert _jsonable(got) == _jsonable(want)
    assert treport.render_markdown(got) == jreport.render_markdown(want)


def test_report_cli_renders_sections(tmp_path):
    p = tmp_path / "report.json"
    p.write_text(json.dumps(_fake_report()))
    out = tmp_path / "health.md"
    assert treport.main(["--report", str(p), "-o", str(out)]) == 0
    md = out.read_text()
    for section in ("# Solver health report", "## Run summary",
                    "## Convergence", "## Top KKT offenders",
                    "## Backtrack forensics", "## Divergence post-mortem",
                    "## Certified parallelism"):
        assert section in md, f"missing {section}"
    ref_out = tmp_path / "ref.md"
    assert jreport.main(["--report", str(p), "-o", str(ref_out)]) == 0
    assert md == ref_out.read_text()
    with pytest.raises(SystemExit) as exc:
        treport.main([])
    assert exc.value.code == 2


def test_report_cli_recomputes_certified_p_from_a_dataset(tmp_path):
    """--dataset builds the design on --device and renders the same
    certified-P table as the reference's CLI (a libsvm file)."""
    from repro.data import save_libsvm
    X, y, _ = make_classification(60, 30, sparsity=0.7, seed=4)
    data = tmp_path / "d.svm"
    save_libsvm(str(data), X, y)
    mds = []
    for main, extra in ((treport.main, ["--device", "cpu"]),
                        (jreport.main, [])):
        out = tmp_path / f"h{len(mds)}.md"
        assert main(["--dataset", str(data), "--layout", "padded_csc",
                     "-o", str(out)] + extra) == 0
        mds.append(out.read_text())
    assert "## Certified parallelism" in mds[0]
    assert mds[0] == mds[1]


def test_diag_package_exports():
    from repro_torch import diag
    assert diag.report is treport
    assert diag.build_payload is treport.build_payload
    assert diag.certify is tsafep.certify
    with pytest.raises(AttributeError):
        diag.nothing_here


# ---------------------------------------------------------------------------
# the engine's kkt_vec harvest and post-mortem, from the reference's
# partitions


def _engine_pair(layout, guard_at=None, max_outer=4, P=16):
    """One record_aux + record_kkt_vec run of each engine loop; the port
    is fed the partitions the reference drew. -> (ref result, port
    result)."""
    jp, tp = tp_.problems(layout, seed=3, s=300, n=80)
    kw = dict(P=P, seed=0, record_aux=True, record_kkt_vec=True,
              ls_scope="full")
    jb = JLocalBackend(jp, jpcdn.PCDNConfig(**kw))
    tb = TLocalBackend(tp, tpcdn.PCDNConfig(**kw))
    parts = []

    def jouter(w, z, key, active, recheck, c):
        parts.append(tp_.reference_partition(key, np.asarray(active), P,
                                             False)[0])
        return jb.outer(w, z, key, active, recheck, c)

    def touter(w, z, gen, active, recheck, c):
        idxs = bridge.partition_from_numpy(parts[touter.k], device="cpu")
        touter.k += 1
        return tb.outer(w, z, gen, active, recheck, c, idxs=idxs)
    touter.k = 0

    def guard():
        calls = []

        def g(f):
            calls.append(f)
            return guard_at is not None and len(calls) > guard_at
        return g

    _, jres = jloop.run_outer_loop(jouter, jb.init_state(), 2.0,
                                   max_outer=max_outer, tol_kkt=0.0,
                                   divergence_guard=guard())
    _, tres = tloop.run_outer_loop(touter, tb.init_state(), 2.0,
                                   max_outer=max_outer, tol_kkt=0.0,
                                   divergence_guard=guard())
    return jres, tres


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_engine_kkt_vec_matches_reference(layout):
    jres, tres = _engine_pair(layout)
    jh, th = jres.history, tres.history
    assert th.kkt_vec.shape == jh.kkt_vec.shape == (4, 80)
    # viol_j = |g_j +- 1| where w_j != 0: rel 1e-5 of g (|g_j| ~ 1 there)
    # is an absolute 1e-5 of viol
    np.testing.assert_allclose(th.kkt_vec, jh.kkt_vec, rtol=ENGINE_RTOL,
                               atol=ENGINE_RTOL)
    np.testing.assert_allclose(th.kkt_vec.max(axis=1), th.kkt, rtol=1e-6)
    np.testing.assert_array_equal(th.bundle_q, jh.bundle_q)
    attr_t = tkkt.attribution(th.kkt_vec, tol=1e-3)
    attr_j = jkkt.attribution(jh.kkt_vec, tol=1e-3)
    assert [o["feature"] for o in attr_t["offenders"]] == \
        [o["feature"] for o in attr_j["offenders"]]


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_engine_postmortem_on_guard_trip_matches_reference(layout):
    jres, tres = _engine_pair(layout, guard_at=2, max_outer=8)
    assert jres.diverged and tres.diverged and not tres.converged
    assert tres.n_outer == jres.n_outer == 3
    jp, tp = jres.postmortem, tres.postmortem
    assert tp is not None and sorted(tp) == sorted(jp)
    assert tp["trip_iter"] == jp["trip_iter"] == 2
    for k in ("objective_at_onset", "objective_at_trip", "kkt_at_trip",
              "deepest_mean_q", "alpha_floor"):
        np.testing.assert_allclose(tp[k], jp[k], rtol=ENGINE_RTOL,
                                   atol=1e-6)
    assert tp["heatmap"] == _jsonable(jp["heatmap"])
    assert tp["worst_bundles"] == jp["worst_bundles"]


def test_postmortem_instant_on_the_trace(tmp_path):
    """A trip emits the `engine.divergence_postmortem` instant with the
    two load-bearing keys."""
    tobs.enable(metrics=False, trace_=True)
    _, tres = _engine_pair("padded_csc", guard_at=1, max_outer=4)
    path = tmp_path / "t.json"
    tobs.trace.save(str(path))
    events = json.load(open(path))["traceEvents"]
    pm = [e for e in events if e["name"] == "engine.divergence_postmortem"]
    assert len(pm) == 1
    assert pm[0]["args"]["objective_growth"] == \
        tres.postmortem["objective_growth"]
    assert "deepest_mean_q" in pm[0]["args"]


def test_synthetic_guard_trip_postmortem():
    """The reference's synthetic-outer case, on the port's loop."""
    n, b = 8, 2
    objectives = iter([3.0, 2.0, 5.0, 50.0])

    def outer(w, z, gen, active, recheck, c):
        f = next(objectives)
        q = torch.full((b,), 4, dtype=torch.int32)
        alpha = torch.full((b,), 0.0625)
        viol = torch.full((n,), 0.5)
        return (w, z, gen, torch.tensor(f), torch.tensor(9.0),
                torch.tensor(n), torch.tensor(4.0), active,
                torch.tensor(n), (q, alpha), viol)

    state = tloop.EngineState(w=torch.zeros(n), z=torch.zeros(4),
                              gen=torch.Generator(),
                              active=torch.ones(n, dtype=torch.bool))
    _, res = tloop.run_outer_loop(outer, state, 1.0, max_outer=10,
                                  tol_kkt=1e-12,
                                  divergence_guard=lambda f: f > 10.0)
    assert res.diverged and not res.converged
    pm = res.postmortem
    assert pm["trip_iter"] == 3 and pm["onset_iter"] == 1
    assert pm["objective_growth"] == pytest.approx(48.0)
    assert "heatmap" in pm and "alpha" in pm
    assert res.history.kkt_vec is not None
    json.dumps(pm)


# ---------------------------------------------------------------------------
# certified safe parallelism


def _designs(s, n, sparsity, seed=7):
    X, y, _ = make_classification(s, n, sparsity=sparsity, seed=seed)
    for layout in ("dense", "padded_csc"):
        yield (layout, X, jprob.make_problem(X, y, c=1.0, layout=layout),
               tprob.make_problem(X, y, c=1.0, layout=layout, device="cpu"))


def _rho_direct(X):
    Xd = np.asarray(X, np.float64)
    norms = np.linalg.norm(Xd, axis=0)
    norms[norms == 0] = 1.0
    Xn = Xd / norms
    return float(np.linalg.eigvalsh(Xn.T @ Xn).max())


@pytest.mark.parametrize("s,n,sparsity", [(60, 40, 0.0), (80, 50, 0.9)])
def test_power_iteration_matches_eigvalsh(s, n, sparsity):
    for layout, X, _, tp in _designs(s, n, sparsity):
        got = tsafep.power_iteration_rho(tp.design, n_iter=3000)
        assert got["converged"], layout
        assert got["rho"] == pytest.approx(_rho_direct(X), rel=1e-4), layout


@pytest.mark.parametrize("s,n,sparsity,seed", [(60, 40, 0.0, 7),
                                               (80, 50, 0.9, 7),
                                               (120, 64, 0.8, 3)])
def test_certify_matches_reference(s, n, sparsity, seed):
    for layout, X, jp, tp in _designs(s, n, sparsity, seed):
        got = tsafep.certify(tp.design, observed_p=8)
        want = jsafep.certify(jp.design, observed_p=8)
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose(got["rho_normalized"],
                                   want["rho_normalized"], rtol=1e-5)
        for k in ("omega", "P_spectral", "P_eso", "P_cert", "n_samples",
                  "n_features", "observed_P", "beta_max"):
            assert got[k] == want[k], (layout, k)
        assert got["P_cert"] == max(got["P_spectral"], got["P_eso"])
        json.dumps(got)


def test_omega_row_support_both_layouts():
    X, y, _ = make_classification(50, 30, sparsity=0.9, seed=3)
    direct = int(np.max(np.sum(np.asarray(X) != 0, axis=1)))
    for layout in ("dense", "padded_csc"):
        tp = tprob.make_problem(X, y, c=1.0, layout=layout, device="cpu")
        assert tsafep.omega_row_support(tp.design) == direct


def test_omega_skips_explicit_zeros_and_sentinels():
    """A stored zero couples nothing; sentinel rows are padding."""
    d = bridge.design_from_numpy(
        col_rows=np.array([[0, 1, 3], [0, 3, 3], [1, 2, 3]], np.int32),
        col_vals=np.array([[1.0, 0.0, 0.0], [2.0, 0.0, 0.0],
                           [1.0, 1.0, 0.0]], np.float32),
        shape=(3, 3), device="cpu")
    assert tsafep.omega_row_support(d) == 2   # row 0: features 0, 1


def test_eso_and_spectral_edge_cases():
    for mod in (tsafep, jsafep):
        assert mod.eso_safe_p(omega=1, n_features=64) == 64
        assert mod.eso_safe_p(omega=0, n_features=64) == 64
        assert mod.eso_safe_p(omega=5, n_features=1) == 1
        assert mod.eso_safe_p(omega=64, n_features=64) == 2
        assert mod.spectral_safe_p(rho=1.0, n_features=64) == 64
        assert mod.spectral_safe_p(rho=64.0, n_features=64) == 1
        assert mod.spectral_safe_p(rho=0.0, n_features=64) == 64
    for omega in (2, 7, 30, 200):
        for beta in (1.5, 2.0, 4.0):
            assert tsafep.eso_safe_p(omega, 500, beta) == \
                jsafep.eso_safe_p(omega, 500, beta)


def test_power_iteration_zero_design():
    d = bridge.design_from_numpy(X=np.zeros((5, 4)), device="cpu")
    got = tsafep.power_iteration_rho(d)
    assert got == {"rho": 0.0, "n_iter": 1, "converged": True}


# ---------------------------------------------------------------------------
# Lemma 1 helpers of core.problem (tests/test_theory.py's uses)


LAMS = [np.sort(np.random.default_rng(s).uniform(0.01, 100.0, size=m))
        for s, m in ((0, 3), (1, 17), (2, 40))]


@pytest.mark.parametrize("i", range(len(LAMS)))
def test_lemma1a_matches_reference_and_is_monotone(i):
    lam = LAMS[i]
    n = lam.shape[0]
    prev = None
    for P in range(1, n + 1):
        got = tprob.expected_max_of_sample(lam, P)
        assert got == pytest.approx(jprob.expected_max_of_sample(lam, P),
                                    rel=1e-12)
        if prev is not None:
            assert got >= prev - 1e-9
            assert got / P <= prev / (P - 1) + 1e-9
        prev = got
    with pytest.raises(ValueError, match="out of"):
        tprob.expected_max_of_sample(lam, n + 1)


def test_lemma1a_constant_when_equal():
    lam = np.full(20, 3.7)
    for P in (1, 5, 20):
        assert abs(tprob.expected_max_of_sample(lam, P) - 3.7) < 1e-12


def test_lemma1a_matches_monte_carlo():
    rng = np.random.default_rng(0)
    lam = np.sort(rng.uniform(0.1, 5.0, size=12))
    analytic = tprob.expected_max_of_sample(lam, 4)
    draws = [lam[rng.choice(12, 4, replace=False)].max()
             for _ in range(20000)]
    assert abs(analytic - np.mean(draws)) < 0.02


def test_theorem2_bound_with_expected_max_column_norm():
    """tests/test_theory.py's Theorem 2 check on the port's solves, with
    E[lambda_bar] from `expected_max_column_norm` equal to the
    reference's."""
    from repro.core import expected_max_column_norm as j_emcn
    from repro_torch.core import expected_max_column_norm as t_emcn
    from repro_torch.core.linesearch import ArmijoParams
    X, y, _ = make_classification(300, 120, sparsity=0.5, corr=0.5, seed=3)
    jp = jprob.make_problem(X, y, c=1.0)
    tp = tprob.make_problem(X, y, c=1.0, device="cpu")
    ap = ArmijoParams()
    lam = tp.column_norms_sq().double().numpy()
    theta, c = 0.25, 1.0
    h_lo = 1e-4 * c * lam.min()
    for P in (8, 60, 120):
        e_lam = t_emcn(tp, P)
        assert e_lam == pytest.approx(j_emcn(jp, P), rel=1e-6)
        res = tpcdn.solve(tp, tpcdn.PCDNConfig(P=P, max_outer=10))
        bound = (1 + np.log(theta * c / (2 * h_lo * (1 - ap.sigma))) /
                 np.log(1 / ap.beta)
                 + 0.5 * np.log(P) / np.log(1 / ap.beta)
                 + np.log(e_lam) / np.log(1 / ap.beta))
        assert res.history.ls_steps.mean() <= bound, (P, bound)
