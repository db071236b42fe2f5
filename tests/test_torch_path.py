"""Regularization paths of the port (`repro_torch.path`, `launch.path`,
`serve.ovr`) against the reference (`repro.path`), on the CPU.

The packages draw their bundle partitions from different generators
(jax.random against torch.Generator), so whole solves meet only where
both converge: each point's F to rel 1e-3 at KKT tol 1e-3 (the f32
plateau and the order of the sums, ROADMAP Queue 3), and the same best
index. The c-grid equals the reference's exactly; c_max matches to rel
1e-6. Within the port, the batch solver equals a loop of solo solves from
the same seeds (rel 1e-5; on the CPU it is bit-equal) and a warm sweep
matches cold solves, as tests/test_path.py holds the reference.
"""
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import PCDNConfig as JPCDNConfig
from repro.core import make_problem as jmake_problem
from repro.core.problem import validation_accuracy as jvalidation_accuracy
from repro.data import make_classification
from repro.path import PathConfig as JPathConfig
from repro.path import c_grid as jc_grid
from repro.path import run_path as jrun_path
from repro.path import solve_batch as jsolve_batch
from repro_torch import obs
from repro_torch.core import PCDNConfig, make_problem, pcdn
from repro_torch.core.problem import validation_accuracy
from repro_torch.engine import LocalBackend
from repro_torch.engine import loop as tloop
from repro_torch.path import (PathConfig, PathPoint, c_grid, pick_best,
                              problem_grid, run_path, solve_batch)

S, N = 300, 192
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _obs_off():
    for o in (obs, jobs):
        o.disable()
        o.registry.reset()
    yield
    for o in (obs, jobs):
        o.disable()
        o.registry.reset()


@pytest.fixture(scope="module")
def data():
    return make_classification(S, N, sparsity=0.9, corr=0.3, seed=0)


@pytest.fixture(scope="module")
def val():
    X, y, _ = make_classification(120, N, sparsity=0.9, corr=0.3, seed=5)
    return X, y


class _FixedCmax(LocalBackend):
    """The port's backend with the reference's c_max, so both sweeps run
    on the same grid."""

    def __init__(self, problem, cfg, c_max):
        super().__init__(problem, cfg)
        self._c_max = c_max

    def c_max(self):
        return self._c_max


# -- the grid --------------------------------------------------------------------

@pytest.mark.parametrize("c_max,c_final,n_points,span", [
    (0.5, None, 5, 16.0), (0.0123, None, 20, 100.0), (1.7, 3.4, 2, 100.0),
    (0.02937, 2.9377, 8, 100.0)])
def test_c_grid_equals_reference(c_max, c_final, n_points, span):
    got = c_grid(c_max, c_final=c_final, n_points=n_points, span=span)
    want = jc_grid(c_max, c_final=c_final, n_points=n_points, span=span)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(c_max=0.5, c_final=0.4),
                                dict(c_max=-1.0), dict(c_max=1.0,
                                                      n_points=1)])
def test_c_grid_refuses_like_reference(kw):
    for fn in (c_grid, jc_grid):
        with pytest.raises(ValueError):
            fn(**kw)


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_c_max_matches_reference(data, layout):
    X, y, _ = data
    jp = jmake_problem(X, y, c=1.0, layout=layout)
    tp = make_problem(X, y, c=1.0, layout=layout, **CPU)
    assert tp.c_max() == pytest.approx(jp.c_max(), rel=1e-6)
    assert LocalBackend(tp, PCDNConfig(P=16)).c_max() == tp.c_max()
    np.testing.assert_allclose(problem_grid(tp, n_points=6, span=20.0),
                               jc_grid(jp.c_max(), n_points=6, span=20.0),
                               rtol=1e-6)


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_validation_accuracy_matches_reference(data, val, layout):
    X, y, _ = data
    Xv, yv = val
    w = np.where(np.random.default_rng(0).random(N) < 0.2, 0.3, 0.0)
    got = validation_accuracy(make_problem(Xv, yv, 1.0, layout=layout,
                                           **CPU).design, yv, w)
    assert got == jvalidation_accuracy(Xv, yv, w)
    assert validation_accuracy(Xv, yv, w, device="cpu") == got


def test_with_labels(data):
    X, y, _ = data
    tp = make_problem(X, y, c=1.0, **CPU)
    y2 = -tp.y
    tp2 = tp.with_labels(y2)
    assert tp2.design is tp.design and torch.equal(tp2.y, y2)
    assert tp2.c == tp.c


# -- the sweep ------------------------------------------------------------------

SWEEP_CASES = [("dense", "full", False), ("padded_csc", "full", True),
               ("padded_csc", "support", True)]


@pytest.mark.parametrize("layout,scope,use_kernels", SWEEP_CASES)
def test_sweep_matches_reference(data, val, layout, scope, use_kernels):
    X, y, _ = data
    Xv, yv = val
    kw = dict(P=16, max_outer=200, tol_kkt=1e-3, ls_scope=scope, seed=0)
    jp = jmake_problem(X, y, c=1.0, layout=layout)
    jres = jrun_path(jp, JPathConfig(solver=JPCDNConfig(**kw), n_points=5,
                                     span=20.0), val_design=Xv, val_y=yv)
    tp = make_problem(X, y, c=1.0, layout=layout, **CPU)
    tcfg = PCDNConfig(use_kernels=use_kernels, record_aux=True, **kw)
    tres = run_path(None, PathConfig(solver=tcfg, n_points=5, span=20.0),
                    val_design=Xv, val_y=yv,
                    backend=_FixedCmax(tp, tcfg, jres.c_max))
    assert np.array_equal(tres.cs, jres.cs)
    assert tres.weights.shape == jres.weights.shape == (5, N)
    for tpt, jpt in zip(tres.points, jres.points):
        assert tpt.converged and jpt.converged
        assert tpt.kkt <= 1e-3
        assert tpt.objective == pytest.approx(jpt.objective, rel=1e-3)
        assert tpt.val_accuracy is not None and tpt.seconds > 0
    # the c_max anchor: one iteration; on padded-CSC both packages' rounding
    # lets it hold a feature at ~1e-7 (all-zero on dense: the next test)
    assert tres.points[0].n_outer == 1
    assert tres.points[0].nnz == jres.points[0].nnz
    assert tres.best_index == jres.best_index is not None
    assert tres.last_history.bundle_q is not None


def test_warm_path_matches_cold_solves(data):
    """tests/test_path.py's check of the reference, on the port."""
    X, y, _ = data
    tp = make_problem(X, y, c=1.0, **CPU)
    cfg = PathConfig(solver=PCDNConfig(P=64, max_outer=150, tol_kkt=1e-5),
                     n_points=5, span=20.0)
    res = run_path(tp, cfg)
    assert all(p.converged for p in res.points)
    assert res.points[0].nnz == 0              # the c_max anchor
    for i, c in enumerate(res.cs):
        cold = pcdn.solve(make_problem(X, y, c=float(c), **CPU),
                          PCDNConfig(P=64, max_outer=300, tol_kkt=1e-5))
        assert cold.converged
        np.testing.assert_allclose(res.weights[i], cold.w.numpy(),
                                   atol=2e-3)
        assert res.points[i].objective == pytest.approx(cold.objective,
                                                        rel=1e-5)


def test_cold_sweep_and_shrink_sweep(data):
    X, y, _ = data
    tp = make_problem(X, y, c=1.0, layout="padded_csc", **CPU)
    base = dict(P=32, max_outer=200, tol_kkt=1e-3)
    runs = {}
    for name, warm, shrink in (("warm", True, False), ("cold", False, False),
                               ("shrink", True, True)):
        runs[name] = run_path(tp, PathConfig(
            solver=PCDNConfig(shrink=shrink, **base), n_points=4, span=10.0,
            warm_start=warm))
    assert all(r.points[0].n_outer == 1 for r in runs.values())
    for name in ("cold", "shrink"):
        for a, b in zip(runs[name].points, runs["warm"].points):
            assert a.converged and a.objective == pytest.approx(
                b.objective, rel=1e-3)
    # warm starting pays: fewer outer iterations over the sweep than cold
    assert sum(p.n_outer for p in runs["warm"].points) <= \
        sum(p.n_outer for p in runs["cold"].points)


def test_path_telemetry(data):
    X, y, _ = data
    tp = make_problem(X, y, c=1.0, layout="padded_csc", **CPU)
    obs.enable(metrics=True, trace_=True)
    res = run_path(tp, PathConfig(solver=PCDNConfig(
        P=16, max_outer=100, record_aux=True, use_kernels=True,
        ls_scope="support"), n_points=3, span=10.0))
    snap = obs.registry.get_registry().snapshot()
    n_outer = sum(p.n_outer for p in res.points)
    assert snap["counters"]["path.points"] == 3.0
    assert snap["counters"]["solver.outer_iters"] == n_outer
    b = -(-N // 16)
    assert snap["counters"]["kernels.pcdn_bundle.launches"] == n_outer * b
    hq = snap["histograms"]["solver.bundle_q"]
    assert hq["count"] == n_outer * b and hq["min"] >= 1 and hq["max"] <= 40
    events = obs.trace.get_tracer().to_dict()["traceEvents"]
    points = [e for e in events if e["name"] == "path.point"]
    assert [e["args"]["i"] for e in points] == [0, 1, 2]
    obs.validate_trace({"traceEvents": events})
    jobs.validate_trace({"traceEvents": events})


def test_pick_best_ties_go_to_the_sparser():
    def pt(acc, nnz):
        return PathPoint(c=1.0, objective=0.0, nnz=nnz, kkt=0.0, n_outer=1,
                         seconds=None, converged=True, val_accuracy=acc)
    assert pick_best([pt(0.8, 5), pt(0.9, 9), pt(0.9, 3), pt(0.9, 3)]) == 2
    assert pick_best([pt(None, 1)]) is None


@pytest.mark.parametrize("kw", [dict(ckpt="solve kind"), dict(resume=True),
                                dict(fault_plan="crash_at_point")])
def test_run_path_refuses_fault_arguments(data, kw, tmp_path):
    """run_path takes the reference's fault arguments and refuses what the
    reference refuses: a solve checkpoint in a sweep's directory, a resume
    onto another c-grid, and (the plan's own refusal to go on) a planned
    crash right after a point's checkpoint commits."""
    from repro_torch import fault
    X, y, _ = data
    tp = make_problem(X, y, c=1.0, **CPU)
    cfg = PathConfig(solver=PCDNConfig(P=16), n_points=2)
    ck = fault.SolveCheckpointer(str(tmp_path / "ck"))
    if "ckpt" in kw:
        backend = LocalBackend(tp, cfg.solver)
        ck.save_solve(backend, backend.init_state(), outer_iter=0)
        with pytest.raises(ValueError, match="separate --ckpt-dir"):
            run_path(tp, cfg, ckpt=ck, resume=True)
    elif "resume" in kw:
        run_path(tp, cfg, ckpt=ck)
        with pytest.raises(ValueError, match="different c-grid"):
            run_path(tp, PathConfig(solver=PCDNConfig(P=16), n_points=3),
                     ckpt=ck, **kw)
    else:
        with pytest.raises(fault.InjectedCrash, match="path point 0"):
            run_path(tp, cfg, ckpt=ck,
                     fault_plan=fault.FaultPlan(crash_at_point=0))
        assert ck.manager.steps() == [0]


def test_run_path_argument_checks(data, val):
    X, y, _ = data
    with pytest.raises(ValueError, match="problem or a backend"):
        run_path(None, PathConfig())
    tp = make_problem(X, y, c=1.0, **CPU)
    with pytest.raises(ValueError, match="both val_design"):
        run_path(tp, PathConfig(), val_design=val[0])


# -- the batch solver -------------------------------------------------------------

@pytest.mark.parametrize("layout,scope,use_kernels", SWEEP_CASES)
def test_batch_equals_solo_solves(data, layout, scope, use_kernels):
    X, y, _ = data
    tp = make_problem(X, y, c=1.0, layout=layout, **CPU)
    cfg = PCDNConfig(P=16, max_outer=60, tol_kkt=1e-3, ls_scope=scope,
                     use_kernels=use_kernels)
    cs = problem_grid(tp, n_points=4, span=20.0)
    rng = np.random.default_rng(1)
    ys = np.where(rng.random((4, S)) < 0.2, -1.0, 1.0) * y[None, :]
    seeds = [0, 3, 7, 11]
    res = solve_batch(tp, cfg, cs, ys=ys, seeds=seeds)
    for i in range(4):
        solo = pcdn.solve(tp.with_c(cs[i]).with_labels(
            torch.tensor(ys[i], dtype=torch.float32)),
            PCDNConfig(P=16, max_outer=60, tol_kkt=1e-3, ls_scope=scope,
                       use_kernels=use_kernels, seed=seeds[i]))
        assert float(res.objective[i]) == pytest.approx(solo.objective,
                                                        rel=1e-5)
        assert int(res.n_outer[i]) == solo.n_outer
        assert bool(res.converged[i]) == solo.converged
        np.testing.assert_allclose(res.w[i].numpy(), solo.w.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert int(res.nnz[i]) == int(torch.sum(solo.w != 0))
    np.testing.assert_allclose(res.z.numpy(),
                               np.stack([tp.margins(res.w[i]).numpy()
                                         for i in range(4)]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_batch_matches_reference_batch(data, layout):
    X, y, _ = data
    jp = jmake_problem(X, y, c=1.0, layout=layout)
    tp = make_problem(X, y, c=1.0, layout=layout, **CPU)
    cs = jc_grid(jp.c_max(), n_points=4, span=20.0)
    kw = dict(P=16, max_outer=200, tol_kkt=1e-3)
    jres = jsolve_batch(jp, JPCDNConfig(**kw), cs)
    tres = solve_batch(tp, PCDNConfig(**kw), cs)
    assert bool(torch.all(tres.converged)) and bool(jnp.all(jres.converged))
    np.testing.assert_allclose(tres.objective.numpy(),
                               np.asarray(jres.objective), rtol=1e-3)
    assert bool(torch.all(tres.kkt <= 1e-3))


def test_batch_warm_start_and_refusals(data):
    X, y, _ = data
    tp = make_problem(X, y, c=1.0, **CPU)
    cs = problem_grid(tp, n_points=3, span=10.0)
    cfg = PCDNConfig(P=16, max_outer=100, tol_kkt=1e-3)
    first = solve_batch(tp, cfg, cs)
    again = solve_batch(tp, cfg, cs, w0=first.w.numpy())
    assert torch.all(again.n_outer <= 2)
    np.testing.assert_allclose(again.objective.numpy(),
                               first.objective.numpy(), rtol=1e-3)
    with pytest.raises(ValueError, match="shrinking"):
        solve_batch(tp, PCDNConfig(P=16, shrink=True), cs)
    with pytest.raises(ValueError, match="seeds"):
        solve_batch(tp, cfg, cs, seeds=[0])
    with pytest.raises(ValueError, match="ys must be"):
        solve_batch(tp, cfg, cs, ys=np.ones((2, S)))


def test_lockstep_loop_freezes_converged_problems():
    """A problem whose KKT reaches tol keeps its carry while the others
    iterate: its w equals that of stopping there."""
    def outer(w, gens, kkt_at):
        w = w + 1.0
        kkt = torch.where(w[:, 0] >= kkt_at, 0.0, 1.0)
        return w, gens + 1, w[:, 0], kkt, torch.ones(2, dtype=torch.int32)
    w0 = torch.zeros((2, 3))
    (w, gens), f, kkt, nnz, n_outer, done = tloop.run_lockstep_loop(
        outer, (w0, torch.zeros((2, 4), dtype=torch.uint8)),
        (torch.tensor([2.0, 5.0]),), max_outer=10, tol_kkt=0.5,
        dtype=torch.float32)
    assert n_outer.tolist() == [2, 5] and bool(torch.all(done))
    assert w[:, 0].tolist() == [2.0, 5.0] and gens[:, 0].tolist() == [2, 5]
    assert f.tolist() == [2.0, 5.0] and kkt.tolist() == [0.0, 0.0]


# -- one-vs-rest ---------------------------------------------------------------------

def test_fit_ovr_matches_reference(data):
    jovr = importlib.import_module("repro.serve.ovr")
    tovr = importlib.import_module("repro_torch.serve.ovr")
    X, _, _ = data
    rng = np.random.default_rng(0)
    labels = np.argmax(X @ rng.standard_normal((N, 4)), axis=1)
    kw = dict(P=16, max_outer=200, tol_kkt=1e-3)
    jres = jovr.fit_ovr(X, labels, 2.0, JPCDNConfig(**kw))
    tres = tovr.fit_ovr(X, labels, 2.0, PCDNConfig(**kw), **CPU)
    assert np.array_equal(tres.classes, jres.classes)
    np.testing.assert_allclose(tres.batch.objective.numpy(),
                               np.asarray(jres.batch.objective), rtol=1e-3)
    assert tres.train_accuracy == pytest.approx(jres.train_accuracy,
                                                abs=0.02)
    assert tres.weights.shape == (4, N)
    np.testing.assert_array_equal(tovr.ovr_label_matrix([0, 2, 1], 3),
                                  jovr.ovr_label_matrix([0, 2, 1], 3))
    codes, classes = tovr.encode_labels(np.array(["b", "a", "b"]))
    assert codes.tolist() == [1, 0, 1] and classes.tolist() == ["a", "b"]
    fam = tovr.ovr_family(tres, "logistic")
    assert fam.kind == "ovr" and len(fam) == 4
    np.testing.assert_allclose(tovr.ovr_margins(tres.weights, X[:5]),
                               X[:5] @ tres.weights.T)


# -- the CLI --------------------------------------------------------------------------

def _dataset(tmp_path):
    from repro_torch.data import save_libsvm
    X, y, _ = make_classification(240, 60, sparsity=0.5, seed=0)
    path = tmp_path / "d.svm"
    save_libsvm(str(path), X, y)
    return str(path)


def test_path_cli_sweep_and_batch_with_telemetry(tmp_path):
    from repro.obs import validate as jvalidate
    from repro.serve.artifact import load_model as jload_model
    from repro_torch.launch import path as path_cli
    from repro_torch.obs import validate as tvalidate
    from repro_torch.serve.artifact import load_model
    ds = _dataset(tmp_path)
    common = ["--dataset", ds, "--points", "3", "--span", "10", "--P", "16",
              "--max-outer", "60", "--device", "cpu", "--layout",
              "padded_csc", "--use-kernels"]
    out = {}
    for mode in ("sweep", "batch"):
        m, t, o, f = (str(tmp_path / f"{mode}.{e}")
                      for e in ("jsonl", "trace.json", "json", "fam.json"))
        out[mode] = path_cli.main(common + [
            "--mode", mode, "--metrics-out", m, "--trace-out", t,
            "--out", o, "--save-weights", "--save-model", f, "--progress"])
        for v in (tvalidate, jvalidate):
            assert v.validate_metrics_file(m) == 1
            assert v.validate_trace_file(t) > 0
        rec = json.loads(open(m).read())
        assert rec["cli"] == "path" and rec["mode"] == mode
        assert json.load(open(o))["mode"] == mode
        assert np.load(o + ".weights.npy").shape == (3, 60)
        assert len(load_model(f)) == len(jload_model(f)) == 3
        assert not obs.metrics_enabled() and not obs.trace_enabled()
    for a, b in zip(out["sweep"]["points"], out["batch"]["points"]):
        assert a["objective"] == pytest.approx(b["objective"], rel=1e-3)
    # a file dataset has no validation split, as in the reference
    assert out["sweep"]["best_index"] is None


def test_path_cli_without_flags_records_nothing_and_refuses(tmp_path):
    from repro_torch.launch import path as path_cli
    ds = _dataset(tmp_path)
    payload = path_cli.main(["--dataset", ds, "--points", "2", "--P", "16",
                             "--max-outer", "20", "--device", "cpu",
                             "--shrink"])
    assert len(payload["points"]) == 2
    assert obs.registry.get_registry().empty
    assert obs.trace.get_tracer() is None
    with pytest.raises(SystemExit):
        path_cli.main(["--dataset", ds, "--mode", "batch", "--shrink",
                       "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            path_cli.main(["--dataset", ds, "--points", "2"])


def test_path_cli_profile_dataset_val_split(capsys):
    from repro_torch.launch import path as path_cli
    payload = path_cli.main(["--dataset", "a9a", "--scale", "0.05",
                             "--points", "3", "--P", "16", "--max-outer",
                             "40", "--device", "cpu"])
    assert payload["best_index"] is not None
    assert all(p["val_accuracy"] is not None for p in payload["points"])
    assert "best c=" in capsys.readouterr().out
