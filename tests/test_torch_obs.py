"""Telemetry of the port (`repro_torch.obs`) against the reference
(`repro.obs`), on the CPU.

  * registry: the same sequence of inc / set_gauge / observe /
    observe_many gives equal snapshots and `write_metrics` records
    (histogram quantiles to 1e-12); REPRO_METRICS=off wins; disabled
    planes record nothing;
  * trace: each package's trace validates under the other's validator,
    and both validators agree on malformed input;
  * the outer iteration's record_aux / record_kkt_vec planes, one
    iteration from a shared carry with the reference's partitions: the
    arity of every flag combination as the reference's, q exactly, alpha
    to rel 1e-6, the shrink sentinels in the same slots, kkt_vec to 1e-6;
  * the engine's registry keys and counts against the reference's on a
    solve of the same length (the reference without its kernels: its
    eager launch counter needs `jax.core.trace_state_clean`, which jax
    0.9 lacks); the port's own launch counters against the bundles run;
  * the serving batcher's and loop's metrics and spans; the solve and
    predict CLIs' --metrics-out / --trace-out files, which both packages'
    validators accept.
"""
import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp_
from repro import obs as jobs
from repro.core import pcdn as jpcdn
from repro.engine import LocalBackend as JLocalBackend
from repro.engine import loop as jloop
from repro.obs import validate as jvalidate
from repro_torch import obs
from repro_torch.core import pcdn as tpcdn
from repro_torch.engine import LocalBackend, bridge
from repro_torch.engine import loop as tloop
from repro_torch.kernels import ops
from repro_torch.obs import validate as tvalidate


@pytest.fixture(autouse=True)
def _obs_off():
    """Both packages' planes start and end off: they are process state."""
    for o in (obs, jobs):
        o.disable()
        o.registry.reset()
    yield
    for o in (obs, jobs):
        o.disable()
        o.registry.reset()


def _feed(o, rng_seed=0):
    """One fixed sequence of registry calls, from a seed."""
    rng = np.random.default_rng(rng_seed)
    o.inc("c")
    o.inc("c", 2.5)
    o.set_gauge("g", 7.0)
    o.set_gauge("g", 3.25)
    for v in rng.exponential(1e-3, size=40):
        o.observe("lat", float(v))
    o.observe_many("q", rng.integers(1, 41, size=60).astype(float),
                   bounds=o.Q_BOUNDS)
    o.observe_many("alpha", 0.5 ** rng.integers(0, 14, size=50),
                   bounds=o.ALPHA_BOUNDS)
    o.observe("empty_then_one", 5.0, bounds=(1.0, 10.0))


def _assert_snapshots_equal(a, b):
    assert a["counters"] == b["counters"]
    assert a["gauges"] == b["gauges"]
    assert list(a["histograms"]) == list(b["histograms"])
    for name, ha in a["histograms"].items():
        hb = b["histograms"][name]
        assert set(ha) == set(hb)
        for key in ("count", "bounds", "counts", "min", "max"):
            assert ha[key] == hb[key], (name, key)
        for key in ("sum", "mean", "p50", "p99"):
            assert ha[key] == pytest.approx(hb[key], rel=1e-12, abs=1e-15)


def test_bounds_match_reference():
    assert obs.LATENCY_BOUNDS_S == jobs.LATENCY_BOUNDS_S
    assert obs.Q_BOUNDS == jobs.Q_BOUNDS
    assert obs.ALPHA_BOUNDS == jobs.ALPHA_BOUNDS
    assert obs.__all__ == jobs.__all__


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_sequence_matches_reference(seed, tmp_path):
    for o in (obs, jobs):
        assert o.registry.enable() is True
        _feed(o, seed)
    _assert_snapshots_equal(obs.registry.get_registry().snapshot(),
                            jobs.registry.get_registry().snapshot())
    rec_t = obs.write_metrics(str(tmp_path / "t.jsonl"), meta={"cli": "x"})
    rec_j = jobs.write_metrics(str(tmp_path / "j.jsonl"), meta={"cli": "x"})
    assert set(rec_t) == set(rec_j) and rec_t["cli"] == rec_j["cli"]
    _assert_snapshots_equal(rec_t["metrics"], rec_j["metrics"])
    for path in ("t.jsonl", "j.jsonl"):
        for validator in (tvalidate, jvalidate):
            assert validator.validate_metrics_file(
                str(tmp_path / path)) == 1


def test_histogram_as_dict_and_merge():
    rng = np.random.default_rng(3)
    vals = rng.exponential(1e-2, size=300)
    ht, hj = obs.Histogram(), jobs.Histogram(jobs.LATENCY_BOUNDS_S)
    ht.observe_many(vals)
    hj.observe_many(vals)
    assert ht.as_dict() == pytest.approx(hj.as_dict(), rel=1e-12)
    a, b = obs.Histogram(), obs.Histogram()
    a.observe_many(vals[:100])
    b.observe_many(vals[100:])
    a.merge(b)
    assert a.counts == ht.counts and a.count == ht.count
    assert a.total == pytest.approx(ht.total, rel=1e-12)


def test_disabled_planes_record_nothing():
    obs.inc("x")
    obs.set_gauge("g", 1.0)
    obs.observe("h", 0.5)
    obs.observe_many("h", [1.0, 2.0])
    assert obs.registry.get_registry().empty
    assert obs.trace.get_tracer() is None and not obs.gate.on
    with obs.span("x", "engine"):
        pass
    obs.complete("y", "engine", 0, 10)
    obs.instant("z")
    obs.counter("n", 1.0)
    assert obs.trace.get_tracer() is None
    assert obs.trace.save("/nonexistent/never-written.json") is False


def test_env_kill_switch(monkeypatch):
    monkeypatch.setenv("REPRO_METRICS", "off")
    assert obs.registry.enable() is False
    obs.enable(metrics=True)
    assert not obs.metrics_enabled() and not obs.gate.on
    obs.inc("x")
    assert obs.registry.get_registry().empty
    obs.enable(metrics=True, trace_=True)   # the trace plane is not gated
    assert obs.trace_enabled() and obs.gate.on
    obs.disable()
    assert not obs.gate.on


def _trace_of(o, tmp_path, name):
    o.trace.enable()
    with o.span("outer", "engine"):
        with o.span("inner", "engine", args={"k": 1}):
            pass
    o.instant("mark", "engine")
    o.counter("n_active", 5.0, "engine")
    t0 = time.perf_counter_ns()
    o.complete("done", "path", t0, t0 + 1000, args={"i": 0})
    path = tmp_path / name
    assert o.trace.save(str(path)) is True
    return path


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_trace_validates_under_the_other_package(writer, reader, tmp_path):
    w = obs if writer == "port" else jobs
    r = obs if reader == "port" else jobs
    path = _trace_of(w, tmp_path, "t.json")
    n = r.validate_trace_file(str(path))
    assert n == len(json.load(open(path))["traceEvents"]) >= 7
    names = {e["name"] for e in json.load(open(path))["traceEvents"]}
    assert {"outer", "inner", "mark", "n_active", "done"} <= names


@pytest.mark.parametrize("bad,match", [
    ({"events": []}, "traceEvents"),
    ({"traceEvents": [{"name": "a", "ph": "X"}]}, "missing required field"),
    ({"traceEvents": [{"name": "a", "ph": "Z", "ts": 0, "pid": 1,
                       "tid": 1}]}, "unknown phase"),
    ({"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": 5, "dur": 10, "pid": 1, "tid": 1}]},
     "partially overlaps")])
def test_validators_reject_garbage_alike(bad, match):
    for o in (obs, jobs):
        with pytest.raises(ValueError, match=match):
            o.validate_trace(bad)


def test_validate_metrics_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"ts": "x", "metrics": {"histograms": {
        "h": {"count": 2, "sum": 1.0, "min": 0.1, "max": 0.9, "mean": 0.5,
              "p50": 0.5, "p99": 0.9, "bounds": [1.0],
              "counts": [1, 0]}}}}) + "\n")
    for v in (tvalidate, jvalidate):
        with pytest.raises(ValueError, match="sum\\(counts\\)"):
            v.validate_metrics_file(str(bad))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="no records"):
        tvalidate.validate_metrics_file(str(empty))


def test_validate_cli(tmp_path, capsys):
    good = _trace_of(obs, tmp_path, "good.json")
    obs.registry.enable()
    obs.inc("runs")
    obs.write_metrics(str(tmp_path / "m.jsonl"))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "a"}]}))
    assert tvalidate.main([str(good), str(tmp_path / "m.jsonl")]) == 0
    assert tvalidate.main([str(good), str(bad)]) == 1
    assert tvalidate.main([]) == 2
    out = capsys.readouterr()
    assert "OK" in out.out and "INVALID" in out.err


# -- the outer iteration's output planes ---------------------------------------

AUX_CASES = [(layout, scope, kernels, shrink)
             for layout, scope in tp_.ROUTES for kernels in (False, True)
             for shrink in (False, True)]


@pytest.mark.parametrize("layout,scope,use_kernels,shrink", AUX_CASES)
def test_aux_planes_match_reference(layout, scope, use_kernels, shrink):
    jp, tp = tp_.problems(layout, seed=5)
    P = 16
    jcfg, tcfg = tp_.configs(P, scope, use_kernels, shrink)
    flags = dict(record_aux=True, record_kkt_vec=True)
    jouter = jpcdn.make_path_outer(jp, dataclasses.replace(jcfg, **flags))
    touter = tpcdn.make_path_outer(tp, dataclasses.replace(tcfg, **flags))
    w, z = tp_.start_carry(jp, seed=6)
    key = jax.random.PRNGKey(0)
    active = np.ones(jp.n_features, bool)
    if shrink:   # a smaller active set, so some bundle slots stay idle
        active[np.random.default_rng(0).random(jp.n_features) < 0.6] = False
    idxs, b_active = tp_.reference_partition(key, active, P, shrink)
    jout = jouter(jax.numpy.asarray(w), jax.numpy.asarray(z), key,
                  jax.numpy.asarray(active), jax.numpy.asarray(True),
                  jax.numpy.float32(2.0))
    st = bridge.state_from_numpy(w, z, active, device="cpu")
    tout = touter(st.w, st.z, st.gen, st.active, True, 2.0,
                  idxs=bridge.partition_from_numpy(idxs, device="cpu"),
                  b_active=b_active)
    assert len(tout) == len(jout) == 11
    (jq, ja), jviol = jout[9], jout[10]
    (tq, ta), tviol = tout[9], tout[10]
    assert tq.dtype == torch.int32 and ta.dtype == torch.float32
    jq, ja = np.asarray(jq), np.asarray(ja)
    assert tq.shape == jq.shape == (idxs.shape[0],)
    np.testing.assert_array_equal(tq.numpy(), jq)
    ran = jq >= 0
    np.testing.assert_array_equal(np.isfinite(ta.numpy()), ran)
    if shrink:
        assert not ran.all() and ran[:b_active].all()
    np.testing.assert_allclose(ta.numpy()[ran], ja[ran], rtol=1e-6)
    # kkt_vec is the violation of the iterate the iteration returns: at the
    # port's own (w, z), the reference's function gives it to 1e-6; the
    # two packages' iterates differ by float32 sums in another order
    # (rtol 1e-5, as test_torch_solver_outer holds them), which the
    # gradient's sum over s carries to a few 1e-6 of the reference's vector
    tw, tz = tout[0].numpy(), tout[1].numpy()
    want = jp.kkt_violation_from_grad(
        jax.numpy.asarray(tw), jp.full_grad(jax.numpy.asarray(tz),
                                            jax.numpy.asarray(tw)))
    np.testing.assert_allclose(tviol.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tviol.numpy(), np.asarray(jviol), rtol=1e-4,
                               atol=1e-5)
    assert float(tout[4]) == float(tviol.max())
    assert float(tout[6]) == pytest.approx(float(tq[:b_active or None]
                                                 .float().mean()), rel=1e-6)


@pytest.mark.parametrize("layout,scope", tp_.ROUTES)
@pytest.mark.parametrize("aux,kkt_vec", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_outer_arity_matches_reference(layout, scope, aux, kkt_vec):
    jp, tp = tp_.problems(layout, seed=2)
    flags = dict(record_aux=aux, record_kkt_vec=kkt_vec)
    jcfg, tcfg = tp_.configs(16, scope, True)
    jb = JLocalBackend(jp, dataclasses.replace(jcfg, **flags))
    tb = LocalBackend(tp, dataclasses.replace(tcfg, **flags))
    js, ts = jb.init_state(), tb.init_state()
    jout = jb.outer(js.w, js.z, js.key, js.active, jax.numpy.asarray(True),
                    jax.numpy.float32(2.0))
    ops.reset_launch_counts()
    tout = tb.outer(ts.w, ts.z, ts.gen, ts.active, True, 2.0)
    assert len(tout) == len(jout) == 9 + aux + kkt_vec
    kinds = [isinstance(x, tuple) for x in tout[9:]]
    assert kinds == [isinstance(x, tuple) for x in jout[9:]]
    assert sum(ops.launch_counts().values()) == 0   # the CPU's plain route


def test_record_aux_does_not_perturb_solution():
    _, tp = tp_.problems("padded_csc", seed=3)
    cfg = tpcdn.PCDNConfig(P=16, max_outer=8, tol_kkt=0.0, seed=0,
                           use_kernels=True, ls_scope="support")
    r0 = tpcdn.solve(tp, cfg)
    r1 = tpcdn.solve(tp, dataclasses.replace(cfg, record_aux=True,
                                             record_kkt_vec=True))
    assert torch.equal(r0.w, r1.w) and r0.n_outer == r1.n_outer == 8
    assert r0.history.bundle_q is None and r0.history.kkt_vec is None
    h = r1.history
    assert h.bundle_q.shape == h.bundle_alpha.shape == (8, -(-96 // 16))
    np.testing.assert_allclose(h.bundle_q.mean(axis=1), h.ls_steps,
                               rtol=1e-6)
    assert h.kkt_vec.shape == (8, 96)
    np.testing.assert_allclose(h.kkt_vec.max(axis=1), h.kkt, rtol=1e-6)
    assert np.all((h.bundle_alpha >= 0) & (h.bundle_alpha <= 1))


def test_shrink_history_sentinels():
    X, y, _ = tp_.make_classification(300, 128, sparsity=0.8, corr=0.3,
                                      seed=2)
    prob = tp_.tprob.make_problem(X, y, c=1.0, device="cpu")
    cfg = tpcdn.PCDNConfig(P=32, max_outer=40, tol_kkt=1e-6, seed=0,
                           shrink=True, record_aux=True)
    res = tpcdn.solve(prob, cfg)
    h = res.history
    ran = h.bundle_q >= 0
    np.testing.assert_array_equal(ran, np.isfinite(h.bundle_alpha))
    assert ran.any() and (~ran).any()
    assert h.bundle_q.shape[0] == len(h.n_active) == res.n_outer


# -- the engine's metrics and spans ----------------------------------------------

def _engine_solve(pkg, layout, max_outer):
    jp, tp = tp_.problems(layout, seed=4)
    kw = dict(P=16, tol_kkt=0.0, max_outer=max_outer, seed=0,
              record_aux=True)
    if pkg == "reference":
        b = JLocalBackend(jp, jpcdn.PCDNConfig(**kw))
        return jloop.solve(b, 2.0, max_outer=max_outer, tol_kkt=0.0), jobs
    b = LocalBackend(tp, tpcdn.PCDNConfig(**kw))
    return tloop.solve(b, 2.0, max_outer=max_outer, tol_kkt=0.0), obs


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_engine_registry_matches_reference(layout, tmp_path):
    snaps = {}
    for pkg in ("reference", "port"):
        o = jobs if pkg == "reference" else obs
        o.enable(metrics=True, trace_=True)
        res, _ = _engine_solve(pkg, layout, 5)
        assert res.n_outer == 5
        snaps[pkg] = o.registry.get_registry().snapshot()
        o.trace.save(str(tmp_path / f"{pkg}.json"))
    ref, port = snaps["reference"], snaps["port"]
    assert set(port["counters"]) == set(ref["counters"])
    assert set(port["gauges"]) == set(ref["gauges"])
    assert set(port["histograms"]) == set(ref["histograms"])
    assert port["counters"]["solver.outer_iters"] == 5.0
    for name in ("solver.iter_seconds", "solver.mean_q", "solver.bundle_q",
                 "solver.bundle_alpha"):
        assert port["histograms"][name]["count"] == \
            ref["histograms"][name]["count"], name
    assert port["gauges"]["solver.n_active"] == ref["gauges"][
        "solver.n_active"] == 96
    for pkg in ("reference", "port"):
        events = json.load(open(tmp_path / f"{pkg}.json"))["traceEvents"]
        outer = [e for e in events if e["name"] == "engine.outer"]
        assert [e["args"]["k"] for e in outer] == list(range(5))
        for v in (tvalidate, jvalidate):
            assert v.validate_trace_file(str(tmp_path / f"{pkg}.json")) > 0


@pytest.mark.parametrize("scope,kernel", [("support", "pcdn_bundle"),
                                          ("full", "pcdn_sparse_direction")])
def test_kernel_launch_counters_and_spans(scope, kernel, tmp_path):
    """On the CPU each dispatch takes the plain route: the registry counts
    one launch a bundle (ops.launch_counts, which counts CUDA launches,
    stays 0) and the kernels track holds one `impl: plain` span each."""
    _, tp = tp_.problems("padded_csc", seed=4)
    cfg = tpcdn.PCDNConfig(P=16, tol_kkt=0.0, max_outer=3, seed=0,
                           use_kernels=True, ls_scope=scope)
    obs.enable(metrics=True, trace_=True)
    ops.reset_launch_counts()
    res = tpcdn.solve(tp, cfg)
    b = -(-tp.n_features // 16)
    counters = obs.registry.get_registry().counters
    assert counters[f"kernels.{kernel}.launches"] == res.n_outer * b == 3 * b
    assert sum(ops.launch_counts().values()) == 0
    path = tmp_path / "k.json"
    obs.trace.save(str(path))
    spans = [e for e in json.load(open(path))["traceEvents"]
             if e["name"] == f"kernels.{kernel}"]
    assert len(spans) == 3 * b
    assert {e["args"]["impl"] for e in spans} == {"plain"}
    assert jvalidate.validate_trace_file(str(path)) > 0


def test_engine_records_nothing_when_off():
    res, _ = _engine_solve("port", "padded_csc", 3)
    assert res.history.bundle_q is not None   # the aux plane is separate
    assert obs.registry.get_registry().empty
    assert obs.trace.get_tracer() is None


def test_callback_and_guard_instants():
    _, tp = tp_.problems("padded_csc", seed=4)
    calls = []
    cfg = tpcdn.PCDNConfig(P=16, tol_kkt=0.0, max_outer=4, seed=0)
    res = tpcdn.solve(tp, cfg, callback=lambda *a: calls.append(a))
    assert [c[0] for c in calls] == [0, 1, 2, 3]
    for (k, w, f, kkt, mean_q), F in zip(calls, res.history.objective):
        assert isinstance(w, torch.Tensor) and f == F
        assert isinstance(kkt, float) and mean_q >= 1.0
    obs.enable(metrics=True, trace_=True)
    b = LocalBackend(tp, cfg)
    _, r = tloop.run_outer_loop(b.outer, b.init_state(), 2.0, max_outer=4,
                                tol_kkt=0.0,
                                divergence_guard=lambda f: True)
    assert r.diverged and r.n_outer == 1
    assert obs.registry.get_registry().counters[
        "solver.divergence_trips"] == 1.0
    events = obs.trace.get_tracer().to_dict()["traceEvents"]
    assert any(e["name"] == "engine.divergence_guard" for e in events)


# -- serving --------------------------------------------------------------------

def _bank(mod_predict, n=256, K=4, seed=0, **kw):
    rng = np.random.default_rng(seed)
    W = np.zeros((K, n), np.float32)
    W[:, :8] = rng.standard_normal((K, 8))
    return mod_predict.ModelBank.from_dense(W, kind="path", **kw)


def test_batcher_metrics_match_reference():
    import importlib
    jbatcher = importlib.import_module("repro.serve.batcher")
    jpredict = importlib.import_module("repro.serve.predict")
    tbatcher = importlib.import_module("repro_torch.serve.batcher")
    tpredict = importlib.import_module("repro_torch.serve.predict")
    X = np.random.default_rng(1).standard_normal((64, 256)).astype(
        np.float32)
    snaps = {}
    for name, o, bm, pm, kw in (
            ("reference", jobs, jbatcher, jpredict, {}),
            ("port", obs, tbatcher, tpredict, {"device": "cpu"})):
        o.enable(metrics=True, trace_=True)
        b = bm.MicroBatcher(_bank(pm, **kw), buckets=(8, 32),
                            layout="dense")
        for lo, hi in ((0, 5), (5, 37), (37, 64), (0, 30)):
            b.predict(X[lo:hi])
        snaps[name] = o.registry.get_registry().snapshot()
        o.validate_trace(o.trace.get_tracer().to_dict())
        chunks = [e for e in o.trace.get_tracer().to_dict()["traceEvents"]
                  if e["name"] == "serve.chunk"]
        assert len(chunks) == 4
    ref, port = snaps["reference"], snaps["port"]
    assert port["counters"] == ref["counters"]
    assert port["counters"]["serve.rows"] == 94.0
    assert port["counters"]["serve.compiles"] == 2.0   # one per bucket
    assert set(port["histograms"]) == set(ref["histograms"])
    for name, h in port["histograms"].items():
        assert h["count"] == ref["histograms"][name]["count"], name


def test_serve_loop_metrics_and_spans(tmp_path):
    from repro_torch.serve import artifact as art
    from repro_torch.serve.loop import ServeLoop
    rng = np.random.default_rng(5)
    w = np.zeros(32)
    w[:5] = rng.standard_normal(5)
    fam = art.ModelFamily(kind="binary", models=(
        art.artifact_from_solution(w, "logistic", c=1.0),))
    obs.enable(metrics=True, trace_=True)
    X = rng.standard_normal((10, 32)).astype(np.float32)
    with ServeLoop(fam, buckets=(4,), default_budget_s=0.2,
                   device="cpu") as loop:
        futs = loop.submit_many(X)
        [f.result(10.0) for f in futs]
        ticket = loop.swap(fam)
        ticket.installed.wait(10.0)
    snap = obs.registry.get_registry().snapshot()
    c = snap["counters"]
    assert c["serve.compiles"] == 1.0                 # one (slot, bucket)
    assert c["serve.loop.requests"] == c["serve.loop.responses"] == 10.0
    assert c["serve.loop.rows"] == 10.0
    assert c["serve.loop.installs"] == 1.0
    assert sum(v for k, v in c.items()
               if k.startswith("serve.loop.flush.")) >= 3
    assert snap["gauges"]["serve.queue_depth"] == 0.0
    assert snap["histograms"]["serve.e2e_latency_s"]["count"] == 10
    path = tmp_path / "serve.json"
    obs.trace.save(str(path))
    names = [e["name"] for e in json.load(open(path))["traceEvents"]]
    for span in ("serve.warmup", "serve.flush", "serve.install"):
        assert span in names, span
    for v in (tvalidate, jvalidate):
        assert v.validate_trace_file(str(path)) > 0


# -- CLIs -----------------------------------------------------------------------

def _dataset(tmp_path):
    from repro_torch.data import save_libsvm
    X, y, _ = tp_.make_classification(120, 60, sparsity=0.5, seed=0)
    path = tmp_path / "d.svm"
    save_libsvm(str(path), X, y)
    return str(path)


def test_solve_cli_metrics_and_trace(tmp_path):
    from repro_torch.launch import solve as solve_cli
    ds = _dataset(tmp_path)
    m, t, r = (str(tmp_path / n) for n in ("m.jsonl", "t.json", "r.json"))
    solve_cli.main(["--dataset", ds, "--P", "16", "--max-outer", "10",
                    "--tol", "1e-6", "--c", "5.0", "--layout", "padded_csc",
                    "--use-kernels", "--device", "cpu", "--metrics-out", m,
                    "--trace-out", t, "--out", r, "--progress"])
    for v in (tvalidate, jvalidate):
        assert v.validate_metrics_file(m) == 1
    assert obs.validate_trace_file(t) > 0 and jobs.validate_trace_file(t) > 0
    rec = json.loads(open(m).read().strip().splitlines()[-1])
    assert rec["cli"] == "solve" and rec["device"] == "cpu"
    hq = rec["metrics"]["histograms"]["solver.bundle_q"]
    report = json.load(open(r))
    assert hq["count"] == np.size(report["history"]["bundle_q"])
    assert "bundle_alpha" in report["history"]
    assert not obs.metrics_enabled() and not obs.trace_enabled()


def test_solve_cli_without_flags_records_nothing(tmp_path):
    from repro_torch.launch import solve as solve_cli
    r = str(tmp_path / "r.json")
    solve_cli.main(["--dataset", _dataset(tmp_path), "--P", "16",
                    "--max-outer", "5", "--c", "5.0", "--device", "cpu",
                    "--out", r])
    assert obs.registry.get_registry().empty
    assert obs.trace.get_tracer() is None
    assert "bundle_q" not in json.load(open(r))["history"]


def test_predict_cli_metrics_and_trace(tmp_path):
    from repro_torch.launch import predict as predict_cli
    from repro_torch.launch import solve as solve_cli
    ds = _dataset(tmp_path)
    model = str(tmp_path / "m.json")
    solve_cli.main(["--dataset", ds, "--P", "16", "--max-outer", "5",
                    "--c", "5.0", "--device", "cpu", "--save-model", model])
    m, t = str(tmp_path / "p.jsonl"), str(tmp_path / "p.json")
    predict_cli.main(["--model", model, "--dataset", ds, "--device", "cpu",
                      "--use-kernels", "--buckets", "16,64",
                      "--metrics-out", m, "--trace-out", t])
    rec = json.loads(open(m).read().strip())
    assert rec["cli"] == "predict"
    counters = rec["metrics"]["counters"]
    assert counters["serve.rows"] == 120.0
    assert counters["kernels.serve_margins_dense.launches"] >= 2
    for v in (tvalidate, jvalidate):
        assert v.validate_metrics_file(m) == 1
        assert v.validate_trace_file(t) > 0
