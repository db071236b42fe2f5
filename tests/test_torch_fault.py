"""Fault tolerance of the port (`repro_torch.fault`) against the
reference's (`repro.fault`), case for case with tests/test_fault.py where
a case exists on one card: the fault plan and its env channel, the
backoff schedule, the engine's non-finite detector, rollback with
P-backoff toward the certified bound, solve and path checkpoint/resume
(bit-exact within the port on the CPU), and checkpoints crossing between
the packages in both directions (w, z and active bit-equal).

The reference draws its partitions with jax.random and the port with a
torch.Generator, so whole solves of the two packages agree only at the
KKT stop: F rel 1e-3 at tol 1e-3 (the reference's own cross-P tolerance,
tests/test_fault.py's TOL).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import fault as jfault
from repro.core import PCDNConfig as JPCDNConfig
from repro.core import make_problem as jmake_problem
from repro.core import with_bundle_size as jwith_bundle_size
from repro.data import make_classification
from repro.engine import LocalBackend as JLocalBackend
from repro.engine import loop as jloop
from repro.path.driver import PathConfig as JPathConfig
from repro.path.driver import run_path as jrun_path
from repro_torch import fault
from repro_torch.core import PCDNConfig, make_problem, with_bundle_size
from repro_torch.engine import LocalBackend
from repro_torch.engine import loop as engine_loop
from repro_torch.fault import atomic
from repro_torch.fault.checkpoint import GEN_STATE
from repro_torch.path.driver import PathConfig, run_path

TOL = 1e-3
F_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a case: under pytest-xdist several workers share
    the machine's cores, and torch's default of a thread a core in each of
    them makes these small problems wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_classification(300, 128, sparsity=0.8, corr=0.3, seed=2)


@pytest.fixture(scope="module")
def prob(data):
    X, y, _ = data
    return make_problem(X, y, c=1.0, device="cpu")


@pytest.fixture(scope="module")
def jprob(data):
    X, y, _ = data
    return jmake_problem(X, y, c=1.0)


def _factory(prob, **kw):
    cfg = PCDNConfig(P=32, max_outer=80, tol_kkt=TOL, **kw)

    def factory(P):
        return LocalBackend(prob, with_bundle_size(cfg, P))
    return factory


def _jfactory(jprob):
    cfg = JPCDNConfig(P=32, max_outer=80, tol_kkt=TOL)

    def factory(P):
        return JLocalBackend(jprob, jwith_bundle_size(cfg, P))
    return factory


# -- atomic writes ------------------------------------------------------------

def test_atomic_write_roundtrip(tmp_path):
    p = str(tmp_path / "a.json")
    atomic.atomic_write_json(p, {"x": 1})
    assert json.load(open(p)) == {"x": 1}
    atomic.atomic_write_text(str(tmp_path / "t.txt"), "hi")
    assert open(tmp_path / "t.txt").read() == "hi"
    assert fault.atomic_write_bytes is atomic.atomic_write_bytes


# -- fault plan / injection harness -------------------------------------------

def test_fault_plan_validation_matches_reference():
    assert fault.NAN_TARGETS == jfault.NAN_TARGETS
    assert fault.CRASH_KINDS == jfault.CRASH_KINDS
    assert fault.ENV_VAR == jfault.ENV_VAR == "REPRO_FAULT_PLAN"
    for kw, match in (({"crash_kind": "nope"}, "crash_kind"),
                      ({"nan_target": "gradient"}, "nan_target")):
        for mod in (fault, jfault):
            with pytest.raises(ValueError, match=match):
                mod.FaultPlan(**kw)


ENV_PLANS = [None, "", '{"crash_at_point": 2, "crash_kind": "sigkill"}',
             '{"nan_at_iter": 3, "nan_target": "margins", "nan_count": 2}',
             '{"delay_at_iter": 1, "delay_s": 0.5, "seed": 4}',
             '{"typo_at_iter": 1}', '[1, 2]', '{"crash_kind": "reboot"}']


@pytest.mark.parametrize("raw", ENV_PLANS)
def test_plan_from_env_matches_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(fault.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(fault.ENV_VAR, raw)
    outcomes = []
    for mod in (fault, jfault):
        try:
            plan = mod.plan_from_env()
            outcomes.append(None if plan is None else {
                k: getattr(plan, k) for k in
                ("crash_at_iter", "crash_at_point", "crash_kind",
                 "nan_at_iter", "nan_target", "nan_count", "delay_at_iter",
                 "delay_s", "seed")})
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]


def test_injection_fires_once():
    plan = fault.FaultPlan(crash_at_iter=1)
    calls = {"n": 0}

    def outer(w, z, gen, active, recheck, c, idxs=None):
        calls["n"] += 1
        return ("w", "z", "gen", 0.0, 0.0, 0, 0.0, "active", 0)

    wrapped = fault.wrap_outer(outer, plan)
    args = (None, None, None, None, True, 1.0)
    wrapped(*args)                       # k=0: clean
    with pytest.raises(fault.InjectedCrash):
        wrapped(*args, idxs=None)        # k=1: crash (keywords pass on)
    rewrapped = fault.wrap_outer(outer, plan, start_iter=1)
    rewrapped(*args)                     # k=1 again: clean now
    assert calls["n"] == 2


@pytest.mark.parametrize("target", ["margins", "weights", "kkt"])
def test_poison_indices_match_reference_and_keep_the_input(target):
    n, s = 40, 60
    w_in = torch.arange(n, dtype=torch.float32)
    z_in = torch.arange(s, dtype=torch.float32)
    out = (w_in.clone(), z_in.clone(), None, torch.tensor(1.0),
           torch.tensor(0.5), 3, 0.0, None, 3)
    got = fault.FaultPlan(nan_at_iter=0, nan_target=target,
                          nan_count=5, seed=3).poison(out)
    jout = (jax.numpy.arange(n, dtype=jax.numpy.float32),
            jax.numpy.arange(s, dtype=jax.numpy.float32), None,
            jax.numpy.asarray(1.0), jax.numpy.asarray(0.5), 3, 0.0, None, 3)
    want = jfault.FaultPlan(nan_at_iter=0, nan_target=target,
                            nan_count=5, seed=3).poison(jout)
    for slot in (0, 1, 3, 4):
        np.testing.assert_array_equal(np.asarray(got[slot]),
                                      np.asarray(want[slot]))
    assert torch.equal(out[0], w_in) and torch.equal(out[1], z_in)


@pytest.mark.parametrize("P", [1, 2, 3, 16, 32, 33, 64, 256, 512])
def test_next_bundle_size_matches_reference(P):
    for p_cert in (None, 0, 1, 5, 16, 20, 48, 64, 300):
        assert fault.next_bundle_size(P, p_cert) == \
            jfault.next_bundle_size(P, p_cert), (P, p_cert)
    assert fault.next_bundle_size(64, p_cert=48) == 48
    assert fault.next_bundle_size(256, p_cert=48) == 128


# -- engine non-finite detector -----------------------------------------------

@pytest.mark.parametrize("target,at", [("margins", 3), ("weights", 2),
                                       ("kkt", 1)])
def test_nan_guard_local(prob, target, at):
    backend = LocalBackend(prob, PCDNConfig(P=32, max_outer=80,
                                            tol_kkt=TOL))
    plan = fault.FaultPlan(nan_at_iter=at, nan_target=target)
    state, res = engine_loop.run_outer_loop(
        fault.wrap_outer(backend.outer, plan), backend.init_state(), 1.0,
        max_outer=80, tol_kkt=TOL)
    assert res.nonfinite and res.diverged and not res.converged
    assert int(res.history.outer_iter[-1]) == at
    assert np.isfinite(res.objective)
    assert torch.all(torch.isfinite(state.w))
    assert torch.all(torch.isfinite(state.z))
    assert res.postmortem is not None and res.postmortem["trip_iter"] == at


def test_check_finite_w_catches_what_f_and_kkt_miss(prob):
    backend = LocalBackend(prob, PCDNConfig(P=32, tol_kkt=TOL))

    def outer(*args):
        out = list(backend.outer(*args))
        outer.k += 1
        if outer.k % 3 == 0:         # the last iteration of each run:
            out[0] = out[0].clone()  # w only, f and kkt stay finite
            out[0][5] = float("inf")
        return tuple(out)
    outer.k = 0

    kw = dict(max_outer=3, tol_kkt=0.0)
    _, res = engine_loop.run_outer_loop(outer, backend.init_state(), 1.0,
                                        **kw)
    assert not res.nonfinite and res.n_outer == 3
    _, res = engine_loop.run_outer_loop(outer, backend.init_state(), 1.0,
                                        check_finite_w=True, **kw)
    assert res.nonfinite and res.n_outer == 3
    assert torch.all(torch.isfinite(res.w))


def test_state_callback_sees_finite_iterations_only(prob):
    backend = LocalBackend(prob, PCDNConfig(P=32, tol_kkt=TOL))
    seen = []
    plan = fault.FaultPlan(nan_at_iter=2)
    engine_loop.run_outer_loop(
        fault.wrap_outer(backend.outer, plan), backend.init_state(), 1.0,
        max_outer=10, tol_kkt=0.0,
        state_callback=lambda k, st, f, kkt: seen.append(
            (k, bool(torch.all(torch.isfinite(st.z))), np.isfinite(f))))
    assert seen == [(0, True, True), (1, True, True)]


# -- rollback + P-backoff -----------------------------------------------------

def test_resilient_clean_solve_matches_plain(prob):
    factory = _factory(prob)
    plain = engine_loop.solve(factory(32), 1.0, max_outer=80, tol_kkt=TOL)
    res = fault.resilient_solve(factory, 1.0, P=32, max_outer=80,
                                tol_kkt=TOL)
    assert res.converged and res.faults is None
    assert isinstance(res.w, np.ndarray)
    np.testing.assert_array_equal(plain.w.numpy(), res.w)
    np.testing.assert_array_equal(plain.history.objective,
                                  res.history.objective)


def test_rollback_backoff_converges_like_reference(prob, jprob):
    """NaN into margins at iteration 3: rollback, P halves toward the
    certified bound, and the retried solve converges at tol 1e-3 -- with
    the reference's P schedule and certificate, and its F to rel 1e-3."""
    plan = fault.FaultPlan(nan_at_iter=3, nan_target="margins")
    res = fault.resilient_solve(_factory(prob), 1.0, P=32, max_outer=80,
                                tol_kkt=TOL, plan=plan, design=prob.design)
    ref = jfault.resilient_solve(
        _jfactory(jprob), 1.0, P=32, max_outer=80, tol_kkt=TOL,
        plan=jfault.FaultPlan(nan_at_iter=3, nan_target="margins"),
        design=jprob.design)
    assert res.converged and ref.converged
    assert res.faults["rollbacks"] == ref.faults["rollbacks"] == 1
    assert res.faults["p_schedule"] == ref.faults["p_schedule"] == [32, 16]
    assert res.faults["p_cert"] == ref.faults["p_cert"]
    assert float(res.history.kkt[-1]) <= TOL
    assert (np.diff(np.asarray(res.history.outer_iter)) == 1).all()
    assert res.history.outer_iter[0] == 0
    np.testing.assert_allclose(res.objective, ref.objective, rtol=F_RTOL)


def test_rollback_respects_certified_floor(prob):
    plan = fault.FaultPlan(nan_at_iter=2, nan_target="weights")
    res = fault.resilient_solve(_factory(prob), 1.0, P=32, max_outer=80,
                                tol_kkt=TOL, plan=plan, p_cert=20)
    assert res.converged
    assert res.faults["p_schedule"] == [32, 20]
    assert res.faults["p_cert"] == 20


def test_lazy_certificate_from_a_callable(prob):
    built = []

    def design():
        built.append(1)
        return prob.design

    res = fault.resilient_solve(_factory(prob), 1.0, P=32, max_outer=80,
                                tol_kkt=TOL, design=design)
    assert res.faults is None and not built      # fault-free: never built
    res = fault.resilient_solve(_factory(prob), 1.0, P=32, max_outer=80,
                                tol_kkt=TOL, design=design,
                                plan=fault.FaultPlan(nan_at_iter=1))
    assert built == [1] and res.faults["p_cert"] is not None


def test_rollback_retries_exhausted_surfaces_postmortem(prob):
    plan = fault.FaultPlan(nan_at_iter=3, nan_target="margins")
    res = fault.resilient_solve(_factory(prob, record_aux=True), 1.0,
                                P=32, max_outer=80, tol_kkt=TOL, plan=plan,
                                max_retries=0)
    assert res.nonfinite and res.diverged and not res.converged
    assert res.faults["rollbacks"] == 1
    assert np.isfinite(res.objective)
    assert np.all(np.isfinite(res.w))
    pm = res.postmortem
    for key in ("objective_growth", "deepest_mean_q", "heatmap",
                "worst_bundles", "alpha_floor"):
        assert key in pm, key
    # the trip iteration's bundles ran too: 4 iterations of 4 bundles
    assert pm["heatmap"]["bundles_ran"] == 4 * 4


def test_merged_history_pads_aux_across_p(prob):
    plan = fault.FaultPlan(nan_at_iter=2)
    res = fault.resilient_solve(_factory(prob, record_aux=True), 1.0,
                                P=32, max_outer=6, tol_kkt=0.0, plan=plan,
                                p_cert=16)
    q = res.history.bundle_q
    assert q.shape == (6, 8)           # 4 bundles at P 32, 8 at P 16
    assert (q[:2, 4:] == -1).all() and (q[2:] >= 0).all()
    assert np.isnan(res.history.bundle_alpha[:2, 4:]).all()


# -- solve checkpoint / resume ------------------------------------------------

def test_solve_checkpoint_resume_bit_exact(prob, tmp_path):
    factory = _factory(prob)
    ref = fault.resilient_solve(factory, 1.0, P=32, max_outer=80,
                                tol_kkt=TOL,
                                checkpointer=fault.SolveCheckpointer(
                                    str(tmp_path / "ref"), every=2))
    plan = fault.FaultPlan(crash_at_iter=3, crash_kind="exception")
    ck = fault.SolveCheckpointer(str(tmp_path / "x"), every=2)
    with pytest.raises(fault.InjectedCrash):
        fault.resilient_solve(factory, 1.0, P=32, max_outer=80,
                              tol_kkt=TOL, checkpointer=ck, plan=plan)
    res = fault.resilient_solve(
        factory, 1.0, P=32, max_outer=80, tol_kkt=TOL,
        checkpointer=fault.SolveCheckpointer(str(tmp_path / "x"), every=2),
        resume=True)
    assert res.converged
    assert res.faults["resumed_from"] == 1
    np.testing.assert_array_equal(ref.w, res.w)
    assert res.objective == ref.objective
    assert list(res.history.outer_iter) == \
        list(range(2, int(ref.history.outer_iter[-1]) + 1))


def test_resume_continues_the_backed_off_p(prob, tmp_path):
    """A crash after a backoff resumes at the P the checkpoint ran."""
    d = str(tmp_path / "ck")
    plan = fault.FaultPlan(nan_at_iter=1, crash_at_iter=3)
    with pytest.raises(fault.InjectedCrash):
        fault.resilient_solve(_factory(prob), 1.0, P=32, max_outer=80,
                              tol_kkt=TOL, p_cert=16, plan=plan,
                              checkpointer=fault.SolveCheckpointer(
                                  d, every=1))
    ck = fault.SolveCheckpointer(d, every=1)
    assert ck.latest_meta()["P"] == 16
    res = fault.resilient_solve(_factory(prob), 1.0, P=32, max_outer=80,
                                tol_kkt=TOL, checkpointer=ck, resume=True)
    assert res.faults["p_schedule"] == [16]
    assert res.faults["resumed_from"] == 2
    assert res.converged


def test_corrupted_checkpoints_skipped(prob, tmp_path):
    factory = _factory(prob)
    d = str(tmp_path / "ck")
    ref = fault.resilient_solve(factory, 1.0, P=32, max_outer=80,
                                tol_kkt=TOL,
                                checkpointer=fault.SolveCheckpointer(
                                    d, every=1, keep=10))
    mgr = fault.CheckpointManager(d)
    steps = mgr.steps()
    assert len(steps) >= 3
    fault.corrupt_checkpoint(d, step=steps[-1], mode="truncate")
    fault.corrupt_checkpoint(d, step=steps[-2], mode="uncommit")
    assert mgr.steps() == [s for s in steps if s != steps[-2]]
    step, _leaves, _meta = mgr.restore_latest_valid_raw()
    assert step == steps[-3]
    res = fault.resilient_solve(
        factory, 1.0, P=32, max_outer=80, tol_kkt=TOL,
        checkpointer=fault.SolveCheckpointer(d, every=1, keep=10),
        resume=True)
    assert res.converged
    np.testing.assert_array_equal(ref.w, res.w)
    with pytest.raises(ValueError, match="unknown mode"):
        fault.corrupt_checkpoint(d, mode="melt")


def test_solve_and_path_checkpoints_do_not_mix(prob, tmp_path):
    d = str(tmp_path / "ck")
    factory = _factory(prob)
    fault.resilient_solve(factory, 1.0, P=32, max_outer=80, tol_kkt=TOL,
                          checkpointer=fault.SolveCheckpointer(d, every=2))
    ck = fault.SolveCheckpointer(d, every=2)
    with pytest.raises(ValueError, match="separate --ckpt-dir"):
        ck.restore_path(factory(32), cs=np.asarray([1.0]), c_max=1.0)


@pytest.mark.parametrize("every", [0, -3])
def test_checkpointer_rejects_bad_cadence(tmp_path, every):
    for mod in (fault, jfault):
        with pytest.raises(ValueError, match=">= 1"):
            mod.SolveCheckpointer(str(tmp_path), every=every)


def test_manager_layout_gc_and_restore(tmp_path):
    cm = fault.CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": np.arange(4, dtype=np.float32), "a": np.ones(3, bool)}
    for s in (1, 2, 3):
        cm.save(s, tree, extra={"s": s})
    os.makedirs(tmp_path / ".tmp_ckpt_stale")
    os.makedirs(tmp_path / "step_00000009")       # never committed
    cm.save(4, tree)
    assert cm.steps() == [3, 4]
    assert not (tmp_path / ".tmp_ckpt_stale").exists()
    d = tmp_path / "step_00000004"
    assert sorted(os.listdir(d)) == ["COMMITTED", "arrays.npz",
                                     "manifest.json"]
    assert sorted(np.load(d / "arrays.npz").files) == ["00000§a",
                                                       "00001§w"]
    assert cm.latest_step() == 4
    got = cm.load_raw(4)
    assert got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], tree["w"])
    # the reference's manager reads the same step
    _, jgot = jfault.CheckpointManager(str(tmp_path)).restore(
        {"a": jax.numpy.zeros(3, bool), "w": jax.numpy.zeros(4)})
    np.testing.assert_array_equal(np.asarray(jgot["w"]), tree["w"])


# -- path sweep checkpoint / resume -------------------------------------------

def _path_cfg(n_points=5):
    return PathConfig(solver=PCDNConfig(P=32, max_outer=60, tol_kkt=TOL),
                      n_points=n_points, span=30.0)


def test_path_crash_resume_bit_exact(prob, data, tmp_path):
    X, y, _ = data
    ref = run_path(prob, _path_cfg(), val_design=X, val_y=y)
    plan = fault.FaultPlan(crash_at_point=2, crash_kind="exception")
    with pytest.raises(fault.InjectedCrash):
        run_path(prob, _path_cfg(), val_design=X, val_y=y,
                 ckpt=fault.SolveCheckpointer(str(tmp_path / "p")),
                 fault_plan=plan)
    res = run_path(prob, _path_cfg(), val_design=X, val_y=y,
                   ckpt=fault.SolveCheckpointer(str(tmp_path / "p")),
                   resume=True)
    np.testing.assert_array_equal(ref.weights, res.weights)
    assert res.best_index == ref.best_index
    assert [p.objective for p in res.points] == \
        [p.objective for p in ref.points]


def test_path_resume_rejects_different_grid(prob, tmp_path):
    run_path(prob, _path_cfg(),
             ckpt=fault.SolveCheckpointer(str(tmp_path / "p")))
    with pytest.raises(ValueError, match="different c-grid"):
        run_path(prob, _path_cfg(n_points=7),
                 ckpt=fault.SolveCheckpointer(str(tmp_path / "p")),
                 resume=True)


# -- checkpoints cross between the packages -----------------------------------

def _assert_image(got_w, got_z, got_active, leaves):
    np.testing.assert_array_equal(np.asarray(got_w), leaves["w"])
    np.testing.assert_array_equal(np.asarray(got_z), leaves["z"])
    np.testing.assert_array_equal(np.asarray(got_active), leaves["active"])


@pytest.mark.parametrize("shrink", [False, True])
def test_reference_solve_checkpoint_restores_in_port(prob, jprob, tmp_path,
                                                     shrink):
    d = str(tmp_path / "ck")
    jb = JLocalBackend(jprob, JPCDNConfig(P=32, tol_kkt=TOL, shrink=shrink))
    ck = jfault.SolveCheckpointer(d, every=3)
    jloop.run_outer_loop(jb.outer, jb.init_state(), 1.0, max_outer=6,
                         tol_kkt=0.0, state_callback=ck.solve_callback(jb))
    leaves = ck.manager.load_raw(5)
    tb = LocalBackend(prob, PCDNConfig(P=32, tol_kkt=TOL, shrink=shrink,
                                       seed=3))
    state, meta = fault.SolveCheckpointer(d).restore_solve(tb)
    assert meta["outer_iter"] == 5 and GEN_STATE not in meta
    _assert_image(state.w, state.z, state.active, leaves)
    # no generator state in a reference checkpoint: seeded from cfg.seed
    assert torch.equal(state.gen.get_state(),
                       torch.Generator().manual_seed(3).get_state())
    # and the port keeps solving from it, with global indices
    _, res = engine_loop.run_outer_loop(tb.outer, state, 1.0, max_outer=9,
                                        tol_kkt=0.0, start_iter=6)
    assert list(res.history.outer_iter) == [6, 7, 8]
    assert np.isfinite(res.objective)


@pytest.mark.parametrize("shrink", [False, True])
def test_port_solve_checkpoint_restores_in_reference(prob, jprob, tmp_path,
                                                     shrink):
    d = str(tmp_path / "ck")
    tb = LocalBackend(prob, PCDNConfig(P=32, tol_kkt=TOL, shrink=shrink))
    ck = fault.SolveCheckpointer(d, every=3)
    engine_loop.run_outer_loop(tb.outer, tb.init_state(), 1.0, max_outer=6,
                               tol_kkt=0.0,
                               state_callback=ck.solve_callback(tb))
    leaves = ck.manager.load_raw(5)
    assert sorted(leaves) == ["active", "key", "w", "z"]
    assert leaves["key"].dtype == np.uint32 and leaves["key"].shape == (2,)
    jb = JLocalBackend(jprob, JPCDNConfig(P=32, tol_kkt=TOL, shrink=shrink))
    state, meta = jfault.SolveCheckpointer(d).restore_solve(jb)
    assert meta["outer_iter"] == 5
    _assert_image(state.w, state.z, state.active, leaves)
    _, res = jloop.run_outer_loop(jb.outer, state, 1.0, max_outer=8,
                                  tol_kkt=0.0, start_iter=6)
    assert list(res.history.outer_iter) == [6, 7]
    assert np.isfinite(res.objective)


def _jpath_cfg():
    return JPathConfig(solver=JPCDNConfig(P=32, max_outer=60, tol_kkt=TOL),
                       n_points=5, span=30.0)


def test_reference_path_checkpoint_restores_in_port(prob, jprob, tmp_path):
    d = str(tmp_path / "p")
    with pytest.raises(jfault.InjectedCrash):
        jrun_path(jprob, _jpath_cfg(), ckpt=jfault.SolveCheckpointer(d),
                  fault_plan=jfault.FaultPlan(crash_at_point=2))
    mgr = fault.CheckpointManager(d)
    leaves = mgr.load_raw(2)
    jmeta = mgr.manifest(2)["extra"]
    state, meta, weights = fault.SolveCheckpointer(d).restore_path(
        LocalBackend(prob, _path_cfg().solver), cs=np.asarray(jmeta["cs"]),
        c_max=jmeta["c_max"])
    _assert_image(state.w, state.z, state.active, leaves)
    np.testing.assert_array_equal(weights, leaves["weights"])
    # the port's run_path resumes the reference's sweep at point 3
    res = run_path(prob, _path_cfg(), ckpt=fault.SolveCheckpointer(d),
                   resume=True)
    assert len(res.points) == 5
    assert [p.objective for p in res.points[:3]] == \
        [p["objective"] for p in meta["points"]]
    np.testing.assert_array_equal(res.weights[:3], leaves["weights"][:3])
    ref = jrun_path(jprob, _jpath_cfg())
    np.testing.assert_allclose([p.objective for p in res.points],
                               [p.objective for p in ref.points],
                               rtol=F_RTOL)


def test_port_path_checkpoint_restores_in_reference(prob, jprob, tmp_path):
    d = str(tmp_path / "p")
    with pytest.raises(fault.InjectedCrash):
        run_path(prob, _path_cfg(), ckpt=fault.SolveCheckpointer(d),
                 fault_plan=fault.FaultPlan(crash_at_point=1))
    leaves = fault.CheckpointManager(d).load_raw(1)
    assert sorted(leaves) == ["active", "key", "w", "weights", "z"]
    meta = fault.CheckpointManager(d).manifest(1)["extra"]
    state, jmeta, weights = jfault.SolveCheckpointer(d).restore_path(
        JLocalBackend(jprob, _jpath_cfg().solver),
        cs=np.asarray(meta["cs"]), c_max=meta["c_max"])
    _assert_image(state.w, state.z, state.active, leaves)
    np.testing.assert_array_equal(weights, leaves["weights"])
    res = jrun_path(jprob, _jpath_cfg(), ckpt=jfault.SolveCheckpointer(d),
                    resume=True)
    assert [p.objective for p in res.points[:2]] == \
        [p["objective"] for p in meta["points"]]
