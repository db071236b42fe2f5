"""The port's continuous-batching `ServeLoop` on the CPU, mirroring
tests/test_serve_loop.py: full / deadline / drain flushes, multi-model
routing, admission control, best-c selection, capacity banks, hot-swap
version ordering, `SwapCapacityError`, retry and quarantine, and the
Poisson load generator. In place of the JAX package's "zero recompiles
across a swap", the port pins that every bank tensor keeps its storage
across warm-up, traffic and swaps and that no kernel library is loaded
after warm-up. Margins are held to the port's own scorer and to the JAX loop's
scorer on the same bank: rtol 1e-5, atol 1e-5.
"""
import importlib
import threading
import time

import numpy as np
import pytest
import torch

from repro.serve.loop import ServeLoop as JServeLoop
from repro_torch.kernels import build
from repro_torch.serve import artifact as art
from repro_torch.serve.loop import (ServeLoop, ServeOverload, SlotQuarantined,
                                    SwapCapacityError, _bank_capacity,
                                    drive_poisson)

tpredict = importlib.import_module("repro_torch.serve.predict")
loop_mod = importlib.import_module("repro_torch.serve.loop")
ModelBank = tpredict.ModelBank
margins_dense = tpredict.margins_dense

RNG = np.random.default_rng(13)
MTOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")


def _binary_family(n, nnz, seed=0, scale=1.0, meta=None, mod=art):
    rng = np.random.default_rng(seed)
    w = np.zeros(n, np.float64)
    w[rng.choice(n, nnz, replace=False)] = scale * rng.standard_normal(nnz)
    m = mod.artifact_from_solution(w, "logistic", c=1.0,
                                   bias=float(rng.standard_normal()),
                                   meta=meta or {})
    return mod.ModelFamily(kind="binary", models=(m,))


def _path_family(n, metas, seed=0):
    rng = np.random.default_rng(seed)
    sup = rng.choice(n, len(metas), replace=False)
    models = []
    for i, meta in enumerate(metas):
        w = np.zeros(n, np.float64)
        w[sup[:i + 1]] = rng.standard_normal(i + 1)
        models.append(art.artifact_from_solution(
            w, "logistic", c=float(2.0 ** i), meta=dict(meta, nnz=i + 1)))
    return art.ModelFamily(kind="path", models=tuple(models))


def _score(bank, X):
    return margins_dense(bank, np.asarray(X, np.float32)).numpy()


def test_bank_capacity_headroom():
    fam = _path_family(64, [{"val_accuracy": 0.7}, {"val_accuracy": 0.8},
                            {"val_accuracy": 0.9}])
    assert _bank_capacity(fam, 2.0) == (6, 6)


def test_loop_full_and_deadline_and_drain_flushes():
    fam = _binary_family(32, 5, seed=7)
    with ServeLoop(fam, buckets=(4,), default_budget_s=10.0, **CPU) as loop:
        X = RNG.standard_normal((4, 32)).astype(np.float32)
        futs = loop.submit_many(X)
        res = [f.result(timeout=30) for f in futs]
        assert all(r.flush_reason == "full" and r.bucket == 4 for r in res)
        np.testing.assert_allclose(np.stack([r.margins for r in res]),
                                   _score(loop.bank(), X), **MTOL)
        r1 = loop.submit(X[0], budget_s=0.05).result(timeout=30)
        assert r1.flush_reason == "deadline"
        assert r1.latency_s <= 5.0
        f_last = loop.submit(X[1], budget_s=10.0)
    assert f_last.result(timeout=30).flush_reason == "drain"
    st = loop.stats()["models"]["default"]
    assert st["flushes"] == {"full": 1, "deadline": 1, "drain": 1}
    assert loop.stats()["responses"] == 6


def test_loop_margins_match_the_reference_loop():
    """One request batch through both packages' loops: same margins."""
    from repro.serve import artifact as jart
    X = RNG.standard_normal((6, 40)).astype(np.float32)
    outs = []
    for Loop, mod, kw in ((ServeLoop, art, CPU), (JServeLoop, jart, {})):
        with Loop(_binary_family(40, 6, seed=3, mod=mod), buckets=(2, 8),
                  default_budget_s=0.02, **kw) as loop:
            outs.append(np.stack([f.result(timeout=30).margins
                                  for f in loop.submit_many(X)]))
    np.testing.assert_allclose(outs[0], outs[1], **MTOL)


def test_loop_multi_model_routing_and_validation():
    fams = {"a": _binary_family(24, 4, seed=1),
            "b": _binary_family(40, 6, seed=2)}
    with ServeLoop(fams, buckets=(1, 2), default_budget_s=0.05,
                   **CPU) as loop:
        assert loop.models() == ("a", "b")
        xa = RNG.standard_normal(24).astype(np.float32)
        xb = RNG.standard_normal(40).astype(np.float32)
        ra = loop.submit(xa, model="a").result(timeout=30)
        rb = loop.submit(xb, model="b").result(timeout=30)
        assert ra.model == "a" and rb.model == "b"
        np.testing.assert_allclose(ra.margins,
                                   _score(loop.bank("a"), xa[None])[0],
                                   **MTOL)
        with pytest.raises(ValueError, match="pick one"):
            loop.submit(xa)
        with pytest.raises(KeyError, match="unknown model"):
            loop.submit(xa, model="zzz")
        with pytest.raises(ValueError, match="features"):
            loop.submit(xa, model="b")


def test_loop_overload_admission_control():
    fam = _binary_family(16, 3, seed=9)
    with ServeLoop(fam, buckets=(8,), default_budget_s=30.0, max_queue=4,
                   **CPU) as loop:
        X = RNG.standard_normal((8, 16)).astype(np.float32)
        futs = [loop.submit(x) for x in X[:4]]
        with pytest.raises(ServeOverload):
            loop.submit(X[4])
        assert loop.stats()["rejects"] == 1
    assert all(f.result(timeout=30).flush_reason == "drain" for f in futs)


@pytest.mark.parametrize("route", ["sparse", "dense"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_swap_keeps_bank_storage_and_loads_no_library(route, use_kernels):
    """The port's counterpart of "zero recompiles across a swap": every
    bank tensor (and the densified stack of the dense route) keeps its
    storage across warm-up, traffic and a swap, and the swap's margins
    come from the new weights."""
    fam = _binary_family(48, 6, seed=11)
    new = _binary_family(48, 9, seed=12)
    X = RNG.standard_normal((16, 48)).astype(np.float32)
    with ServeLoop(fam, buckets=(1, 2, 4), default_budget_s=0.02,
                   route=route, use_kernels=use_kernels, **CPU) as loop:
        ptrs = loop.storage_ptrs()
        libs = build.loaded()
        for f in loop.submit_many(X[:5]):
            f.result(timeout=30)
        assert loop.storage_ptrs() == ptrs
        ticket = loop.swap(model=new)
        assert ticket.installed.wait(timeout=30)
        assert ticket.version == 2
        res = [f.result(timeout=30) for f in loop.submit_many(X[5:])]
        assert loop.storage_ptrs() == ptrs
        assert build.loaded() == libs
        assert loop.libraries_loaded_since_warmup() == ()
        assert {r.version for r in res} == {2}
        want = ModelBank.from_family(new, a_cap=loop.bank().a_max,
                                     u_cap=int(loop.bank().union_idx.shape[0]),
                                     **CPU)
        np.testing.assert_allclose(np.stack([r.margins for r in res]),
                                   _score(want, X[5:]), **MTOL)
        if route == "dense":
            np.testing.assert_array_equal(
                loop.bank().dense_matrix().numpy(),
                want.dense_matrix().numpy())
        st = loop.stats()
        assert st["models"]["default"]["installs"] == 1
        assert st["libraries_loaded_since_warmup"] == []


def test_hot_swap_responses_match_version_at_flush_time():
    n = 40
    fams = [_binary_family(n, 5, seed=21 + v, scale=1.0 + v)
            for v in range(3)]
    caps = _bank_capacity(fams[0], 2.0)
    ref_banks = {v + 1: ModelBank.from_family(f, a_cap=caps[0],
                                              u_cap=caps[1], **CPU)
                 for v, f in enumerate(fams)}
    X = RNG.standard_normal((60, n)).astype(np.float32)
    results, errors = [], []
    with ServeLoop(fams[0], buckets=(1, 2, 4), default_budget_s=0.01,
                   **CPU) as loop:
        def swapper():
            for f in fams[1:]:
                time.sleep(0.02)
                loop.swap(model=f).installed.wait(timeout=30)
        th = threading.Thread(target=swapper)
        th.start()
        for x in X:
            try:
                results.append(loop.submit(x).result(timeout=30))
            except Exception as e:            # pragma: no cover
                errors.append(e)
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors and len(results) == len(X)
    seen = sorted({r.version for r in results})
    assert seen[0] == 1 and seen[-1] == 3
    versions = [r.version for r in results]
    assert versions == sorted(versions)         # installs are ordered
    for i, r in enumerate(results):
        np.testing.assert_allclose(r.margins,
                                   _score(ref_banks[r.version],
                                          X[i][None])[0],
                                   err_msg=f"request {i}", **MTOL)


def test_swap_from_path_family_picks_best_c():
    fam0 = _binary_family(64, 4, seed=31)
    path = _path_family(64, [{"val_accuracy": 0.6}, {"val_accuracy": 0.95},
                             {"val_accuracy": 0.8}], seed=32)
    _, best = art.pick_best_c(path)
    with ServeLoop(fam0, buckets=(1,), default_budget_s=0.02,
                   **CPU) as loop:
        loop.swap(model=path).installed.wait(timeout=30)
        x = RNG.standard_normal(64).astype(np.float32)
        r = loop.submit(x).result(timeout=30)
        want = float(x @ best.dense_weights(np.float64) + best.bias)
        assert r.version == 2
        np.testing.assert_allclose(r.margins, [want], rtol=1e-4, atol=1e-4)


def test_swap_capacity_error():
    fam0 = _binary_family(64, 4, seed=41)
    too_big = _binary_family(64, 30, seed=42)
    with ServeLoop(fam0, buckets=(1,), capacity_factor=2.0, **CPU) as loop:
        with pytest.raises(SwapCapacityError):
            loop.swap(model=too_big)
        with pytest.raises(SwapCapacityError, match="do not match"):
            loop.swap(model=ModelBank.from_dense(
                np.ones((2, 64), np.float32), **CPU))
        assert loop.version() == 1


def test_drive_poisson_accounts_offered_load():
    fam = _binary_family(32, 4, seed=51)
    X = RNG.standard_normal((16, 32)).astype(np.float32)
    with ServeLoop(fam, buckets=(1, 2, 4, 8), default_budget_s=0.25,
                   max_queue=64, **CPU) as loop:
        out = drive_poisson(loop, X, rate_rps=300.0, n_requests=60, seed=3,
                            timeout_s=60.0)
    assert out["responses"] + out["rejects"] == out["n_requests"] == 60
    assert len(out["results"]) == out["responses"]
    if out["responses"]:
        assert out["p99_s"] >= out["p50_s"] > 0
    with pytest.raises(ValueError, match="rate_rps"):
        drive_poisson(None, X, rate_rps=0.0, n_requests=1)


def test_batch_retry_recovers_transient_failure(monkeypatch):
    fam = _binary_family(32, 5, seed=3)
    boom = {"left": 1}

    def flaky(bank, X, **kw):
        if boom["left"]:
            boom["left"] -= 1
            raise RuntimeError("transient device loss")
        return margins_dense(bank, X, **kw)

    with ServeLoop(fam, buckets=(1,), default_budget_s=0.05,
                   batch_retries=2, **CPU) as loop:
        x = RNG.standard_normal(32).astype(np.float32)
        monkeypatch.setattr(loop_mod, "margins_dense", flaky)
        r = loop.submit(x).result(timeout=30)
        np.testing.assert_allclose(r.margins, _score(loop.bank(),
                                                     x[None])[0], **MTOL)
        st = loop.stats()["models"]["default"]
        assert (st["retries"], st["failed_batches"],
                st["consecutive_failures"]) == (1, 0, 0)
        assert not st["quarantined"] and loop.stats()["errors"] == 0


def test_quarantine_after_consecutive_failures_and_swap_clears(monkeypatch):
    fam = _binary_family(32, 5, seed=4)

    def broken(bank, X, **kw):
        raise RuntimeError("wedged scorer")

    with ServeLoop(fam, buckets=(1,), default_budget_s=0.05,
                   batch_retries=0, quarantine_after=2, **CPU) as loop:
        x = RNG.standard_normal(32).astype(np.float32)
        monkeypatch.setattr(loop_mod, "margins_dense", broken)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="wedged"):
                loop.submit(x).result(timeout=30)
        st = loop.stats()["models"]["default"]
        assert st["failed_batches"] == st["consecutive_failures"] == 2
        assert st["quarantined"]
        with pytest.raises(SlotQuarantined, match="quarantined after 2"):
            loop.submit(x)
        monkeypatch.setattr(loop_mod, "margins_dense", margins_dense)
        assert loop.swap(model=_binary_family(32, 7, seed=5)) \
            .installed.wait(timeout=30)
        r = loop.submit(x).result(timeout=30)
        st = loop.stats()["models"]["default"]
        assert not st["quarantined"] and st["consecutive_failures"] == 0
        assert r.version == 2


def test_failure_streak_resets_on_success(monkeypatch):
    fam = _binary_family(24, 4, seed=6)
    fail_next = {"on": True}

    def sometimes(bank, X, **kw):
        if fail_next["on"]:
            raise RuntimeError("blip")
        return margins_dense(bank, X, **kw)

    with ServeLoop(fam, buckets=(1,), default_budget_s=0.05,
                   batch_retries=0, quarantine_after=2, **CPU) as loop:
        x = RNG.standard_normal(24).astype(np.float32)
        monkeypatch.setattr(loop_mod, "margins_dense", sometimes)
        with pytest.raises(RuntimeError):
            loop.submit(x).result(timeout=30)
        fail_next["on"] = False
        loop.submit(x).result(timeout=30)
        fail_next["on"] = True
        with pytest.raises(RuntimeError):
            loop.submit(x).result(timeout=30)
        st = loop.stats()["models"]["default"]
        assert st["failed_batches"] == 2
        assert st["consecutive_failures"] == 1
        assert not st["quarantined"]


def test_quarantine_disabled_and_param_validation(monkeypatch):
    fam = _binary_family(16, 3, seed=8)

    def broken(bank, X, **kw):
        raise RuntimeError("always down")

    with ServeLoop(fam, buckets=(1,), default_budget_s=0.05,
                   batch_retries=0, quarantine_after=None, **CPU) as loop:
        x = RNG.standard_normal(16).astype(np.float32)
        monkeypatch.setattr(loop_mod, "margins_dense", broken)
        for _ in range(4):
            with pytest.raises(RuntimeError):
                loop.submit(x).result(timeout=30)
        assert not loop.stats()["models"]["default"]["quarantined"]
    with pytest.raises(ValueError, match="batch_retries"):
        ServeLoop(fam, buckets=(1,), batch_retries=-1, **CPU)
    with pytest.raises(ValueError, match="quarantine_after"):
        ServeLoop(fam, buckets=(1,), quarantine_after=0, **CPU)
    with pytest.raises(ValueError, match="route"):
        ServeLoop(fam, buckets=(1,), route="csc", **CPU)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeLoop(_binary_family(8, 2), buckets=(1,))
