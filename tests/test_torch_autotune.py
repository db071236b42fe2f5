"""The port's kernel autotuner (`repro_torch.kernels.autotune`) and the
launch plans of `repro_torch.kernels.ops` that resolve through it, on the
CPU: parity of the bucketing and of `tune` with the reference's module,
the robustness contract of tests/test_autotune.py case for case, and the
plans (a cold cache gives each rule's plan; a cached winner changes it; a
bucket-mate shape that cannot take the winner gets the rule and counts
`autotune.infeasible`; no syscall after a shape's first resolution; no
search space names a plain version). No solves."""
import json
import os

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro_torch import obs
from repro_torch.kernels import autotune, ops

CPU = torch.device("cpu")
F32 = torch.float32


@pytest.fixture
def tuned_env(tmp_path, monkeypatch):
    """Autotuning ON against a private empty cache file."""
    cache = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(cache))
    autotune.invalidate_cache()
    yield cache
    autotune.invalidate_cache()


@pytest.fixture
def metrics():
    obs.registry.reset()
    obs.enable(metrics=True)
    yield obs.registry.get_registry()
    obs.disable()
    obs.registry.reset()


# -- bucketing / keys: parity with the reference ------------------------------

@pytest.mark.parametrize("x", [0, 1, 2, 3, 5, 8, 9, 100, 1000, 1024, 1025,
                               57_848, 20_958, 2 ** 20 + 1])
def test_next_pow2_matches_reference(x):
    assert autotune.next_pow2(x) == jautotune.next_pow2(x)


@pytest.mark.parametrize("dims", [
    dict(s=1000, p=37), dict(p=33, s=513),
    dict(p=32, k=278, s=57_848, q=40), dict(p=512, k=278, s=57_848),
    dict(s=6000, p=512), dict(b=256, n=20_958, k=8, a=10_901),
    dict(n=20_958, kmax=6, k=8, a=10_901, b=256), dict(p=64, s=6000, q=40),
    dict(p=8, k=278, q=40, s=57_848), dict(s=1)])
def test_shape_bucket_matches_reference(dims):
    assert autotune.shape_bucket(**dims) == jautotune.shape_bucket(**dims)


def test_shape_bucket_is_order_insensitive():
    assert autotune.shape_bucket(s=1000, p=37) == \
        autotune.shape_bucket(p=33, s=513)


def test_cache_key_distinguishes_dtype_backend_and_source():
    b = autotune.shape_bucket(s=256)
    k1 = autotune.cache_key("pcdn_direction", b, torch.float32, "cuda-sm90")
    k2 = autotune.cache_key("pcdn_direction", b, torch.bfloat16, "cuda-sm90")
    k3 = autotune.cache_key("pcdn_direction", b, torch.float32, "cuda-sm80")
    k4 = autotune.cache_key("pcdn_bundle", b, torch.float32, "cuda-sm90")
    assert len({k1, k2, k3, k4}) == 4
    from repro_torch.kernels import build
    assert k1.endswith("|" + build._digest("pcdn_direction"))
    assert "|float32|" in k1 and "|bfloat16|" in k2


def test_backend_tag_on_cpu_and_default_cache_path(monkeypatch):
    assert autotune.backend_tag(CPU) == "cpu"
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    assert autotune.cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


# -- cache round trip and fallback --------------------------------------------

BUCKET = autotune.shape_bucket(s=6000, p=512)
WINNER = {"cc": 24, "tile": 1024, "resident": False}


def test_cache_round_trip(tuned_env):
    assert autotune.record("pcdn_direction", BUCKET, F32, WINNER,
                           us=10.0, default_us=20.0, backend="cuda-sm90")
    assert tuned_env.exists()
    assert autotune.lookup("pcdn_direction", BUCKET, F32,
                           backend="cuda-sm90") == WINNER
    # a different bucket, dtype or backend misses
    assert autotune.lookup("pcdn_direction",
                           autotune.shape_bucket(s=20_000, p=512), F32,
                           backend="cuda-sm90") is None
    assert autotune.lookup("pcdn_direction", BUCKET, torch.bfloat16,
                           backend="cuda-sm90") is None
    assert autotune.lookup("pcdn_direction", BUCKET, F32,
                           backend="cpu") is None


def test_corrupt_cache_falls_back_to_defaults(tuned_env):
    tuned_env.write_text("{ not json !!!")
    autotune.invalidate_cache()
    assert autotune.lookup("pcdn_direction", BUCKET, F32) is None
    assert autotune.resolve("pcdn_direction", BUCKET, F32) == \
        autotune.DEFAULTS["pcdn_direction"]


def test_wrong_version_cache_ignored(tuned_env):
    key = autotune.cache_key("pcdn_direction", BUCKET, F32, "cpu")
    tuned_env.write_text(json.dumps({"version": 999, "entries": {
        key: {"config": {"cc": 24}}}}))
    autotune.invalidate_cache()
    assert autotune.lookup("pcdn_direction", BUCKET, F32,
                           backend="cpu") is None


@pytest.mark.parametrize("config", [
    {"cc": 24, "block_retired_axis": 4},   # a key outside the space
    {"cc": 999},                           # a value not a candidate
    {"cc": 24.0},                          # a float for an int
    {"resident": True},                    # only False overrides
    {"resident": 0},                       # 0 is not False
    {"impl": "xla"},                       # the reference's plain route
    "not a dict"])
def test_stale_entry_falls_back_to_defaults(tuned_env, config):
    """Configs written by an older search space (unknown keys, values no
    longer candidates, wrong types) resolve to the defaults, and the plan
    to the rule's."""
    key = autotune.cache_key("pcdn_direction", BUCKET, F32, "cpu")
    tuned_env.write_text(json.dumps({"version": autotune.CACHE_VERSION,
                                     "entries": {key: {"config": config}}}))
    autotune.invalidate_cache()
    assert autotune.lookup("pcdn_direction", BUCKET, F32,
                           backend="cpu") is None
    assert autotune.resolve("pcdn_direction", BUCKET, F32,
                            backend="cpu") == \
        autotune.DEFAULTS["pcdn_direction"]
    assert _k3(6000, 512) == ops.direction_plan(6000, 512, 4, 15)


def test_stale_digest_misses(tuned_env):
    """An entry tuned for another build of the source is not read."""
    key = autotune.cache_key("pcdn_direction", BUCKET, F32, "cpu")
    stale = key.rsplit("|", 1)[0] + "|0000000000000000"
    tuned_env.write_text(json.dumps({"version": autotune.CACHE_VERSION,
                                     "entries": {stale: {"config": WINNER}}}))
    autotune.invalidate_cache()
    assert autotune.lookup("pcdn_direction", BUCKET, F32,
                           backend="cpu") is None


def test_autotune_off_ignores_cache(tuned_env, monkeypatch):
    autotune.record("pcdn_direction", BUCKET, F32, WINNER, backend="cpu")
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    autotune.invalidate_cache()
    assert autotune.lookup("pcdn_direction", BUCKET, F32,
                           backend="cpu") is None
    assert _k3(6000, 512) == ops.direction_plan(6000, 512, 4, 15)


def test_record_unwritable_path_returns_false(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                       "/proc/definitely/not/writable/cache.json")
    autotune.invalidate_cache()
    ok = autotune.record("pcdn_direction", BUCKET, F32, WINNER,
                         backend="cpu")
    autotune.invalidate_cache()
    assert ok is False


def test_record_keeps_entries_it_does_not_own(tuned_env):
    tuned_env.write_text(json.dumps({"version": autotune.CACHE_VERSION,
                                     "entries": {"foreign|x": {"a": 1}}}))
    autotune.invalidate_cache()
    assert autotune.record("scdn_batch", autotune.shape_bucket(p=8),
                           F32, {"cluster": 4}, backend="cpu")
    entries = json.loads(tuned_env.read_text())["entries"]
    assert entries["foreign|x"] == {"a": 1} and len(entries) == 2


# -- resolve precedence -------------------------------------------------------

def test_resolve_precedence(tuned_env):
    """defaults <- cached winner <- non-None overrides."""
    assert autotune.resolve("pcdn_direction", BUCKET, F32, backend="cpu") \
        == autotune.DEFAULTS["pcdn_direction"]
    autotune.record("pcdn_direction", BUCKET, F32, WINNER, backend="cpu")
    cached = autotune.resolve("pcdn_direction", BUCKET, F32, backend="cpu")
    assert cached == WINNER
    over = autotune.resolve("pcdn_direction", BUCKET, F32,
                            {"cc": 8, "tile": None}, backend="cpu")
    assert over == {"cc": 8, "tile": 1024, "resident": False}


# -- tune (a deterministic fake timer) ----------------------------------------

def _fake_cost(cfg):
    """Deterministic synthetic cost surface with its optimum off the
    default: more columns a cluster is better, a streamed plan better, a
    larger tile better."""
    us = 100.0
    us -= (cfg.get("cc") or 0) / 2.0
    if cfg.get("resident") is False:
        us -= 10.0
    us -= (cfg.get("tile") or 0) / 1000.0
    return us


@pytest.mark.parametrize("strategy", ["exhaustive", "hillclimb"])
def test_tune_finds_winner_and_persists(tuned_env, monkeypatch, strategy):
    monkeypatch.setattr(autotune, "time_call",
                        lambda fn, repeats=5, warmup=1, device=None: fn())
    res = autotune.tune("pcdn_direction", lambda cfg: lambda: _fake_cost(cfg),
                        BUCKET, F32, strategy=strategy, backend="faketest",
                        device="cuda")
    # separable, so both strategies find the global optimum
    assert res.config == {"cc": 64, "tile": 4096, "resident": False}
    assert res.us <= res.default_us and res.speedup >= 1.0
    assert res.trajectory[0]["config"] == \
        autotune.DEFAULTS["pcdn_direction"]
    assert autotune.lookup("pcdn_direction", BUCKET, F32,
                           backend="faketest") == res.config
    entry, = json.loads(tuned_env.read_text())["entries"].values()
    assert entry["margin"] == res.margin == autotune.MIN_MARGIN


def test_tune_skips_infeasible_candidates(tuned_env, monkeypatch):
    monkeypatch.setattr(autotune, "time_call",
                        lambda fn, repeats=5, warmup=1, device=None: fn())

    def runner(cfg):
        if cfg["resident"] is False:
            raise ValueError("infeasible at this shape")
        return lambda: _fake_cost(cfg)

    res = autotune.tune("pcdn_direction", runner, BUCKET, F32,
                        persist=False)
    assert res.config["resident"] is None
    assert res.skipped == 9 * 5        # every cc x tile with resident False


def test_tune_refuses_to_persist_a_cpu_time(tuned_env, monkeypatch):
    monkeypatch.setattr(autotune, "time_call",
                        lambda fn, repeats=5, warmup=1, device=None: fn())
    with pytest.raises(ValueError, match="CPU"):
        autotune.tune("scdn_batch", lambda cfg: lambda: 1.0,
                      autotune.shape_bucket(p=8), F32, backend="cpu")
    # operands on the CPU are refused under a card's backend tag too
    for device in (None, "cpu"):
        with pytest.raises(ValueError, match="CPU"):
            autotune.tune("scdn_batch", lambda cfg: lambda: 1.0,
                          autotune.shape_bucket(p=8), F32,
                          backend="cuda-sm90", device=device)
    assert not tuned_env.exists()


def _timed(us, spread=None):
    t = autotune.Timing(us)
    t.spread = spread
    return t


@pytest.mark.parametrize("strategy", ["exhaustive", "hillclimb"])
@pytest.mark.parametrize("gain,spread,taken", [
    (0.02, None, False),         # inside MIN_MARGIN: the rule stays
    (0.05, None, True),          # beyond it: the candidate is taken
    (0.05, 0.08, False),         # inside the default's own wider spread
    (0.10, 0.08, True)])
def test_tune_takes_a_candidate_only_beyond_the_margin(
        tuned_env, monkeypatch, strategy, gain, spread, taken):
    """A candidate replaces the rule only when it is faster by more than
    max(MIN_MARGIN, the default's spread); the margin is recorded."""
    monkeypatch.setattr(autotune, "time_call",
                        lambda fn, repeats=5, warmup=1, device=None: fn())

    def runner(cfg):
        if cfg == {"cluster": None}:
            return lambda: _timed(10.0, spread)
        return lambda: _timed(10.0 * (1 - gain) if cfg["cluster"] == 3
                              else 10.0 * (1 + gain))

    res = autotune.tune("scdn_batch", runner, autotune.shape_bucket(p=8),
                        F32, strategy=strategy, backend="faketest",
                        device="cuda")
    want = {"cluster": 3} if taken else {"cluster": None}
    assert res.config == want
    assert res.margin == max(autotune.MIN_MARGIN, spread or 0.0)
    entry, = json.loads(tuned_env.read_text())["entries"].values()
    assert entry["config"] == want and entry["margin"] == res.margin


def test_hillclimb_steps_each_beat_the_margin(monkeypatch):
    """Each step of the climb must beat the current config by the margin:
    gains that stay inside it, however many, do not move the climb."""
    monkeypatch.setattr(autotune, "time_call",
                        lambda fn, repeats=5, warmup=1, device=None: fn())
    monkeypatch.setitem(autotune.DEFAULTS, "faketest", {"a": 0})
    monkeypatch.setitem(autotune.SEARCH_SPACES, "faketest",
                        {"a": (0, 1, 2, 3, 4)})

    def runner(cfg):
        return lambda: 100.0 * 0.995 ** cfg["a"]     # 2% at a = 4

    res = autotune.tune("faketest", runner, (("a", 1),), "float32",
                        strategy="hillclimb", persist=False)
    assert res.config == {"a": 0} and len(res.trajectory) == 1
    monkeypatch.setattr(autotune, "MIN_MARGIN", 0.0)
    exact = autotune.tune("faketest", runner, (("a", 1),), "float32",
                          strategy="hillclimb", persist=False)
    assert exact.config == {"a": 4} and exact.margin == 0.0


SPACE = {"a": (1, 2, 3, 4), "b": (None, 8, 16), "c": ("x", "y")}
SPACE_DEFAULT = {"a": 1, "b": None, "c": "x"}


def _surface(cfg):
    """Not separable: the climb stops at a local optimum the exhaustive
    search passes by, so both strategies are held to their own result."""
    us = 50.0 + 3 * cfg["a"] - (cfg["b"] or 0) / 4.0
    if cfg["c"] == "y":
        us -= 6.0 if cfg["a"] >= 3 else -1.0
    return us


@pytest.mark.parametrize("strategy", ["exhaustive", "hillclimb"])
def test_tune_matches_reference(monkeypatch, strategy):
    """One search space, one fake timer: the reference's and the port's
    tune give the same winner, table and trajectory."""
    # the reference's strict minimum is the port's margin 0
    monkeypatch.setattr(autotune, "MIN_MARGIN", 0.0)
    results = []
    for mod in (jautotune, autotune):
        monkeypatch.setitem(mod.DEFAULTS, "faketest", dict(SPACE_DEFAULT))
        monkeypatch.setitem(mod.SEARCH_SPACES, "faketest", dict(SPACE))
        monkeypatch.setattr(mod, "time_call",
                            lambda fn, repeats=5, warmup=1, device=None: fn())

        def runner(cfg):
            if cfg["a"] == 2 and cfg["b"] == 16:
                raise ValueError("infeasible")
            return lambda: _surface(cfg)

        results.append(mod.tune("faketest", runner, (("a", 1),), "float32",
                                strategy=strategy, persist=False))
    ref, port = results
    assert port.config == ref.config
    assert port.us == ref.us and port.default_us == ref.default_us
    assert [(r["config"], r["us"]) for r in port.table] == \
        [(r["config"], r["us"]) for r in ref.table]
    assert list(port.trajectory) == list(ref.trajectory)


def test_time_call_on_the_cpu_is_a_host_median():
    calls = []
    t = autotune.time_call(lambda: calls.append(1), repeats=3, warmup=2)
    assert len(calls) == 5 and t >= 0.0 and t.warm_us is None
    assert t.spread is not None and t.spread >= 0.0


@pytest.mark.parametrize("device", [None, "cpu", CPU])
def test_time_call_clock_follows_the_operands(monkeypatch, device):
    """With a card present, a call on CPU operands is still timed on the
    host clock (CUDA events around host work would read about 0)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_card(*a, **k):
        raise AssertionError("a CUDA call for CPU operands")

    monkeypatch.setattr(torch.cuda, "synchronize", no_card)
    monkeypatch.setattr(torch.cuda, "Event", no_card)
    t = autotune.time_call(lambda: sum(range(100)), repeats=3,
                           device=device)
    assert t > 0.0 and t.warm_us is None


# -- the plans ----------------------------------------------------------------

def _k1(P, K=278, s=57_848, n=20_958, Q=40, dtype=F32):
    return ops.tuned_plan("pcdn_bundle", ops.bundle_plan, (P, K, s, n, Q),
                          (P, K, s, Q), dtype, CPU)


def _k2(P, K=278, m=57_848, dtype=F32):
    return ops.tuned_plan("pcdn_sparse_direction",
                          ops.sparse_direction_warps, (K,), (P, K, m),
                          dtype, CPU)


def _k3(s, P, itemsize=4, clusters=15, dtype=F32):
    return ops.tuned_plan("pcdn_direction", ops.direction_plan,
                          (s, P, itemsize, clusters), (s, P), dtype, CPU)


def _k4a(B, n=20_958, K=8, A=10_901, sms=132):
    return ops.tuned_plan("serve_margins_dense", ops.dense_tile_width,
                          (B, n, K, sms), (B, n, K, A), F32, CPU)


def _k4b(B, K=8, A=10_901, k_max=6, n=20_958):
    return ops.tuned_plan("serve_margins_csc", ops.csc_plan,
                          (B, K, A, k_max), (n, k_max, K, A, B), F32, CPU)


def _k5(s, P, Q=40, sms=132):
    return ops.tuned_plan("pcdn_linesearch", ops.linesearch_blocks,
                          (s, P, sms), (s, P, Q), F32, CPU)


def _k5b(P, K=278, Q=40, s=57_848):
    return ops.tuned_plan("scdn_batch", ops.scdn_batch_plan, (P, K, Q, s),
                          (P, K, Q, s), F32, CPU)


def _k5d(P, s=6000, Q=40, sms=132):
    return ops.tuned_plan("scdn_dense_batch", ops.scdn_dense_plan,
                          (P, s, Q, sms), (P, s, Q), F32, CPU)


# (key, resolved plan at a shape, the rule's plan there) over a grid
PLAN_GRID = (
    [("pcdn_bundle", lambda P=P, K=K: _k1(P, K),
      lambda P=P, K=K: ops.bundle_plan(P, K, 57_848, 20_958, 40))
     for P in (1, 8, 32, 64, 512) for K in (1, 16, 278)] +
    [("pcdn_sparse_direction", lambda K=K: _k2(512, K),
      lambda K=K: ops.sparse_direction_warps(K)) for K in (1, 64, 65, 278)] +
    [("pcdn_direction", lambda s=s, P=P, i=i: _k3(s, P, i),
      lambda s=s, P=P, i=i: ops.direction_plan(s, P, i, 15))
     for s in (1, 100, 6000, 60_000) for P in (1, 392, 512) for i in (2, 4)]
    + [("serve_margins_dense", lambda B=B: _k4a(B),
        lambda B=B: ops.dense_tile_width(B, 20_958, 8, 132))
       for B in (1, 64, 256, 4096)] +
    [("serve_margins_csc", lambda B=B: _k4b(B),
      lambda B=B: ops.csc_plan(B, 8, 10_901, 6)) for B in (1, 256, 70_000)]
    + [("pcdn_linesearch", lambda s=s, P=P: _k5(s, P),
        lambda s=s, P=P: ops.linesearch_blocks(s, P, 132))
       for s in (10, 6000, 57_848) for P in (1, 8, 64)] +
    [("scdn_batch", lambda P=P: _k5b(P),
      lambda P=P: ops.scdn_batch_plan(P, 278, 40, 57_848))
     for P in (1, 5, 8, 16)] +
    [("scdn_dense_batch", lambda P=P, s=s: _k5d(P, s),
      lambda P=P, s=s: ops.scdn_dense_plan(P, s, 40, 132))
     for P in (1, 8, 64, 200) for s in (100, 6000, 100_000)])


@pytest.mark.parametrize("kernel", sorted(autotune.DEFAULTS))
def test_cold_cache_gives_the_rule(tuned_env, kernel):
    """An empty cache (REPRO_AUTOTUNE on) gives each plan function's rule
    over a grid of shapes."""
    cases = [(got, want) for k, got, want in PLAN_GRID if k == kernel]
    assert cases
    for got, want in cases:
        assert got() == want()


@pytest.mark.parametrize("kernel", sorted(autotune.DEFAULTS))
def test_autotune_off_gives_the_rule(monkeypatch, kernel):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    autotune.invalidate_cache()
    try:
        for k, got, want in PLAN_GRID:
            if k == kernel:
                assert got() == want()
    finally:
        autotune.invalidate_cache()


def test_defaults_are_the_rule_and_spaces_hold_it():
    for kernel, default in autotune.DEFAULTS.items():
        assert set(default) == set(autotune.SEARCH_SPACES[kernel]), kernel
        assert all(v is None for v in default.values()), kernel
        for axis, cands in autotune.SEARCH_SPACES[kernel].items():
            assert cands[0] is None, (kernel, axis)
    assert set(autotune.DEFAULTS) == set(autotune.BUCKET_AXES)


def test_no_search_space_names_a_plain_version():
    for kernel, space in autotune.SEARCH_SPACES.items():
        assert "impl" not in space, kernel
        for axis, cands in space.items():
            for v in cands:
                assert not isinstance(v, str), (kernel, axis, v)


# (key, bucket dims, a winner, the resolved plan at the tuned shape, what
# the winner changes there)
WINNERS = [
    ("pcdn_bundle", dict(p=32, k=278, s=57_848, q=40),
     {"cluster": 4, "nseg": 2}, lambda: _k1(32),
     lambda p: (p.cluster, p.nseg) == (4, 2)),
    ("pcdn_sparse_direction", dict(p=512, k=278, s=57_848), {"warps": 2},
     lambda: _k2(512), lambda w: w == 2),
    ("pcdn_direction", dict(s=6000, p=512), {"cc": 24, "resident": False},
     lambda: _k3(6000, 512),
     lambda p: (p.cc, p.ctas, p.resident, p.tile) == (24, 176, False, 752)),
    ("serve_margins_dense", dict(b=256, n=20_958, k=8, a=10_901),
     {"width": 640}, lambda: _k4a(256), lambda w: w == 640),
    ("serve_margins_csc", dict(n=20_958, kmax=6, k=8, a=10_901, b=256),
     {"cluster": 3}, lambda: _k4b(256), lambda p: p.cluster == 3),
    ("pcdn_linesearch", dict(s=6000, p=64, q=40), {"blocks": 16},
     lambda: _k5(6000, 64), lambda b: b == 16),
    ("scdn_batch", dict(p=8, k=278, q=40, s=57_848), {"cluster": 2},
     lambda: _k5b(8), lambda p: (p.cluster, p.cpc) == (2, 4)),
    ("scdn_dense_batch", dict(p=64, s=6000, q=40),
     {"cluster": 4, "clusters": 32}, lambda: _k5d(64),
     lambda p: (p.cluster, p.clusters, p.cpc, p.sl) == (4, 32, 2, 1500)),
]


@pytest.mark.parametrize("kernel,dims,winner,plan,changed", WINNERS,
                         ids=[w[0] for w in WINNERS])
def test_cached_winner_changes_the_plan(tuned_env, kernel, dims, winner,
                                        plan, changed):
    before = plan()
    assert not changed(before)
    assert autotune.record(kernel, autotune.shape_bucket(**dims), F32,
                           winner, backend="cpu")
    # record() dropped the memoised plans: the next resolution reads it
    after = plan()
    assert changed(after), after
    assert after != before


# (key, dims of the tuned bucket, a winner legal there, a bucket mate's
# resolved plan, the bucket mate's rule)
BUCKET_MATES = [
    ("scdn_batch", dict(p=8, k=278, q=40, s=57_848), {"cluster": 8},
     lambda: _k5b(5), lambda: ops.scdn_batch_plan(5, 278, 40, 57_848)),
    ("scdn_dense_batch", dict(p=64, s=6000, q=40), {"clusters": 64},
     lambda: _k5d(40), lambda: ops.scdn_dense_plan(40, 6000, 40, 132)),
    # a streamed tile is legal where s breaks the 16-byte rows (6001), not
    # where the rule makes the plan resident (6000)
    ("pcdn_direction", dict(s=6001, p=512), {"tile": 512},
     lambda: _k3(6000, 512), lambda: ops.direction_plan(6000, 512, 4, 15)),
    ("pcdn_linesearch", dict(s=6000, p=64, q=40), {"blocks": 24},
     lambda: _k5(5000, 64), lambda: ops.linesearch_blocks(5000, 64, 132)),
]


@pytest.mark.parametrize("kernel,dims,winner,mate,rule", BUCKET_MATES,
                         ids=[m[0] for m in BUCKET_MATES])
def test_infeasible_bucket_mate_gets_the_rule(tuned_env, metrics, kernel,
                                              dims, winner, mate, rule):
    bucket = autotune.shape_bucket(**dims)
    assert autotune.record(kernel, bucket, F32, winner, backend="cpu")
    assert mate() == rule()
    assert metrics.counters.get("autotune.infeasible") == 1.0
    # memoised: the same shape is not resolved (nor counted) again
    assert mate() == rule()
    assert metrics.counters.get("autotune.infeasible") == 1.0


def test_explicit_config_is_strict():
    with pytest.raises(ValueError, match="cluster"):
        ops.scdn_batch_plan(5, 278, 40, 57_848, config={"cluster": 8})
    with pytest.raises(ValueError, match="resident"):
        ops.direction_plan(6000, 512, 4, 15, config={"tile": 512})
    with pytest.raises(ValueError, match="only False"):
        ops.direction_plan(6000, 512, 4, 15, config={"resident": True})
    with pytest.raises(ValueError, match="width"):
        ops.dense_tile_width(256, 20_958, 8, 132, config={"width": 100})
    with pytest.raises(ValueError, match="warps"):
        ops.sparse_direction_warps(278, config={"warps": 3})
    with pytest.raises(ValueError, match="power of two"):
        ops.bundle_plan(32, 278, 57_848, 20_958, 40, config={"nseg": 3})
    with pytest.raises(ValueError, match="unknown plan knobs"):
        ops.csc_plan(256, 8, 10_901, 6, config={"impl": "xla"})
    # None knobs leave the rule
    assert ops.bundle_plan(32, 278, 57_848, 20_958, 40,
                           config={"cluster": None, "nseg": None}) == \
        ops.bundle_plan(32, 278, 57_848, 20_958, 40)


@pytest.mark.parametrize("kernel", sorted(autotune.DEFAULTS))
def test_every_candidate_plans_or_refuses(kernel):
    """At the smoke's main-path shape each candidate of the space is a
    plan or a ValueError naming the limit, never another error."""
    plan_at = {
        "pcdn_bundle": lambda c: ops.bundle_plan(32, 278, 57_848, 20_958,
                                                 40, config=c),
        "pcdn_sparse_direction": lambda c: ops.sparse_direction_warps(
            278, config=c),
        "pcdn_direction": lambda c: ops.direction_plan(6000, 512, 4, 15,
                                                       config=c),
        "serve_margins_dense": lambda c: ops.dense_tile_width(
            256, 20_958, 8, 132, config=c),
        "serve_margins_csc": lambda c: ops.csc_plan(256, 8, 10_901, 6,
                                                    config=c),
        "pcdn_linesearch": lambda c: ops.linesearch_blocks(6000, 64, 132,
                                                           config=c),
        "scdn_batch": lambda c: ops.scdn_batch_plan(8, 278, 40, 57_848,
                                                    config=c),
        "scdn_dense_batch": lambda c: ops.scdn_dense_plan(64, 6000, 40, 132,
                                                          config=c),
    }[kernel]
    ok = 0
    for cfg in autotune.candidate_configs(kernel):
        try:
            plan_at(cfg)
            ok += 1
        except ValueError:
            pass
    assert ok >= 2, kernel


def test_no_stat_after_the_first_resolution(tuned_env, monkeypatch):
    autotune.record("pcdn_sparse_direction",
                    autotune.shape_bucket(p=512, k=278, s=57_848), F32,
                    {"warps": 2}, backend="cpu")
    calls = []
    real = os.stat
    monkeypatch.setattr(os, "stat",
                        lambda *a, **k: (calls.append(a), real(*a, **k))[1])
    assert _k2(512) == 2 and _k3(6000, 512).cc == 35
    first = len(calls)
    assert first >= 1                  # the first resolution read the file
    for _ in range(5):
        assert _k2(512) == 2 and _k3(6000, 512).cc == 35
        autotune.resolve("pcdn_sparse_direction",
                         autotune.shape_bucket(p=512, k=278, s=57_848), F32,
                         backend="cpu")
    assert len(calls) == first


def test_launches_on_the_cpu_take_the_resolved_plan(tuned_env):
    """BundleLaunch and the SCDN launches resolve their plan on the CPU
    too (their refusals hold there); the plain version runs whatever it
    is."""
    rng = np.random.default_rng(0)
    n, K, s = 40, 6, 50
    col_rows = torch.tensor(rng.integers(0, s, (n, K)), dtype=torch.int32)
    col_vals = torch.tensor(rng.standard_normal((n, K)), dtype=F32)
    y = torch.tensor(np.where(rng.random(s) < 0.5, -1.0, 1.0), dtype=F32)
    alphas = torch.tensor(0.5 ** np.arange(4), dtype=F32)
    rule = ops.BundleLaunch(col_rows, col_vals, y, alphas, 1.0, 8, 3).plan
    autotune.record("pcdn_bundle", autotune.shape_bucket(p=8, k=K, s=s, q=4),
                    F32, {"cluster": 5}, backend="cpu")
    tuned = ops.BundleLaunch(col_rows, col_vals, y, alphas, 1.0, 8, 3).plan
    assert (rule.cluster, tuned.cluster) == (1, 5)
    explicit = ops.ScdnBatchLaunch(col_rows, col_vals, y, alphas, 1.0, 8,
                                   config={"cluster": 2}).plan
    assert (explicit.cluster, explicit.cpc) == (2, 4)


def test_tune_measures_one_plan_once(tuned_env, monkeypatch):
    """Configs that give the rule's plan (a None knob and the value the
    rule picks) are one launch: measured once, so timing noise cannot
    make one of them the winner."""
    monkeypatch.setattr(autotune, "time_call",
                        lambda fn, repeats=5, warmup=1, device=None: fn())
    calls = []

    def runner(cfg):
        # every later measurement reads a little faster (drift)
        return lambda: (calls.append(cfg), 10.0 - 0.01 * len(calls))[1]

    def plan(cfg):
        return ops.scdn_batch_plan(8, 278, 40, 57_848, config=cfg)

    # margin 0: the drift alone, which the dedup must absorb
    monkeypatch.setattr(autotune, "MIN_MARGIN", 0.0)
    res = autotune.tune("scdn_batch", runner, autotune.shape_bucket(p=8),
                        F32, strategy="exhaustive", persist=False, plan=plan)
    configs = [r["config"] for r in res.table]
    assert {"cluster": 8} not in configs          # the rule's plan (8)
    assert len(configs) == 8                      # the rule, then 1..7
    assert res.config != {"cluster": 8}
