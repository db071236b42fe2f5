"""The dense-layout route crossover of the port: `benchmarks/port/
bench_serve.py`'s `derive_route_crossover` against the reference's
(`benchmarks/bench_serve.py`) on the same rows, and how
`repro_torch.serve.predict.route_crossover()` reads the committed H100
run (a full run's table; a smoke run, a corrupt or a missing file give
DEFAULT_ROUTE_CROSSOVER, itself the committed table). CPU only."""
import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

# the module (the package exports a function of the same name)
tpredict = importlib.import_module("repro_torch.serve.predict")

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    ref = _load("ref_bench_serve", ROOT / "benchmarks" / "bench_serve.py")
    port = _load("port_bench_serve",
                 ROOT / "benchmarks" / "port" / "bench_serve.py")
    return ref, port


def _rows(seed: int, sparsities, batches):
    rng = np.random.default_rng(seed)
    return [{"sparsity": sp, "batch": b,
             "speedup": float(rng.choice([0.5, 0.9, 1.0, 1.1, 3.0]))}
            for sp in sparsities for b in batches]


ROWS = [
    _rows(0, (0.9, 0.99, 0.999), (64, 256, 1024)),
    _rows(1, (0.5, 0.99), (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)),
    _rows(2, (0.999,), (256, 64, 1024, 16)),      # unsorted batches
    [{"sparsity": 0.9, "batch": b, "speedup": 0.2} for b in (1, 8)] +
    [{"sparsity": 0.999, "batch": b, "speedup": 4.0} for b in (1, 8)],
    [],
]


@pytest.mark.parametrize("rows", ROWS)
def test_derive_route_crossover_matches_reference(benches, rows):
    ref, port = benches
    assert port.derive_route_crossover(rows) == \
        ref.derive_route_crossover(rows)


def test_derive_route_crossover_on_the_committed_rows(benches):
    """The committed H100 artifact's table is what its own scorer rows
    give, by either package's function."""
    ref, port = benches
    committed = json.loads(tpredict.bench_serve_path().read_text())
    assert committed["smoke"] is False
    assert port.derive_route_crossover(committed["scorer"]) == \
        committed["route_crossover"] == \
        ref.derive_route_crossover(committed["scorer"])


@pytest.fixture
def artifact(tmp_path, monkeypatch):
    """route_crossover() reading a file of the test's own."""
    path = tmp_path / "BENCH_serve_h100.json"
    monkeypatch.setattr(tpredict, "bench_serve_path", lambda: path)
    tpredict.set_route_crossover(None)
    yield path
    tpredict.set_route_crossover(None)


TABLE = [{"sparsity": 0.5, "min_batch_sparse": 8},
         {"sparsity": 0.99, "min_batch_sparse": None}]


def test_route_crossover_loads_a_full_run(artifact):
    artifact.write_text(json.dumps({"smoke": False,
                                    "route_crossover": TABLE}))
    assert list(tpredict.route_crossover()) == TABLE
    assert tpredict.pick_route(0.6, 8) == "sparse"
    assert tpredict.pick_route(0.6, 4) == "dense"
    assert tpredict.pick_route(0.995, 4096) == "dense"


@pytest.mark.parametrize("content", [
    json.dumps({"smoke": True, "route_crossover": TABLE}),   # a smoke run
    json.dumps({"route_crossover": TABLE}),                   # no smoke key
    "{ not json",                                             # corrupt
    json.dumps({"smoke": False, "route_crossover": [{"x": 1}]}),
    json.dumps({"smoke": False}),
    None])                                                    # missing
def test_route_crossover_falls_back_to_the_default(artifact, content):
    if content is not None:
        artifact.write_text(content)
    assert tpredict.route_crossover() == tpredict.DEFAULT_ROUTE_CROSSOVER


def test_route_crossover_is_loaded_once(artifact):
    artifact.write_text(json.dumps({"smoke": False,
                                    "route_crossover": TABLE}))
    assert list(tpredict.route_crossover()) == TABLE
    artifact.write_text("{ not json")
    assert list(tpredict.route_crossover()) == TABLE
    pinned = [{"sparsity": 0.0, "min_batch_sparse": 1}]
    tpredict.set_route_crossover(pinned)
    assert list(tpredict.route_crossover()) == pinned


def test_default_is_the_committed_h100_table():
    tpredict.set_route_crossover(None)
    committed = json.loads(tpredict.bench_serve_path().read_text())
    assert committed["smoke"] is False
    assert "H100" in committed["meta"]["card"]
    assert list(tpredict.DEFAULT_ROUTE_CROSSOVER) == \
        committed["route_crossover"]
    assert list(tpredict.route_crossover()) == committed["route_crossover"]
