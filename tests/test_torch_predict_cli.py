"""The serving slice end to end on the CPU: an artifact saved by either
package's solve CLI (or a one-vs-rest head fitted by the JAX package) is
served by the port's predict CLI, in both request layouts, through the
kernels' plain versions (`--use-kernels --device cpu`), and by the JAX
predict CLI. Predictions are equal; the port's margins agree with the
JAX scorer's on the same artifact at rtol 1e-5 (atol 1e-5, float32 sums
in another order)."""
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PCDNConfig
from repro.data import save_libsvm
from repro.launch import predict as jpredict_cli
from repro.launch import solve as jsolve
from repro.serve import artifact as jart
from repro.serve import ovr as jovr
from repro_torch.launch import predict as tpredict_cli
from repro_torch.launch import solve as tsolve
from repro_torch.serve import artifact as tart

jpredict = importlib.import_module("repro.serve.predict")
MTOL = dict(rtol=1e-5, atol=1e-5)


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
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("serve_cli")


@pytest.fixture(scope="module")
def requests_file(workdir):
    """A labelled request file at the a9a profile's width."""
    from repro.data import paper_like
    _, _, Xte, yte, _ = paper_like("a9a", with_test=True, seed=0)
    path = str(workdir / "requests.libsvm")
    save_libsvm(path, Xte[:300], yte[:300])
    return path


@pytest.fixture(scope="module")
def artifacts(workdir):
    port = str(workdir / "port.json")
    ref = str(workdir / "ref.json")
    report = str(workdir / "port_report.json")
    tsolve.main(["--dataset", "a9a", "--max-outer", "30", "--device",
                 "cpu", "--layout", "padded_csc", "--use-kernels",
                 "--save-model", port, "--out", report])
    jsolve.main(["--dataset", "a9a", "--max-outer", "30",
                 "--save-model", ref])
    return {"port": port, "ref": ref, "report": report}


def _serve_both(model, data, layout, tmp_path, extra=()):
    """-> (port payload, JAX payload, JAX margins of the same artifact)."""
    out_t = str(tmp_path / "t.json")
    out_j = str(tmp_path / "j.json")
    tpredict_cli.main(["--model", model, "--dataset", data, "--layout",
                       layout, "--device", "cpu", "--max-batch", "64",
                       "--out", out_t, *extra])
    jpredict_cli.main(["--model", model, "--dataset", data, "--layout",
                       layout, "--max-batch", "64", "--out", out_j, *extra])
    from repro.data import load_libsvm
    X = load_libsvm(data, n_features=jart.load_model(model).n_features,
                    return_classes=True)[0]
    bank = jpredict.ModelBank.from_family(jart.load_model(model))
    z = np.asarray(jpredict.predict(bank, jnp.asarray(X)))
    return json.load(open(out_t)), json.load(open(out_j)), z


@pytest.mark.parametrize("source", ["port", "ref"])
@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_predict_cli_serves_either_packages_solve(artifacts, requests_file,
                                                  source, layout, tmp_path,
                                                  capsys):
    t, j, z = _serve_both(artifacts[source], requests_file, layout,
                          tmp_path, extra=("--use-kernels",))
    assert "kernel-vs-reference" in capsys.readouterr().out
    assert t["kind"] == j["kind"] == "binary"
    assert t["n_requests"] == j["n_requests"] == 300
    np.testing.assert_array_equal(t["predictions"], j["predictions"])
    assert t["accuracy"] == j["accuracy"]
    np.testing.assert_allclose(np.asarray(t["margins"]), z, **MTOL)
    assert t["stats"]["total_rows"] == j["stats"]["total_rows"]
    assert t["stats"]["warmup_calls"] == j["stats"]["compiles"]


def test_port_report_is_artifact_and_warm_start(artifacts):
    """--out writes the artifact schema with the warm-start record, as the
    JAX solve does; both packages load it, and it chains."""
    from repro.launch import common as jcommon
    from repro_torch.launch import common as tcommon
    payload = json.load(open(artifacts["report"]))
    assert payload["schema"] == tart.SCHEMA
    assert "history" in payload and "w_indices" in payload
    fam_t = tart.load_model(artifacts["report"])
    fam_j = jart.load_model(artifacts["report"])
    np.testing.assert_array_equal(fam_t.model.w_indices,
                                  fam_j.model.w_indices)
    np.testing.assert_array_equal(
        fam_t.model.w_indices, tart.load_model(artifacts["port"]).model
        .w_indices)
    assert fam_t.provenance["solver"] == "pcdn"
    w_t = tcommon.load_warm_start(artifacts["report"], fam_t.n_features)
    w_j = np.asarray(jcommon.load_warm_start(artifacts["report"],
                                             fam_j.n_features, jnp.float32))
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_allclose(w_t, fam_t.model.dense_weights(np.float32))
    # warm-started from its own solution, the solve is converged at once
    f0 = payload["objective"]
    f = tsolve.main(["--dataset", "a9a", "--max-outer", "3", "--device",
                     "cpu", "--warm-start", artifacts["report"]])
    assert abs(f - f0) <= 1e-5 * abs(f0)


def test_predict_cli_serves_a_reference_ovr_head(workdir, tmp_path):
    """A one-vs-rest head fitted and saved by the JAX package, served by
    the port in both layouts: predictions equal the JAX CLI's."""
    rng = np.random.default_rng(0)
    s, n, K = 240, 60, 3
    X = ((rng.random((s, n)) < 0.25) *
         rng.standard_normal((s, n))).astype(np.float32)
    W = (rng.standard_normal((K, n)) *
         (rng.random((K, n)) < 0.15)).astype(np.float32)
    labels = np.asarray([3.0, 7.0, 11.0])[np.argmax(
        X @ W.T + 0.3 * rng.standard_normal((s, K)), axis=1)]
    res = jovr.fit_ovr(X, labels, c=2.0,
                       cfg=PCDNConfig(P=16, max_outer=60, tol_kkt=1e-2))
    model = str(workdir / "ovr.json")
    jart.save_model(model, jovr.ovr_family(res, "logistic"))
    data = str(workdir / "ovr.libsvm")
    save_libsvm(data, X, labels)
    for layout in ("dense", "padded_csc"):
        t, j, z = _serve_both(model, data, layout, tmp_path,
                              extra=("--use-kernels",))
        assert t["kind"] == "ovr"
        np.testing.assert_array_equal(t["predictions"], j["predictions"])
        assert t["accuracy"] == j["accuracy"] > 0.5
        np.testing.assert_allclose(np.asarray(t["margins"]), z, **MTOL)


def test_predict_cli_path_family_best_c_and_bf16(workdir, requests_file,
                                                 tmp_path):
    """A path family saved by the port: per-point accuracies match the JAX
    CLI's, --best-c serves one point, and a bf16 bank passes the guard."""
    from repro.data import paper_like
    X, y, _ = paper_like("a9a", seed=0)
    from repro_torch.core import PCDNConfig as TPCDNConfig
    from repro_torch.core import make_problem
    from repro_torch.engine import LocalBackend, solve
    prob = make_problem(X, y, c=2.0, device="cpu")
    backend = LocalBackend(prob, TPCDNConfig(P=32, max_outer=10))
    ws, metas, cs = [], [], [0.25, 0.5, 1.0]
    for i, c in enumerate(cs):
        r = solve(backend, c, max_outer=10, tol_kkt=1e-3)
        ws.append(r.w.numpy())
        metas.append({"val_accuracy": [0.6, 0.8, 0.7][i]})
    model = str(workdir / "path.json")
    tart.save_model(model, tart.path_family(np.stack(ws), cs, "logistic",
                                            metas=metas))
    t, j, z = _serve_both(model, requests_file, "dense", tmp_path)
    assert t["kind"] == "path"
    assert t["per_point"] == j["per_point"]
    np.testing.assert_allclose(np.asarray(t["margins"]), z, **MTOL)
    t, j, _ = _serve_both(model, requests_file, "dense", tmp_path,
                          extra=("--best-c",))
    assert t["kind"] == j["kind"] == "binary"
    assert t["accuracy"] == j["accuracy"]
    t = tpredict_cli.main(["--model", model, "--dataset", requests_file,
                           "--device", "cpu", "--use-kernels", "--dtype",
                           "bf16"])
    assert t["kernel_guard_max_abs_err"] is not None


def test_predict_cli_serve_mode_swaps_on_cpu(artifacts, requests_file,
                                             capsys):
    payload = tpredict_cli.main([
        "--model", artifacts["port"], "--dataset", requests_file,
        "--serve", "--rate", "3000", "--serve-requests", "200",
        "--swap-model", artifacts["ref"], "--use-kernels", "--device",
        "cpu", "--max-batch", "32"])
    assert payload["responses"] + payload["rejects"] == 200
    assert payload["swap"]["response_versions"] == [1, 2]
    assert payload["bank_storage_kept"] is True
    assert payload["libraries_loaded_after_warmup"] == []
    assert "hot-swap -> version 2" in capsys.readouterr().out


def test_predict_main_raises_without_cuda(artifacts, requests_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tpredict_cli.main(["--model", artifacts["port"], "--dataset",
                           requests_file])
