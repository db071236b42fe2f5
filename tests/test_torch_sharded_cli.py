"""The port's solve and path CLIs with --backend sharded on --device cpu:
a world of 1 (in this process: the group starts itself) gives the local
backend's objective; two ranks under torchrun (gloo) solve to it; a
SIGKILLed sharded solve resumed with --resume ends bit-equal to the
uninterrupted one; checkpoints cross between the local and sharded
backends both ways; and the reference's refusals hold (scdn/tron, bf16,
--mode batch, a world that is not data x model). The torchrun and SIGKILL
cases are child processes with one torch thread each.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.data import make_classification, save_libsvm
from repro_torch.launch import path as tpath
from repro_torch.launch import solve as tsolve

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def svm(tmp_path_factory):
    X, y, _ = make_classification(400, 96, sparsity=0.8, corr=0.3, seed=4)
    path = tmp_path_factory.mktemp("data") / "data.svm"
    save_libsvm(str(path), X, y)
    return str(path)


def _cli(args, env=None, prefix=None):
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT / "src")
    e["OMP_NUM_THREADS"] = "1"
    e.pop("REPRO_FAULT_PLAN", None)
    if env:
        e.update(env)
    cmd = (prefix or [sys.executable, "-m"]) + args
    return subprocess.run(cmd, capture_output=True, text=True, env=e,
                          cwd=str(ROOT), timeout=240)


def _solve(svm, out, *extra):
    return ["--dataset", svm, "--P", "32", "--max-outer", "40",
            "--tol", "1e-3", "--device", "cpu", "--out", str(out), *extra]


def _report(path):
    with open(path) as fh:
        return json.load(fh)


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_world_one_solve_matches_local(svm, tmp_path, layout):
    tsolve.main(_solve(svm, tmp_path / "local.json", "--layout", layout,
                       "--use-kernels"))
    tsolve.main(_solve(svm, tmp_path / "sharded.json", "--layout", layout,
                       "--use-kernels", "--backend", "sharded"))
    local = _report(tmp_path / "local.json")
    sharded = _report(tmp_path / "sharded.json")
    assert sharded["converged"] and local["converged"]
    assert sharded["objective"] == pytest.approx(local["objective"],
                                                 rel=1e-4)
    assert sharded["provenance"]["backend"] == "sharded"


def test_sharded_alias_and_path_sweep(svm, tmp_path, capsys):
    tsolve.main(_solve(svm, tmp_path / "a.json", "--sharded"))
    assert _report(tmp_path / "a.json")["provenance"]["backend"] == \
        "sharded"
    base = ["--dataset", svm, "--points", "3", "--P", "32", "--max-outer",
            "30", "--device", "cpu", "--layout", "padded_csc"]
    local = tpath.main(base)
    sharded = tpath.main(base + ["--backend", "sharded", "--use-kernels"])
    assert sharded["backend"] == "sharded"
    for p, q in zip(sharded["points"], local["points"]):
        assert p["objective"] == pytest.approx(q["objective"], rel=1e-4)
    assert "backend=sharded" in capsys.readouterr().out


def test_two_ranks_under_torchrun(svm, tmp_path):
    """torchrun --standalone --nproc-per-node 2 on a (2 x 1) mesh: rank 0
    alone writes the report; the objective is the local solve's."""
    out = _cli(["--standalone", "--nproc-per-node", "2", "-m",
                "repro_torch.launch.solve"] +
               _solve(svm, tmp_path / "two.json", "--backend", "sharded",
                      "--data-parallel", "2", "--layout", "padded_csc",
                      "--use-kernels"),
               prefix=[sys.executable, "-m", "torch.distributed.run"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "world=2" in out.stdout and "backend=gloo" in out.stdout
    assert out.stdout.count("[solve] F=") == 1
    tsolve.main(_solve(svm, tmp_path / "local.json", "--layout",
                       "padded_csc"))
    assert _report(tmp_path / "two.json")["objective"] == pytest.approx(
        _report(tmp_path / "local.json")["objective"], rel=1e-4)


def test_sigkilled_sharded_solve_resumes_bit_equal(svm, tmp_path):
    args = ["repro_torch.launch.solve"] + _solve(
        svm, tmp_path / "full.json", "--backend", "sharded", "--layout",
        "padded_csc", "--use-kernels", "--max-outer", "12", "--tol", "1e-6")
    full = _cli(args)
    assert full.returncode == 0, full.stderr
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3"]
    crash = _cli(args + ck, env={"REPRO_FAULT_PLAN": json.dumps(
        {"crash_at_iter": 7, "crash_kind": "sigkill"})})
    assert crash.returncode == -9, crash.stdout + crash.stderr
    tsolve.main(args[1:] + ck + ["--resume", "--out",
                                 str(tmp_path / "res.json")])
    a, b = _report(tmp_path / "full.json"), _report(tmp_path / "res.json")
    assert b["faults"]["resumed_from"] == 5
    assert a["w_indices"] == b["w_indices"]
    assert a["w_values"] == b["w_values"]
    assert a["objective"] == b["objective"]


@pytest.mark.parametrize("first,then", [("local", "sharded"),
                                        ("sharded", "local")])
def test_checkpoints_cross_between_backends(svm, tmp_path, first, then):
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
          "--layout", "padded_csc"]
    tsolve.main(_solve(svm, tmp_path / "a.json", "--backend", first,
                       "--max-outer", "4", *ck))
    tsolve.main(_solve(svm, tmp_path / "b.json", "--backend", then,
                       "--resume", *ck))
    tsolve.main(_solve(svm, tmp_path / "c.json", "--layout", "padded_csc"))
    b, c = _report(tmp_path / "b.json"), _report(tmp_path / "c.json")
    assert b["faults"]["resumed_from"] == 3
    assert b["objective"] == pytest.approx(c["objective"], rel=1e-4)


@pytest.mark.parametrize("argv,match", [
    (["--backend", "sharded", "--solver", "scdn"], "pcdn only"),
    (["--backend", "sharded", "--solver", "tron"], "pcdn only"),
    (["--backend", "sharded", "--dtype", "bf16"], "unstudied on --backend"),
])
def test_solve_refusals(svm, tmp_path, capsys, argv, match):
    with pytest.raises(SystemExit):
        tsolve.main(_solve(svm, tmp_path / "x.json", *argv))
    assert match in capsys.readouterr().err


def test_path_batch_refused_and_world_checked(svm, capsys):
    with pytest.raises(SystemExit):
        tpath.main(["--dataset", svm, "--device", "cpu", "--backend",
                    "sharded", "--mode", "batch"])
    assert "--mode batch is local-only" in capsys.readouterr().err
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tsolve.main(["--dataset", svm, "--device", "cpu", "--backend",
                     "sharded", "--data-parallel", "2", "--model-parallel",
                     "2"])
