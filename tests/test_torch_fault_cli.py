"""The port's solve and path CLIs with the fault-tolerance and diagnostics
flags, on --device cpu: a SIGKILLed sweep resumed with --resume writes
the uninterrupted run's report; a solve resumes and continues; a NaN
plan through REPRO_FAULT_PLAN rolls back and backs P off, or, with
--retries 0, surfaces the post-mortem in --out and in the --diag-out
report, which `python -m repro_torch.diag.report` re-renders from --out;
the flag refusals are the reference's, word for word.

The CLI cases live in this file of their own so that pytest's --dist
loadfile puts them on another worker than the in-process ones; only the
SIGKILLed run and the report's `-m` entry point are child processes (one
torch thread each), the rest call the CLIs' `main` in this process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import path as jpath
from repro.launch import solve as jsolve
from repro_torch.launch import path as tpath
from repro_torch.launch import solve as tsolve

ROOT = Path(__file__).resolve().parents[1]
SECTIONS = ("## Run summary", "## Convergence", "## Top KKT offenders",
            "## Backtrack forensics", "## Divergence post-mortem",
            "## Certified parallelism")


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One torch thread a case and no fault plan from the environment:
    under pytest-xdist several workers share the machine's cores."""
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli(args, env=None):
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT / "src")
    e["OMP_NUM_THREADS"] = "1"
    e.pop("REPRO_FAULT_PLAN", None)
    if env:
        e.update(env)
    return subprocess.run([sys.executable, "-m"] + args,
                          capture_output=True, text=True, env=e,
                          cwd=str(ROOT), timeout=300)


def test_sigkill_path_sweep_resumes_to_same_artifact(tmp_path, capsys):
    base = ["--dataset", "a9a", "--points", "3", "--P", "64",
            "--max-outer", "15", "--tol", "1e-3", "--device", "cpu"]
    tpath.main(base + ["--out", str(tmp_path / "ref.json")])
    killed = _cli(["repro_torch.launch.path"] + base
                  + ["--ckpt-dir", str(tmp_path / "ck")],
                  env={"REPRO_FAULT_PLAN":
                       '{"crash_at_point": 1, "crash_kind": "sigkill"}'})
    assert killed.returncode == -9          # SIGKILL, not a clean exit
    capsys.readouterr()
    tpath.main(base + ["--ckpt-dir", str(tmp_path / "ck"), "--resume",
                       "--out", str(tmp_path / "res.json")])
    assert "resuming path sweep at point 2/3" in capsys.readouterr().out
    a = json.load(open(tmp_path / "ref.json"))
    b = json.load(open(tmp_path / "res.json"))
    assert a["best_index"] == b["best_index"]
    for pa, pb in zip(a["points"], b["points"]):
        for k in ("c", "objective", "nnz", "kkt", "n_outer", "converged",
                  "val_accuracy"):
            assert pa[k] == pb[k], k


def test_solve_resume_continues(tmp_path, capsys):
    common = ["--dataset", "a9a", "--P", "64", "--tol", "1e-6", "--device",
              "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    tsolve.main(common + ["--max-outer", "8", "--ckpt-every", "3"])
    capsys.readouterr()
    tsolve.main(common + ["--max-outer", "16", "--resume"])
    out = capsys.readouterr().out
    assert "resuming solve at outer iteration 6" in out
    assert "resumed_from=5" in out
    assert "n_outer=16" in out


def test_nan_plan_rolls_back_and_backs_off(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_FAULT_PLAN",
                       '{"nan_at_iter": 2, "nan_target": "margins"}')
    out = tmp_path / "o.json"
    tsolve.main(["--dataset", "a9a", "--P", "64", "--max-outer", "12",
                 "--tol", "1e-3", "--device", "cpu", "--layout",
                 "padded_csc", "--use-kernels", "--out", str(out)])
    text = capsys.readouterr().out
    assert "[fault] rollbacks=1 p_schedule=[64, 32]" in text
    rep = json.loads(out.read_text())
    assert rep["faults"]["rollbacks"] == 1
    assert rep["faults"]["p_schedule"] == [64, 32]
    assert rep["history"]["outer_iter"] == list(
        range(len(rep["history"]["outer_iter"])))
    assert "postmortem" not in rep


def test_exhausted_retries_surface_postmortem_and_report(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    monkeypatch.setenv("REPRO_FAULT_PLAN",
                       '{"nan_at_iter": 3, "nan_target": "margins"}')
    out, md = tmp_path / "o.json", tmp_path / "h.md"
    tsolve.main(["--dataset", "a9a", "--P", "32", "--max-outer", "12",
                 "--tol", "1e-3", "--device", "cpu", "--retries", "0",
                 "--diag-out", str(md), "--out", str(out)])
    assert "surfacing post-mortem" in capsys.readouterr().out
    rep = json.loads(out.read_text())
    pm = rep["postmortem"]
    for key in ("objective_growth", "deepest_mean_q", "heatmap",
                "worst_bundles", "alpha_floor"):
        assert key in pm, key
    assert pm["trip_iter"] == 3
    # the trip iteration's bundles count: 4 iterations of ceil(123/32)
    assert pm["heatmap"]["bundles_ran"] == 4 * 4
    assert rep["diag"]["safep"]["observed_P"] == 32
    text = md.read_text()
    for section in SECTIONS:
        assert section in text, section
    again = tmp_path / "again.md"
    r = _cli(["repro_torch.diag.report", "--report", str(out), "-o",
              str(again)])
    assert r.returncode == 0, r.stderr[-4000:]
    assert "RuntimeWarning" not in r.stderr
    assert again.read_text() == text


def test_path_sweep_diag_out(tmp_path, capsys):
    md = tmp_path / "h.md"
    tpath.main(["--dataset", "a9a", "--points", "3", "--P", "64",
                "--max-outer", "10", "--device", "cpu", "--diag-out",
                str(md)])
    assert "[diag] health report written" in capsys.readouterr().out
    text = md.read_text()
    for section in ("## Run summary", "## Convergence",
                    "## Top KKT offenders", "## Backtrack forensics",
                    "## Certified parallelism"):
        assert section in text, section


REFUSALS = [
    ("solve", ["--solver", "scdn", "--ckpt-dir", "CK"]),
    ("solve", ["--solver", "tron", "--resume"]),
    ("solve", ["--solver", "scdn", "--diag-out", "h.md"]),
    ("solve", ["--resume"]),
    ("solve", ["--ckpt-dir", "CK", "--ckpt-every", "0"]),
    ("path", ["--mode", "batch", "--ckpt-dir", "CK"]),
    ("path", ["--mode", "batch", "--resume"]),
    ("path", ["--mode", "batch", "--diag-out", "h.md"]),
    ("path", ["--resume"]),
]


@pytest.mark.parametrize("cli,flags", REFUSALS,
                         ids=[f"{c}:{' '.join(f)}" for c, f in REFUSALS])
def test_flag_refusals_match_reference(cli, flags, tmp_path, capsys):
    flags = [str(tmp_path / f) if f in ("CK", "h.md") else f
             for f in flags]
    port, ref = (tsolve, jsolve) if cli == "solve" else (tpath, jpath)
    errors = []
    for main, extra in ((port.main, ["--device", "cpu"]), (ref.main, [])):
        with pytest.raises(SystemExit) as exc:
            main(["--dataset", "a9a", "--max-outer", "2", *flags, *extra])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        errors.append(err[err.index("error:"):])
    assert errors[0] == errors[1]
    assert not (tmp_path / "CK").exists()
