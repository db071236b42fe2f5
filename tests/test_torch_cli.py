"""The slice as a whole: the port's solve CLI against the reference's on
a9a. The two draw different partitions, so they are compared at
convergence (--tol 1e-3), not per iteration: converged F rel <= 1e-3."""
import pytest

from repro.launch import solve as jsolve
from repro_torch.launch import solve as tsolve


@pytest.fixture(scope="module")
def reference_f():
    return jsolve.main(["--dataset", "a9a", "--tol", "1e-3",
                        "--max-outer", "100"])


# the support scope at P = 32 stalls on the float32 KKT plateau just above
# 1e-3 in the reference as well (ROADMAP Queue 3), so it only has to reach
# the same objective within the 100 iterations
@pytest.mark.parametrize("flags,converges", [
    ([], True),
    (["--layout", "padded_csc", "--use-kernels"], True),
    (["--layout", "padded_csc", "--use-kernels", "--ls-scope", "support",
      "--P", "32"], False),
    (["--shrink"], True),
], ids=["dense", "csc-kernels", "csc-support-kernels", "shrink"])
def test_solve_cli_matches_reference(reference_f, flags, converges, capsys):
    f = tsolve.main(["--dataset", "a9a", "--tol", "1e-3", "--max-outer",
                     "100", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert "device=cpu" in out
    assert ("converged=True" in out) or not converges
    assert abs(f - reference_f) / abs(reference_f) <= 1e-3


def test_solve_cli_cdn_runs(capsys):
    f = tsolve.main(["--dataset", "a9a", "--solver", "cdn", "--max-outer",
                     "3", "--device", "cpu", "--loss", "squared_hinge"])
    assert f > 0 and "solver=cdn" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--dtype", "bf16", "--tol", "1e-4"],
    ["--dtype", "bf16", "--solver", "scdn"],
    ["--dtype", "bf16", "--solver", "tron"],
    ["--solver", "tron", "--shrink"],
    ["--solver", "scdn", "--warm-start", "w.npy"],
], ids=["bf16-tol", "bf16-scdn", "bf16-tron", "tron-shrink",
        "scdn-warm-start"])
def test_solve_cli_refuses_what_the_reference_refuses(flags, capsys):
    """Both CLIs exit with a usage error before loading any data."""
    for cli in (tsolve, jsolve):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--dataset", "a9a", "--device", "cpu", *flags]
                     if cli is tsolve else ["--dataset", "a9a", *flags])
        assert exc.value.code == 2
    assert "[solve]" not in capsys.readouterr().out


def test_solve_cli_tron_matches_reference(capsys):
    """TRON is deterministic in both packages: F rel <= 1e-4."""
    args = ["--dataset", "a9a", "--solver", "tron", "--max-outer", "30"]
    f_ref = jsolve.main(args)
    f = tsolve.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "solver=tron" in out and "[solve] F=" in out
    assert abs(f - f_ref) <= 1e-4 * abs(f_ref)


def test_solve_cli_scdn_runs(tmp_path, capsys):
    out = tmp_path / "scdn.json"
    f = tsolve.main(["--dataset", "a9a", "--solver", "scdn", "--max-outer",
                     "3", "--device", "cpu", "--out", str(out)])
    assert "solver=scdn" in capsys.readouterr().out and f > 0
    import json
    rep = json.loads(out.read_text())
    assert rep["history"]["round"] == [0, 1, 2]
    assert len(rep["history"]["objective"]) == 3
    assert rep["provenance"]["solver"] == "scdn"


def test_solve_cli_bf16_matches_reference(reference_f, tmp_path, capsys):
    """bf16 storage through the normal entry point: converged F within the
    bf16 envelope (rel 1e-3) of the reference's float32 solve, the dtype
    recorded in the report."""
    out = tmp_path / "bf16.json"
    f = tsolve.main(["--dataset", "a9a", "--tol", "1e-3", "--max-outer",
                     "100", "--device", "cpu", "--dtype", "bf16",
                     "--layout", "padded_csc", "--use-kernels", "--out",
                     str(out)])
    assert "converged=True" in capsys.readouterr().out
    assert abs(f - reference_f) <= 1e-3 * abs(reference_f)
    import json
    assert json.loads(out.read_text())["provenance"]["dtype"] == "bf16"
