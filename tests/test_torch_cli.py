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
