"""Import discipline and device policy of the PyTorch port."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"pcdn.py", "ops.py", "build.py", "bridge.py", "solve.py",
            "chip_smoke.py", "artifact.py", "predict.py", "loop.py",
            "batcher.py", "policy.py", "atomic.py", "registry.py"} <= names
    serve = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"src/repro_torch/serve/predict.py",
            "src/repro_torch/launch/predict.py"} <= serve


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.core import make_problem
    from repro_torch.launch import predict, solve
    from repro_torch.serve import ModelBank
    X = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        make_problem(X, np.ones(4), c=1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        solve.main(["--dataset", "a9a", "--max-outer", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        ModelBank.from_dense(X)
    # the device is resolved before the model file is read
    with pytest.raises(RuntimeError, match="cuda"):
        predict.main(["--model", "absent.json", "--dataset", "a9a"])


def test_kernel_wrappers_take_plain_version_on_cpu_without_counting():
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    rows = torch.tensor([[0, 1, 3]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, 0.0]])
    u = torch.tensor([0.5, -0.5, 1.0])
    d, g, h = ops.pcdn_sparse_direction(rows, vals, u, u.abs(),
                                        torch.zeros(1))
    assert float(g) == pytest.approx(-0.5)
    assert float(h) == pytest.approx(2.5)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
