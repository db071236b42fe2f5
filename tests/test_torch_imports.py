"""Import discipline and device policy of the PyTorch port."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + \
    sorted((ROOT / "benchmarks" / "port").glob("*.py"))


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
    paths = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"src/repro_torch/serve/predict.py",
            "src/repro_torch/launch/predict.py"} <= paths
    lm = {f"src/repro_torch/{m}.py" for m in (
        "models/config", "models/decls", "models/layers", "models/attention",
        "models/transformer", "models/decode", "models/convert",
        "configs/__init__", "configs/qwen2_0_5b", "train/steps",
        "utils/params", "launch/serve")}
    assert lm <= paths, lm - paths
    sweep = {f"src/repro_torch/{m}.py" for m in (
        "obs/registry", "obs/trace", "obs/validate", "obs/gate",
        "path/grid", "path/driver", "path/batch", "launch/path",
        "serve/ovr")}
    assert sweep <= paths, sweep - paths


def test_scan_covers_the_baselines():
    paths = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"src/repro_torch/core/scdn.py",
            "src/repro_torch/core/tron.py"} <= paths


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
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    with pytest.raises(RuntimeError, match="cuda"):
        Model(get_config("qwen2-0.5b", reduced=True))


def test_kernel_wrappers_take_plain_version_on_cpu_without_counting():
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    rows = torch.tensor([[0, 1, 3]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, 0.0]])
    z = torch.zeros(3)
    y = torch.tensor([1.0, -1.0, 1.0])
    # squared loss: u = c (z - y), v = c
    d, g, h, delta = ops.pcdn_sparse_direction(rows, vals, z, y,
                                               torch.zeros(1), 0.5,
                                               kind="squared")
    assert float(g) == pytest.approx(0.5)
    assert float(h) == pytest.approx(2.5)
    assert delta.tolist() == pytest.approx([float(d), 2 * float(d), 0.0])
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_scan_covers_diag_and_fault():
    paths = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    want = {f"src/repro_torch/{m}.py" for m in (
        "diag/__init__", "diag/kkt", "diag/forensics", "diag/safep",
        "diag/report", "fault/__init__", "fault/atomic",
        "fault/checkpoint", "fault/inject", "fault/resilient")}
    assert want <= paths, want - paths


def test_scan_covers_the_port_benchmarks():
    paths = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    want = {f"benchmarks/port/{m}.py" for m in (
        "bench_kernels", "bench_serve", "hillclimb", "work",
        "fixed_order_ab", "scdn_dense_ab", "safep_convergence")}
    assert want <= paths, want - paths
    assert "src/repro_torch/kernels/autotune.py" in paths


def test_scan_covers_the_sharded_backend():
    paths = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    want = {f"src/repro_torch/{m}.py" for m in (
        "engine/sharded", "core/sharded", "launch/mesh", "launch/common")}
    assert want <= paths, want - paths


def test_sharded_entries_take_plain_version_on_cpu_without_counting():
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    rows = torch.tensor([[0, 1, 3], [1, 1, 2]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, 0.0], [1.0, 3.0, 0.5]])
    z = torch.zeros(3)
    y = torch.tensor([1.0, -1.0, 1.0])
    g, h = ops.pcdn_sparse_direction_partials(rows, vals, z, y, 0.5,
                                              kind="squared")
    assert g.tolist() == pytest.approx([0.5, 1.75])
    assert h.tolist() == pytest.approx([2.5, 5.125])
    delta = ops.pcdn_sparse_scatter(rows, vals, torch.tensor([1.0, 2.0]), 3)
    assert delta.tolist() == pytest.approx([1.0, 10.0, 1.0])
    XT = torch.tensor([[1.0, 0.0, 2.0], [0.0, 1.0, 1.0]])
    g, h = ops.pcdn_direction_partials(XT, torch.tensor([1, 2],
                                                        dtype=torch.int32),
                                       z, y, 0.5, kind="squared")
    assert g.tolist() == pytest.approx([0.0, 0.0])   # sentinel: 0 and floor
    assert h.tolist() == pytest.approx([1.0, 1e-12])
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
