"""`torchrun -m repro_torch.launch.train --device cpu` over a (data, model)
mesh at the reduced qwen2-0.5b, on gloo.

(2, 1) and (1, 2) train with the losses of a world of 1 (rel 1e-5: the
gradient's sums over "data" and the clip's norm over the ranks add in
another order) and print the placement they use; a crash injected
through REPRO_FAULT_PLAN at a checkpoint fires on both ranks, which
restore it in lockstep and replay the uninterrupted run's losses bit for
bit; and one checkpoint chain crosses layouts and packages: written at
(2, 1), resumed at (1, 2), then in a world of 1, then by the reference's
`repro.launch.train.main` (on a (1, 1) Auto-axes mesh: jax 0.9's
default Explicit axes make its model raise), then at (2, 1) again. Each
hop resumes the checkpoint two steps before the previous hop's last
(the last one dropped) and its first two losses are held to that hop's
at the same steps: rel 1e-5 within the port, 1e-4 across the packages
(two float32 implementations of the step, as
tests/test_torch_train_cli.py holds them).

The torchrun runs are child processes with one torch thread (a file of
its own, so that pytest's --dist loadfile puts it on another worker than
the in-process tests).
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain

ROOT = Path(__file__).resolve().parents[1]
# --steps 6 --ckpt-every 2: each run writes at 2, 4 and 6 and keeps 4, 6
BASE = ["--batch", "2", "--seq", "16", "--seed", "3", "--steps", "6",
        "--ckpt-every", "2"]
PORT_RTOL = 1e-5
CROSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torchrun(ranks, args, env=None):
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT / "src")
    e["OMP_NUM_THREADS"] = "1"
    e.pop("REPRO_FAULT_PLAN", None)
    e.update(env or {})
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(ranks), "-m", "repro_torch.launch.train",
         "--device", "cpu"] + args,
        capture_output=True, text=True, env=e, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    results = [json.loads(x[len("[train] result "):]) for x in lines
               if x.startswith("[train] result ")]
    assert len(results) == 1, proc.stdout[-3000:]     # rank 0 prints
    return results[0], [x for x in lines if x.startswith("[train] mesh ")]


def _drop_last(ck: Path, step: int) -> None:
    shutil.rmtree(ck / f"step_{step:08d}")


def test_two_ranks_train_crash_and_replay(tmp_path):
    one = ttrain.main(BASE + ["--device", "cpu", "--ckpt-dir",
                              str(tmp_path / "one")])
    assert one["mesh"] is None and one["collectives_per_step"] == 0
    runs = {}
    for flag in ("--data", "--model-parallel"):
        res, mesh_lines = _torchrun(2, BASE + [
            flag, "2", "--ckpt-dir", str(tmp_path / flag[2:])])
        assert res["mesh"]["world"] == 2 and res["mesh"]["backend"] == "gloo"
        assert res["mesh"]["rows_split"] == (flag == "--data")
        assert len(mesh_lines) == 1 and (
            "runs its rows' forward and backward whole" if flag == "--data"
            else '"model" splits the compute') in mesh_lines[0]
        assert res["collectives_per_step"] > 0
        assert len(res["peak_bytes_by_rank"]) == 2
        np.testing.assert_allclose(res["losses"], one["losses"],
                                   rtol=PORT_RTOL)
        runs[flag] = res
    crashed, _ = _torchrun(2, BASE + ["--data", "2", "--ckpt-dir",
                                      str(tmp_path / "crash")],
                           env={"REPRO_FAULT_PLAN": json.dumps(
                               {"crash_at_iter": 4})})
    assert crashed["events"] == ["crash", "restore"]
    assert crashed["loss_steps"] == list(range(6))
    assert crashed["losses"] == runs["--data"]["losses"]   # bit for bit


@pytest.fixture
def jax_auto_mesh(monkeypatch):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    monkeypatch.setattr(jtrain, "make_host_mesh", lambda *a, **kw: mesh)


def _hop(prev: dict, got: dict, start: int, rtol: float) -> None:
    """`got` resumed at `start`: its first two losses are `prev`'s at the
    same steps."""
    assert got["start_step"] == start and got["events"] == ["resume"]
    assert got["loss_steps"][:2] == [start, start + 1]
    at = prev["loss_steps"].index(start)
    np.testing.assert_allclose(got["losses"][:2],
                               prev["losses"][at:at + 2], rtol=rtol)


def test_checkpoints_cross_layouts_and_packages(tmp_path, jax_auto_mesh):
    ck = tmp_path / "ck"
    args = BASE + ["--ckpt-dir", str(ck)]
    a, _ = _torchrun(2, args + ["--data", "2"])            # steps 0-5
    _drop_last(ck, 6)
    b, _ = _torchrun(2, args + ["--model-parallel", "2"])  # 4-9
    _hop(a, b, 4, PORT_RTOL)
    _drop_last(ck, 10)
    c = ttrain.main(args + ["--device", "cpu"])            # 8-13
    assert c["mesh"] is None
    _hop(b, c, 8, PORT_RTOL)
    _drop_last(ck, 14)
    d = jtrain.main(args)                                  # 12-17
    _hop(c, {"start_step": 12, "events": ["resume"],
             "loss_steps": list(range(12, 18)), "losses": d}, 12,
         CROSS_RTOL)
    _drop_last(ck, 18)
    e, _ = _torchrun(2, args + ["--data", "2"])            # 16-21
    _hop({"loss_steps": list(range(12, 18)), "losses": d}, e, 16,
         CROSS_RTOL)
