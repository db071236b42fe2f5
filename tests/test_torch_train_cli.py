"""`python -m repro_torch.launch.train` on --device cpu at the reduced
qwen2-0.5b: the loss falls and stays finite; a crash injected through
REPRO_FAULT_PLAN restores the last checkpoint and replays to the
uninterrupted run's losses bit for bit; a second run on the same
directory resumes; --data / --model-parallel of 2 in a world of 1 are
refused with the mesh's world-size message; and
train checkpoints cross between the packages both ways (the reference's
`repro.launch.train.main` on a (1, 1) Auto-axes mesh, since jax 0.9's
default Explicit axes make its model raise). The other families' runs
are in tests/test_torch_train_families_cli.py.

The CLI runs are child processes with one torch thread (this file of its
own, so that pytest's --dist loadfile puts it on another worker than the
in-process parity tests); the crossing cases call both `main`s in this
process. Losses after a crossing: rtol 1e-4 (two float32 implementations
of the same step from the same restored state and batch).
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
SMALL = ["--batch", "2", "--seq", "16", "--seed", "3"]


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
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
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                          + args, capture_output=True, text=True, env=e,
                          cwd=str(ROOT), timeout=300)


def _result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("[train] result ")][-1]
    return json.loads(line[len("[train] result "):])


def test_cli_trains_crashes_replays_and_resumes(tmp_path):
    base = ["--device", "cpu", "--steps", "30", "--batch", "4", "--seq",
            "64", "--ckpt-every", "5"]
    clean = _result(_cli(base + ["--ckpt-dir", str(tmp_path / "clean")]))
    losses = clean["losses"]
    assert clean["loss_steps"] == list(range(30)) and clean["events"] == []
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0]
    assert clean["launches"]["flash_attention"] == 0   # CPU: plain versions

    crashed = _result(_cli(base + ["--ckpt-dir", str(tmp_path / "crash")],
                           env={"REPRO_FAULT_PLAN": json.dumps(
                               {"crash_at_iter": 7})}))
    assert crashed["events"] == ["crash", "restore"]
    assert crashed["loss_steps"] == list(range(7)) + list(range(5, 30))
    replay = crashed["losses"][7:]
    assert replay == losses[5:]              # bit for bit on the CPU

    again = _result(_cli(base[:3] + ["6"] + base[4:]
                         + ["--ckpt-dir", str(tmp_path / "clean")]))
    assert again["start_step"] == 30 and again["events"] == ["resume"]
    assert again["loss_steps"] == list(range(30, 36))
    assert np.all(np.isfinite(again["losses"]))


@pytest.mark.parametrize("flag", ["--data", "--model-parallel"])
def test_cli_refuses_lm_sharding(flag, monkeypatch):
    """A mesh of 2 ranks in a world of 1 (no torchrun) raises the mesh's
    world-size message; the sharded runs are
    tests/test_torch_train_sharded_cli.py's."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs 2 ranks, the process "
                                         "group has 1"):
        ttrain.main(["--device", "cpu", flag, "2"])


@pytest.fixture
def jax_auto_mesh(monkeypatch):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    monkeypatch.setattr(jtrain, "make_host_mesh", lambda *a, **kw: mesh)


def _drop_last(ck: Path, step: int) -> None:
    shutil.rmtree(ck / f"step_{step:08d}")


def test_reference_checkpoint_resumes_in_the_port(tmp_path, jax_auto_mesh):
    ck = tmp_path / "ck"
    args = ["--steps", "6", "--ckpt-every", "4", "--ckpt-dir", str(ck)] \
        + SMALL
    want = jtrain.main(args)               # checkpoints at 4 and 6
    _drop_last(ck, 6)
    got = ttrain.main(args + ["--device", "cpu"])
    assert got["start_step"] == 4 and got["loss_steps"][:2] == [4, 5]
    np.testing.assert_allclose(got["losses"][:2], want[4:6], rtol=1e-4)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, jax_auto_mesh):
    ck = tmp_path / "ck"
    args = ["--steps", "6", "--ckpt-every", "4", "--ckpt-dir", str(ck)] \
        + SMALL
    want = ttrain.main(args + ["--device", "cpu"])["losses"]
    _drop_last(ck, 6)
    got = jtrain.main(args)                 # resumes at 4: steps 4..9
    np.testing.assert_allclose(got[:2], want[4:6], rtol=1e-4)
