"""`python -m repro_torch.launch.train` on --device cpu for the moe, ssm,
hybrid, vlm and encdec families, at each arch's reduced config: every
arch trains a few steps with finite losses; the hybrid and encdec runs
crash once (REPRO_FAULT_PLAN) and replay from their last checkpoint to
the uninterrupted run's losses bit for bit; and each arch's train
checkpoints (moe's `layer0` beside `layers`, the hybrid's `triples` and
`tail_rec<j>`, encdec's `enc_layers` and `dec_layers`, the float32
router, `A_log`, `D`, `b_a`, `b_i` and `Lambda`) cross between the
packages both ways (the reference's `repro.launch.train.main` on a (1, 1)
Auto-axes mesh, since jax 0.9's default Explicit axes make its model
raise).

The CLI runs are child processes with one torch thread (a file of its
own, so that pytest's --dist loadfile puts it on another worker than the
in-process parity tests); the crossing cases call both `main`s in this
process. Losses after a crossing: rtol 1e-4 (two float32 implementations
of the same step from the same restored state and batch), as
tests/test_torch_train_cli.py holds the dense family's.
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
ARCHS = ["deepseek-moe-16b", "grok-1-314b", "falcon-mamba-7b",
         "recurrentgemma-2b", "pixtral-12b", "whisper-small"]
SMALL = ["--batch", "2", "--seq", "24", "--seed", "3"]


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


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_each_family(arch, tmp_path):
    got = _result(_cli(["--device", "cpu", "--arch", arch, "--steps", "5",
                        "--ckpt-every", "4", "--ckpt-dir", str(tmp_path)]
                       + SMALL))
    assert got["arch"] == arch and got["device"] == "cpu"
    assert got["loss_steps"] == list(range(5)) and got["events"] == []
    assert np.all(np.isfinite(got["losses"]))
    # CPU: the kernels' plain versions, nothing launched
    assert got["launches"]["flash_attention"] == 0
    assert got["launches"]["flash_attention_bwd"] == 0


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-small"])
def test_cli_crash_replays_bit_for_bit(arch, tmp_path):
    base = ["--device", "cpu", "--arch", arch, "--steps", "10",
            "--ckpt-every", "4"] + SMALL
    clean = _result(_cli(base + ["--ckpt-dir", str(tmp_path / "clean")]))
    assert clean["events"] == [] and np.all(np.isfinite(clean["losses"]))
    crashed = _result(_cli(base + ["--ckpt-dir", str(tmp_path / "crash")],
                           env={"REPRO_FAULT_PLAN": json.dumps(
                               {"crash_at_iter": 6})}))
    assert crashed["events"] == ["crash", "restore"]
    assert crashed["loss_steps"] == list(range(6)) + list(range(4, 10))
    assert crashed["losses"][6:] == clean["losses"][4:]


@pytest.fixture
def jax_auto_mesh(monkeypatch):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    monkeypatch.setattr(jtrain, "make_host_mesh", lambda *a, **kw: mesh)


def _args(arch, ck):
    return ["--arch", arch, "--steps", "6", "--ckpt-every", "4",
            "--ckpt-dir", str(ck)] + SMALL


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_family_checkpoint_resumes_in_the_port(arch, tmp_path,
                                                         jax_auto_mesh):
    ck = tmp_path / "ck"
    want = jtrain.main(_args(arch, ck))        # checkpoints at 4 and 6
    shutil.rmtree(ck / f"step_{6:08d}")
    got = ttrain.main(_args(arch, ck) + ["--device", "cpu"])
    assert got["start_step"] == 4 and got["loss_steps"][:2] == [4, 5]
    assert got["events"] == ["resume"]
    np.testing.assert_allclose(got["losses"][:2], want[4:6], rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_family_checkpoint_resumes_in_the_reference(arch, tmp_path,
                                                         jax_auto_mesh):
    ck = tmp_path / "ck"
    want = ttrain.main(_args(arch, ck) + ["--device", "cpu"])["losses"]
    shutil.rmtree(ck / f"step_{6:08d}")
    got = jtrain.main(_args(arch, ck))         # resumes at 4: steps 4..9
    np.testing.assert_allclose(got[:2], want[4:6], rtol=1e-4)
