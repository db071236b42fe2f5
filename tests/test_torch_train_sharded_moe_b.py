"""The moe layer's case B over "model" (E smaller than the "model" size:
every expert on the rank's expert_ff columns, the combine a partial sum
added over "model"): grok-1-314b's reduced config with 2 experts at a
(1, 4) mesh on four gloo ranks (`tests/torch_train_ranks.py --meshes
1x4`, a subprocess), its loss and every gradient against the reference's
`jax.value_and_grad` on one device at rtol 1e-5, then three steps
against one process's and two runs bit-equal, as
tests/test_torch_train_sharded.py holds the other families. Its 2 kv
heads, which 4 does not divide, run replicated.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ARCH = "grok-1-314b"
N_EXPERTS = 2
SEQ = 16


def _two_experts(cfg):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=N_EXPERTS))


def _write_case(path):
    jcfg = _two_experts(jax_config(ARCH, reduced=True))
    tcfg = _two_experts(get_config(ARCH, reduced=True))
    assert tcfg.moe.d_ff_expert % 4 == 0 and tcfg.moe.n_experts < 4
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jm = JaxModel(jcfg, mesh)
    tree = jax.tree.map(np.asarray,
                        jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
    batch = TokenPipeline(jcfg, 4, SEQ, seed=1).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})

    def flat(t):
        return {k: v.numpy() for k, v in params_from_jax(
            tcfg, jax.tree.map(np.asarray, t), dtype=torch.float32).items()}

    out = {"arch": np.array(ARCH), "capacity": np.array(0.0),
           "n_experts": np.array(N_EXPERTS), "loss/0/whole": np.asarray(loss)}
    out.update({"p/" + k: v for k, v in flat(tree).items()})
    out.update({"b0/" + k: v for k, v in batch.items()})
    out.update({"g/0/whole/" + k: v for k, v in flat(grads).items()})
    np.savez(path, **out)


def test_moe_case_b_at_one_by_four(tmp_path):
    npz = tmp_path / "case.npz"
    _write_case(npz)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_train_ranks.py"),
         "--world", "4", "--npz", str(npz), "--store",
         str(tmp_path / "store"), "--meshes", "1x4"],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0 and "PORT_OK" in proc.stdout, \
        (proc.stdout[-2000:], proc.stderr[-6000:])
    assert "data=1 x model=4" in proc.stdout, proc.stdout
