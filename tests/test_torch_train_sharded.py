"""The port's sharded train step (`train.steps.make_loss_and_grads` and
`make_train_step` over a `launch.mesh.Mesh`) on gloo ranks on the CPU,
against the reference's single-device `jax.value_and_grad(loss_fn)`.

A family a case (dense qwen2-0.5b, moe deepseek-moe-16b, ssm
falcon-mamba-7b, hybrid recurrentgemma-2b, vlm pixtral-12b, encdec
whisper-small), reduced, float32; the reference's weights (norm scales
perturbed) carried into the port, the token pipeline's batches of 4
rows. The reference model is built on a (1, 1) Auto-axes mesh (jax 0.9's
default Explicit axes make `Model._constrain` raise). Its gradient
oracle is `jax.value_and_grad(loss_fn)` on the whole batch, and, where
the rows split over "data" and the result depends on the split, on each
shard's rows: moe's capacity counts a shard's tokens (the reference's
`_moe_local` takes T = B_l * S inside its shard_map), so the split
oracle is the mean of the reference's single-device loss over the two
shards' rows, and the case's capacity factor (1.0) is low enough that
the shards drop other tokens than the whole batch would (asserted: the
two oracles differ). vlm's second batch has unequal loss_mask counts
in its two shards (a per-shard mean would be wrong there); the dense
family's second batch has 3 rows, which 2 does not divide: every rank
takes it whole and its gradient is the whole batch's, not twice it.

The ranks (`tests/torch_train_ranks.py`, a subprocess each world) hold
the loss and every gathered gradient at (2, 1), (1, 2) and (2, 2) to rel
1e-5 (atol 1e-5 x the leaf's largest entry), moe's split loss apart from
the whole batch's on one process, three steps to the same steps on one
process (losses rel 1e-5; moe at its config's own capacity, where no
token drops), and two runs bit-equal.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
CASES = {"qwen2-0.5b": 0.0, "deepseek-moe-16b": 1.0, "falcon-mamba-7b": 0.0,
         "recurrentgemma-2b": 0.0, "pixtral-12b": 0.0, "whisper-small": 0.0}
SEQ = 16


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _configs(arch, capacity):
    jcfg, tcfg = jax_config(arch, reduced=True), get_config(arch,
                                                            reduced=True)
    if capacity:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity))
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity))
    return jcfg, tcfg


def _batches(cfg, arch):
    first = TokenPipeline(cfg, 4, SEQ, seed=1).batch_at(0)
    if arch == "pixtral-12b":
        second = TokenPipeline(cfg, 4, SEQ, seed=2).batch_at(0)
        second["loss_mask"][0, cfg.vlm.n_patches:][:11] = 0.0
        counts = second["loss_mask"].reshape(2, -1).sum(1)
        assert counts[0] != counts[1], counts
        return [first, second]
    if arch == "qwen2-0.5b":
        return [first, TokenPipeline(cfg, 3, SEQ, seed=2).batch_at(0)]
    return [first]


def _flat(tcfg, tree):
    return {k: t.numpy() for k, t in
            params_from_jax(tcfg, jax.tree.map(np.asarray, tree),
                            dtype=torch.float32).items()}


def _write_case(arch, capacity, path):
    jcfg, tcfg = _configs(arch, capacity)
    jm = JaxModel(jcfg, _auto_mesh())
    tree = jax.tree.map(np.asarray,
                        jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def perturb(path_, a):
        if str(path_[-1].key) == "scale":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    whole_fn = jax.jit(jax.value_and_grad(jm.loss_fn))

    def shards_mean(p, b):
        h = len(b["tokens"]) // 2
        return 0.5 * sum(jm.loss_fn(p, {k: v[i * h:(i + 1) * h]
                                        for k, v in b.items()})
                         for i in range(2))

    split_fn = jax.jit(jax.value_and_grad(shards_mean))
    out = {"arch": np.array(arch), "capacity": np.array(capacity)}
    out.update({"p/" + k: v for k, v in _flat(tcfg, tree).items()})
    for j, batch in enumerate(_batches(jcfg, arch)):
        out.update({f"b{j}/{k}": v for k, v in batch.items()})
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        ways = {"whole": whole_fn(jtree, jb)}
        if len(batch["tokens"]) % 2 == 0:
            ways["split"] = split_fn(jtree, jb) if capacity else \
                ways["whole"]
        for way, (loss, grads) in ways.items():
            out[f"loss/{j}/{way}"] = np.asarray(loss)
            out.update({f"g/{j}/{way}/{k}": v
                        for k, v in _flat(tcfg, grads).items()})
        if capacity:
            # the shards' capacity drops other tokens than the batch's
            w, s = float(ways["whole"][0]), float(ways["split"][0])
            assert abs(w - s) > 1e-4 * abs(w), (w, s)
    np.savez(path, **out)


def _ranks(world, npz, store):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_train_ranks.py"),
         "--world", str(world), "--npz", str(npz), "--store", str(store)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0 and "PORT_OK" in proc.stdout, \
        (proc.stdout[-2000:], proc.stderr[-6000:])
    return proc.stdout


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_step_matches_value_and_grad(arch, tmp_path):
    npz = tmp_path / "case.npz"
    _write_case(arch, CASES[arch], npz)
    out = _ranks(2, npz, tmp_path / "store2")
    out += _ranks(4, npz, tmp_path / "store4")
    for shape in ("data=2 x model=1", "data=1 x model=2",
                  "data=2 x model=2"):
        assert shape in out, out
