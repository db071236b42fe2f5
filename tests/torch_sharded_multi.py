"""Helpers of the multi-rank sharded tests (test_torch_sharded_multi.py,
test_torch_sharded_pod.py): the reference's multi-device run in a jax
subprocess, and the port's ranks in another.

The reference runs on 8 host devices (XLA_FLAGS=--xla_force_host_
platform_device_count=8, as tests/test_sharded_pcdn.py runs it) and
records, for a few steps of each layout, the step's input carry (host
arrays), the partition of every model shard (its key split, fold_in of the
model index, `bundles.partition`) and the objective after the step. The
port's ranks (`torch_sharded_ranks.py`, one process a rank on gloo) restore
each carry, take the same partitions, and hold F rel <= 1e-5.

The data have s = 511 rows, so on two data shards the placers pad one row
of y = 1, z = 0 whose loss (c log 2) both packages count in F, and n = 254
features, so on four model shards two zero columns.
"""
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
STEPS = 3
P_LOCAL = 16
SHAPE = (511, 254)

REF_SCRIPT = r"""
import sys
import jax
import numpy as np
from repro.core import bundles as jB
from repro.data import make_classification
from repro.engine import ShardedBackend, ShardedPCDNConfig

shape = tuple(int(a) for a in sys.argv[1].split(","))
axes = tuple(sys.argv[2].split(","))
out_path = sys.argv[3]
steps, P_local, s, n = (int(a) for a in sys.argv[4:8])
data_axes = axes[:-1]
X, y, _ = make_classification(s, n, sparsity=0.7, corr=0.4, seed=3)
mesh = jax.make_mesh(shape, axes)
M = shape[-1]
rec = {"X": np.asarray(X, np.float32), "y": np.asarray(y, np.float32)}
for layout in ("dense", "padded_csc"):
    cfg = ShardedPCDNConfig(P_local=P_local, c=1.0, data_axes=data_axes)
    b = ShardedBackend(X, y, mesh, cfg, layout=layout)
    st = b.init_state()
    for k in range(steps):
        rec[f"{layout}_w{k}"] = b.host_weights(st.w)
        rec[f"{layout}_z{k}"] = b.host_margins(st.z)
        _, sub = jax.random.split(st.key)
        _, sub = jax.random.split(sub)
        rec[f"{layout}_idxs{k}"] = np.stack([
            np.asarray(jB.partition(jax.random.fold_in(sub, m), b.n_local,
                                    P_local)) for m in range(M)])
        out = b.outer(st.w, st.z, st.key, st.active, True, 1.0)
        rec[f"{layout}_f{k}"] = np.float64(out[3])
        st = st._replace(w=out[0], z=out[1], key=out[2], active=out[7])
np.savez(out_path, **rec)
print("REF_OK")
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(HERE), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def run_reference(tmp: Path, shape, axes) -> Path:
    """The reference's steps on `shape` over `axes`, saved to an npz."""
    out = tmp / "ref.npz"
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, ",".join(map(str, shape)),
         ",".join(axes), str(out), str(STEPS), str(P_LOCAL),
         str(SHAPE[0]), str(SHAPE[1])],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=240)
    assert "REF_OK" in proc.stdout, proc.stdout + proc.stderr
    return out


def run_port(tmp: Path, shape, axes, npz: Path) -> str:
    """The port's ranks on the same mesh: per-step F against the
    reference's, the padded-row objective, and a converged solve against
    the local backend's. Returns the ranks' output."""
    proc = subprocess.run(
        [sys.executable, str(HERE / "torch_sharded_ranks.py"),
         "--shape", ",".join(map(str, shape)), "--axes", ",".join(axes),
         "--npz", str(npz), "--store", str(tmp / "store"),
         "--steps", str(STEPS), "--p-local", str(P_LOCAL)],
        env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and "PORT_OK" in proc.stdout, \
        proc.stdout + proc.stderr
    return proc.stdout
