"""The port's sharded backend on a (2, 2, 2) ("pod", "data", "model") mesh
of 8 gloo ranks, the data-like axes ("pod", "data"), against the
reference's 8-device multi-pod run, both layouts: per step F rel <= 1e-5
from the reference's carries and partitions, the padded-row objective, and
a converged solve within 1e-4 of the local backend's
(torch_sharded_multi.py, torch_sharded_ranks.py). Subprocesses only, each
with its own timeout and OMP_NUM_THREADS=1."""
import torch_sharded_multi as tsm


def test_pod_data_model_mesh_matches_reference(tmp_path):
    axes = ("pod", "data", "model")
    npz = tsm.run_reference(tmp_path, (2, 2, 2), axes)
    out = tsm.run_port(tmp_path, (2, 2, 2), axes, npz)
    assert "pod=2 x data=2 x model=2 world=8" in out
