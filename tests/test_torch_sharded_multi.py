"""The port's sharded backend on a (2, 4) ("data", "model") mesh of 8 gloo
ranks against the reference's 8-device run, both layouts: per step F rel
<= 1e-5 from the reference's carries and partitions, the padded-row
objective, and a converged solve within 1e-4 of the local backend's
(torch_sharded_multi.py, torch_sharded_ranks.py). Subprocesses only, each
with its own timeout and OMP_NUM_THREADS=1."""
import torch_sharded_multi as tsm


def test_data_model_mesh_matches_reference(tmp_path):
    npz = tsm.run_reference(tmp_path, (2, 4), ("data", "model"))
    out = tsm.run_port(tmp_path, (2, 4), ("data", "model"), npz)
    assert "data=2 x model=4 world=8" in out
