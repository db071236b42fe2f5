"""The port's .npz checkpoint writer and reader (`fault.checkpoint.
_write_npz`, `_read_member`) against numpy's `np.savez` / `np.load`, on
the CPU: the same members with the same arrays (float32, bfloat16 as
"|V2", int, bool, 0-d, empty, non-contiguous and Fortran-ordered inputs),
np.savez's files read back exactly, a corrupt member refused as np.load
refuses it, a member neither package writes (compressed, .npy format 3.0,
an object dtype) refused, a train checkpoint's save and restore leaving
no tensor in a reference cycle (the stacked copy a save makes would
stay on the card until a garbage collection), and a train state's bfloat16 and float32 leaves round-tripped
bit for bit. The device path (a tensor's bytes through the pinned
staging buffer) is checked on the card (marked `gpu`).
"""
import gc
import struct
import zipfile

import numpy as np
import pytest
import torch

from repro_torch.fault import checkpoint as ck


def _leaves():
    g = torch.Generator().manual_seed(0)
    return [("00000§a", torch.randn(3, 4, generator=g)),
            ("00001§b", torch.randn(5, generator=g).to(torch.bfloat16)),
            ("00002§c", torch.tensor(7, dtype=torch.int32)),
            ("00003§d", np.zeros((0, 3), np.float32)),
            ("00004§e", np.array([True, False])),
            ("00005§f", torch.arange(6).reshape(2, 3).T),
            ("00006§g", np.asarray(3.5)),
            ("00007§h", 5),
            ("00008§i", np.arange(12).reshape(3, 4)[:, ::2]),
            ("00009§j", np.asfortranarray(np.arange(6.0).reshape(2, 3)))]


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "V":
        a, b = a.view(np.uint8), b.view(np.uint8)
    np.testing.assert_array_equal(a, b)


def _read_all(path):
    members = ck._npz_members(path)
    with open(path, "rb") as fh:
        return {k: ck._read_member(fh, i, path) for k, i in members.items()}


def test_writer_matches_savez_and_reader_matches_load(tmp_path):
    ours, theirs = tmp_path / "ours.npz", tmp_path / "savez.npz"
    ck._write_npz(str(ours), _leaves())
    np.savez(theirs, **{k: ck._to_host(v) for k, v in _leaves()})
    with np.load(ours) as a, np.load(theirs) as b:
        assert a.files == b.files == [k for k, _ in _leaves()]
        for k in a.files:
            _same(a[k], b[k])
        for path in (ours, theirs):
            got = _read_all(str(path))
            assert list(got) == b.files
            for k in b.files:
                _same(got[k], b[k])


def test_reader_refuses_a_corrupt_member(tmp_path):
    path = tmp_path / "x.npz"
    np.savez(path, **{"00000§a": np.arange(1000, dtype=np.float32)})
    raw = bytearray(path.read_bytes())
    info = ck._npz_members(str(path))["00000§a"]
    at = info.header_offset
    name_len, extra_len = struct.unpack("<HH", raw[at + 26:at + 30])
    raw[at + 30 + name_len + extra_len + 500] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(zipfile.BadZipFile):
        _read_all(str(path))
    with pytest.raises(zipfile.BadZipFile), np.load(path) as d:
        d["00000§a"]


def _object_npz(path):
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf, \
            zf.open("00000§a.npy", "w") as fh:
        np.lib.format.write_array(fh, np.array([{}, 1], dtype=object))


def _v3_npz(path):
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf, \
            zf.open("00000§a.npy", "w") as fh:
        np.lib.format.write_array(fh, np.arange(4, dtype=np.float32),
                                  version=(3, 0))


@pytest.mark.parametrize("write", [
    lambda p: np.savez_compressed(p, **{"00000§a": np.arange(9.0)}),
    _v3_npz, _object_npz], ids=["compressed", "format-3.0", "object"])
def test_reader_refuses_a_member_no_writer_makes(tmp_path, write):
    path = tmp_path / "x.npz"
    write(path)
    with pytest.raises(zipfile.BadZipFile):
        _read_all(str(path))


def test_train_state_round_trips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(4, 6, generator=g).to(torch.bfloat16),
              "b": torch.randn(6, generator=g)}
    state = (params, {k: torch.randn(v.shape, generator=g)
                      for k, v in params.items()},
             torch.tensor(3, dtype=torch.int32))
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    step, got = mgr.restore(state)
    assert step == 3
    for a, b in zip(ck.flatten_with_names(got), ck.flatten_with_names(state)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1])


def test_train_checkpoint_leaves_no_tensor_in_a_cycle(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainCheckpoints
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cfg = get_config("recurrentgemma-2b", reduced=True)
    model = Model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in model.named_parameters()}
    state = (params, adamw_init(params, AdamWConfig()))
    mgr = TrainCheckpoints(str(tmp_path), cfg)
    gc.collect()
    gc.disable()
    try:
        mgr.save(1, state)
        mgr.restore(state)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [x for x in gc.garbage if isinstance(x, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic, [tuple(t.shape) for t in cyclic]


@pytest.mark.gpu
def test_device_tensors_through_the_staging_buffer(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the staging buffer is pinned "
                    "host memory for device copies)")
    monkeypatch.setattr(ck, "_STAGING", 1000)    # several copies a leaf
    g = torch.Generator(device="cuda").manual_seed(0)
    leaves = [("00000§a", torch.randn(37, 41, generator=g, device="cuda")),
              ("00001§b", torch.randn(999, generator=g, device="cuda")
               .to(torch.bfloat16)),
              ("00002§c", torch.tensor(7, dtype=torch.int32, device="cuda")),
              ("00003§d", torch.arange(24, device="cuda").reshape(4, 6).T)]
    path = tmp_path / "x.npz"
    ck._write_npz(str(path), leaves)
    got = _read_all(str(path))
    for k, t in leaves:
        _same(got[k], ck._to_host(t))
