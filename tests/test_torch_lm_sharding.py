"""The port's parameter placement (`repro_torch.models.sharding`, the
logical axes of `models.decls`) against the reference's
`repro.models.sharding`, in this process.

Every parameter of every architecture, at its reduced and its published
config (the port's model on the meta device, the reference's declaration
tree: nothing allocated), carries the reference's logical axes, the
leading "layers" axis of a stacked leaf dropped; `resolve_spec` gives
the reference's spec at the meshes (1, 1), (2, 1), (1, 2), (2, 2), (2, 4)
and (1, 8) (the reference's function reads only `mesh.shape`). Then the
pieces the sharded train step stands on, on one process: a block and
its gather, the element counted once over a mesh, the batch's rows over
"data", the loss of a data shard with the whole batch's count, and the
collectives of a mesh of one.
"""
import types

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.models import sharding as jsh
from repro.models.transformer import lm_decls
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline, rows_split, shard_rows
from repro_torch.launch.mesh import check_world
from repro_torch.models import decls
from repro_torch.models import layers as L
from repro_torch.models import sharding as sh
from repro_torch.models.transformer import Model, stacked_layers

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (2, 4), (1, 8)]


def _reference_decls(cfg) -> dict:
    """{port name: the reference's ParamDecl, its "layers" axis (if any)
    still on}."""
    stacks = stacked_layers(cfg)
    out = {}

    def walk(path, node):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(path + (key,), child)
            return
        if path[0] in stacks:
            for i in range(stacks[path[0]]):
                out[".".join((path[0], str(i)) + path[1:])] = node
        else:
            out[".".join(path)] = node

    walk((), lm_decls(cfg))
    return out


def _pair(arch, reduced):
    return (jax_config(arch, reduced=reduced),
            Model(get_config(arch, reduced=reduced), "meta"))


def _port_axes(ref):
    """The reference's logical axes as the port declares them: a stacked
    leaf's leading "layers" dropped."""
    axes = ref.logical_axes
    return axes[1:] if axes and axes[0] == "layers" else axes


@pytest.mark.parametrize("reduced", [True, False],
                         ids=["reduced", "published"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_parameter_has_the_reference_logical_axes(arch, reduced):
    jcfg, model = _pair(arch, reduced)
    ref = _reference_decls(jcfg)
    got = decls.logical_axes(model)
    assert sorted(got) == sorted(ref)
    for name, p in model.named_parameters():
        want = _port_axes(ref[name])
        assert got[name] == want, (name, got[name], want)
        assert len(want) == p.dim(), (name, want, tuple(p.shape))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resolve_spec_matches_the_reference(shape):
    sizes = {"data": shape[0], "model": shape[1]}
    jmesh = types.SimpleNamespace(shape=sizes)   # all resolve_spec reads
    rules = sh.default_rules()
    assert rules.rules == jsh.DEFAULT_RULES
    checked = 0
    for arch in ARCH_IDS:
        for reduced in (True, False):
            jcfg, model = _pair(arch, reduced)
            ref = _reference_decls(jcfg)
            specs = sh.spec_tree(model, rules, sizes)
            for name, spec in specs.items():
                d = ref[name]
                want = tuple(jsh.resolve_spec(d.shape, d.logical_axes,
                                              jsh.default_rules(), jmesh))
                if d.logical_axes[0] == "layers":
                    assert want[:1] in ((), (None,)), (name, want)
                    want = want[1:]
                assert spec == want, (arch, reduced, name, spec, want)
                checked += 1
    assert checked > 1000


def test_resolve_spec_rules():
    """Never one mesh axis twice; a rule that does not divide is dropped
    (that dim replicated); trailing Nones dropped; tuples where several
    axes divide."""
    rules = sh.default_rules()
    mesh = {"data": 2, "model": 4}
    assert sh.resolve_spec((8, 8), ("lru", "lru"), rules, mesh) == \
        ("model",)
    assert sh.resolve_spec((6, 896), ("vocab", "embed"), rules, mesh) == \
        (None, "data")
    assert sh.resolve_spec((896, 4), ("embed", None), rules, mesh) == \
        ("data",)
    assert sh.resolve_spec((3, 5), ("embed", "ff"), rules, mesh) == ()
    pod = {"pod": 2, "data": 2, "model": 1}
    assert sh.resolve_spec((8, 3), ("batch", None), rules, pod) == \
        (("pod", "data"),)
    assert sh.resolve_spec((2, 3), ("batch", None), rules, pod) == ("pod",)


def _fake_mesh(shape, coords):
    names = ("data", "model")
    sizes = dict(zip(names, shape))

    class FakeMesh:
        axis_names = names

        def __init__(self):
            self.shape = sizes
            self.coords = dict(zip(names, coords))

        def _axes(self, axes):
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            return tuple(a for a in names if a in axes)

        def size(self, axes):
            return int(np.prod([sizes[a] for a in self._axes(axes)]))

        def index(self, axes):
            out = 0
            for a in self._axes(axes):
                out = out * sizes[a] + self.coords[a]
            return out

        def all_gather(self, t, axes, dim=0):
            raise AssertionError("no collective in this test")

    return FakeMesh()


def test_local_slices_tile_the_tensor_and_count_once():
    """The blocks of every rank of a (2, 2) mesh put back in rank order
    are the tensor bit for bit; over the ranks each element of a leaf is
    counted exactly once (`counted_once`)."""
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    for spec in [("data", "model"), ("model", "data"), ("data",),
                 (None, "model"), ()]:
        blocks, counted = {}, np.zeros(t.shape)
        for d in range(2):
            for m in range(2):
                mesh = _fake_mesh((2, 2), (d, m))
                b = sh.local_slice(t, spec, mesh)
                blocks[d, m] = b
                if sh.counted_once(spec, mesh):
                    # where this block sits in the full tensor
                    mask = torch.zeros(t.shape)
                    idx = [slice(None)] * 2
                    for dim, entry in enumerate(spec):
                        if entry is None:
                            continue
                        n = t.shape[dim] // 2
                        c = mesh.coords[entry]
                        idx[dim] = slice(c * n, (c + 1) * n)
                    mask[tuple(idx)] = 1
                    assert torch.equal(t[tuple(idx)], b)
                    counted += mask.numpy()
        assert np.all(counted == 1), spec
    # a spec that splits nothing (a mesh of one) returns the tensor itself
    one = _fake_mesh((1, 1), (0, 0))
    assert sh.local_slice(t, ("data", "model"), one) is t
    assert sh.gather(t, ("data", "model"), one) is t
    assert sh.gather_tree({"w": t}, {"w": ("model",)}, one)["w"] is t


def test_batch_rows_over_data():
    """Rank i over "data" takes rows [i B / D, (i + 1) B / D) of every
    entry; a batch D does not divide goes whole to every rank."""
    cfg = get_config("pixtral-12b", reduced=True)
    pipe = TokenPipeline(cfg, 4, 9, seed=2)
    whole = pipe.batch_at(5)
    assert set(whole) == {"tokens", "labels", "patches", "loss_mask"}
    for i in range(2):
        part = pipe.batch_at(5, i, 2)
        for k, v in whole.items():
            np.testing.assert_array_equal(part[k], v[2 * i:2 * i + 2])
    assert rows_split(4, 2) and not rows_split(3, 2) \
        and not rows_split(4, 1)
    odd = TokenPipeline(cfg, 3, 9, seed=2)
    for k, v in odd.batch_at(5, 1, 2).items():
        np.testing.assert_array_equal(v, odd.batch_at(5)[k])
    assert shard_rows(whole, 0, 1) is whole


@pytest.mark.parametrize("masked", [False, True])
def test_shard_losses_add_to_the_whole_batch_mean(masked):
    """Each shard's loss over the count summed over the shards adds up to
    the whole batch's masked mean, where the shards' mask counts differ;
    a per-shard mean does not."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 6, 11))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 11, (4, 6)))
    mask = None
    if masked:
        mask = torch.ones(4, 6)
        mask[0, :5] = 0          # shard 0 counts 7 tokens, shard 1 12
    whole = L.softmax_xent(logits, labels, mask)
    count = mask.sum() if masked else torch.tensor(24.0)
    parts, means = [], []
    for i in range(2):
        rows = slice(2 * i, 2 * i + 2)
        m = None if mask is None else mask[rows]
        parts.append(L.softmax_xent(logits[rows], labels[rows], m, count))
        means.append(L.softmax_xent(logits[rows], labels[rows], m))
    np.testing.assert_allclose(float(parts[0] + parts[1]), float(whole),
                               rtol=1e-6)
    per_shard = float(means[0] + means[1]) / 2
    if masked:
        assert abs(per_shard - float(whole)) > 1e-3 * abs(float(whole))
    else:
        np.testing.assert_allclose(per_shard, float(whole), rtol=1e-6)


def test_a_mesh_that_is_not_the_world_size_is_refused():
    check_world((2, 2), ("data", "model"), 4)
    with pytest.raises(ValueError, match="needs 4 ranks, the process "
                                         "group has 2"):
        check_world((2, 2), ("data", "model"), 2)
