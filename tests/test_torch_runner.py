"""The port's step-loop runner (`repro_torch.fault.runner`) and the
checkpoint manager's nested trees, on the CPU: the reference's runner
cases (`tests/test_checkpoint_fault.py`) on torch state, a straggling
train step re-issued once and applied once, the deprecated
`repro_torch.train.*` shims, and nested trees stored under the
reference's leaf order and names, so that either package restores the
other's checkpoint. Exact comparisons throughout (restores are
bit-exact; the runner's arithmetic is integer-valued).
"""
import importlib
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fault.checkpoint import CheckpointManager as JaxManager
from repro.fault.checkpoint import _flatten_with_names
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro_torch.configs import get_config
from repro_torch.fault import ElasticMeshProvider
from repro_torch.fault.checkpoint import CheckpointManager, flatten_with_names
from repro_torch.fault.inject import FaultPlan
from repro_torch.fault.runner import (FaultTolerantRunner, RunnerConfig,
                                      StepFailure)
from repro_torch.models.decls import init_params
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init
from repro_torch.train.steps import make_train_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_step():
    def step(state, idx):
        w = state["w"] + idx + 1
        return {"w": w}, {"loss": float(torch.sum(w))}
    return step


def expected_after(n):
    return float(sum(i + 1 for i in range(n)))


def test_runner_no_faults(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    r = FaultTolerantRunner(make_step(), {"w": torch.zeros(())}, cm,
                            RunnerConfig(ckpt_every=3))
    r.run(7)
    assert float(r.state["w"]) == expected_after(7)
    assert cm.steps() == [3, 6, 7]     # keep=3


def test_runner_crash_recovery_deterministic(tmp_path):
    """A crash mid-run restores the checkpoint and reaches the exact
    fault-free state; the crash comes from a FaultPlan, as
    `launch.train` wires it (`crash_at_iter` counts steps there)."""
    cm = CheckpointManager(str(tmp_path))
    plan = FaultPlan(crash_at_iter=5)
    r = FaultTolerantRunner(make_step(), {"w": torch.zeros(())}, cm,
                            RunnerConfig(ckpt_every=2),
                            inject_fault=plan.fire_step)
    r.run(8)
    assert float(r.state["w"]) == expected_after(8)
    kinds = [e["kind"] for e in r.events]
    assert kinds == ["crash", "restore"]
    assert r.events[1]["step"] == 4


def test_runner_resume_from_disk(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    r1 = FaultTolerantRunner(make_step(), {"w": torch.zeros(())}, cm,
                             RunnerConfig(ckpt_every=2))
    r1.run(4)  # final save at step 4
    r2 = FaultTolerantRunner(make_step(), {"w": torch.zeros(())}, cm,
                             RunnerConfig(ckpt_every=2))
    assert r2.start_step == 4 and r2.events == [{"kind": "resume",
                                                 "step": 4}]
    r2.run(4)
    assert float(r2.state["w"]) == expected_after(8)


def test_straggler_reissue(tmp_path):
    """A step past the deadline is re-issued and succeeds."""
    cm = CheckpointManager(str(tmp_path))
    slow = {"hit": False}

    def step(state, idx):
        if idx == 6 and not slow["hit"]:
            slow["hit"] = True
            time.sleep(0.6)
        return {"w": state["w"] + idx + 1}, {}

    r = FaultTolerantRunner(
        step, {"w": torch.zeros(())}, cm,
        RunnerConfig(ckpt_every=100, straggler_factor=3.0,
                     min_deadline_s=0.3, warmup_steps=2))
    r.run(8)
    assert float(r.state["w"]) == expected_after(8)
    assert [e["kind"] for e in r.events] == ["straggler"]


def test_runner_gives_up_after_retries(tmp_path):
    cm = CheckpointManager(str(tmp_path))

    def bad_step(state, idx):
        raise RuntimeError("always broken")

    r = FaultTolerantRunner(bad_step, {"w": torch.zeros(())}, cm,
                            RunnerConfig(max_retries_per_step=2))
    with pytest.raises(StepFailure, match="always broken") as exc:
        r.run(1)
    assert [e["kind"] for e in r.events] == ["crash", "crash"]
    assert isinstance(exc.value.__cause__, RuntimeError)


def test_straggling_train_step_is_applied_once(tmp_path):
    """The real train step (reduced qwen2, CPU) under the runner with one
    straggling attempt: the re-issue starts from the state before the
    attempt, so the run ends where a clean run ends, bit for bit, and
    the optimizer counted each step once."""
    cfg = get_config("qwen2-0.5b", reduced=True)
    model = Model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-2)
    train_step = make_train_step(model, opt_cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (6, 2, 10))
    batches = [{"tokens": torch.as_tensor(t[:, :-1]),
                "labels": torch.as_tensor(t[:, 1:])} for t in toks]

    def run(straggle_at):
        hit = {"done": False}

        def step(state, idx):
            params, opt = state
            params, opt, metrics = train_step(params, opt, batches[idx])
            if idx == straggle_at and not hit["done"]:
                hit["done"] = True      # the result is dropped: too late
                time.sleep(0.6)
            return (params, opt), metrics

        params = {k: p.detach() for k, p in model.named_parameters()}
        r = FaultTolerantRunner(
            step, (params, adamw_init(params, opt_cfg)),
            CheckpointManager(str(tmp_path / f"s{straggle_at}")),
            RunnerConfig(ckpt_every=100, straggler_factor=3.0,
                         min_deadline_s=0.3, warmup_steps=2))
        r.run(6)
        return r

    clean, late = run(-1), run(4)
    assert [e["kind"] for e in late.events] == ["straggler"]
    assert int(late.state[1].step) == int(clean.state[1].step) == 6
    for a, b in zip(flatten_with_names(late.state),
                    flatten_with_names(clean.state)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]


def test_train_shims_warn_and_reexport():
    """`repro_torch.train.checkpoint` / `.fault_tolerance` still import,
    with a DeprecationWarning, and expose `repro_torch.fault`'s
    objects."""
    import repro_torch.fault as fault
    import repro_torch.train as train
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tc = importlib.import_module("repro_torch.train.checkpoint")
        tf = importlib.import_module("repro_torch.train.fault_tolerance")
        importlib.reload(tc)
        importlib.reload(tf)
    assert sum(issubclass(w.category, DeprecationWarning) for w in rec) >= 2
    assert tc.CheckpointManager is CheckpointManager is fault.CheckpointManager
    assert tf.FaultTolerantRunner is FaultTolerantRunner is \
        fault.FaultTolerantRunner
    assert tf.RunnerConfig is RunnerConfig and tf.StepFailure is StepFailure
    assert tf.ElasticMeshProvider is ElasticMeshProvider
    assert train.CheckpointManager is CheckpointManager
    assert train.FaultTolerantRunner is FaultTolerantRunner


# -- nested trees -----------------------------------------------------------

def _torch_tree():
    g = torch.Generator().manual_seed(0)
    p = {"b": {"x": torch.randn(2, 3, generator=g)},
         "a": torch.randn(4, generator=g).to(torch.bfloat16)}
    opt = AdamWState(torch.tensor(7, dtype=torch.int32),
                     {"b": {"x": torch.randn(2, 3, generator=g)},
                      "a": torch.randn(4, generator=g)},
                     {"b": {"x": torch.rand(2, 3, generator=g)},
                      "a": torch.rand(4, generator=g)}, None)
    return (p, opt, [torch.arange(3), (torch.ones(1),)])


def test_nested_tree_leaf_order_and_names_are_the_reference(tmp_path):
    tree = _torch_tree()
    jtree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()), tree,
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    jtree = (jtree[0], JaxAdamWState(*jtree[1]), jtree[2])
    assert [n for n, _ in flatten_with_names(tree)] == \
        [n for n, _ in _flatten_with_names(jtree)]
    cm = CheckpointManager(str(tmp_path))
    cm.save(3, tree)
    assert cm.manifest(3)["treedef"] == \
        str(jax.tree_util.tree_structure(jtree))
    assert cm.manifest(3)["n_leaves"] == 9


def test_nested_tree_round_trips_bit_exact(tmp_path):
    tree = _torch_tree()
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, tree)
    like = jax.tree.map(torch.zeros_like, tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    like = (like[0], AdamWState(*like[1]), like[2])
    step, got = cm.restore(like)
    assert step == 5 and isinstance(got[1], AdamWState)
    assert got[1].master is None and isinstance(got[2][1], tuple)
    for (na, a), (nb, b) in zip(flatten_with_names(got),
                                flatten_with_names(tree)):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b), na
    # casts to `like`'s dtype, as the reference's restore does
    like[0]["b"]["x"] = torch.zeros((2, 3), dtype=torch.float64)
    _, got = cm.restore(like)
    assert got[0]["b"]["x"].dtype == torch.float64


def test_flat_dict_checkpoints_keep_their_layout(tmp_path):
    """A flat dict of host arrays (`SolveCheckpointer`'s trees) is stored
    in sorted key order under its keys, as before."""
    cm = CheckpointManager(str(tmp_path))
    tree = {"z": np.arange(3.0), "w": np.ones(2, np.float32),
            "key": np.array([1, 2], np.uint32)}
    cm.save(1, tree)
    raw = cm.load_raw(1)
    assert sorted(raw) == ["key", "w", "z"]
    assert cm.manifest(1)["treedef"] == \
        "PyTreeDef({'key': *, 'w': *, 'z': *})"
    _, got = cm.restore({k: np.zeros_like(v) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_array_equal(got[k], tree[k])


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The reference's manager restores a nested tree the port wrote, and
    the port's restores one the reference wrote (float32, int32)."""
    tree = _torch_tree()
    tree[0]["a"] = tree[0]["a"].float()
    jlike = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.asarray(
        t.numpy()).dtype), tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    jlike = (jlike[0], JaxAdamWState(*jlike[1]), jlike[2])
    CheckpointManager(str(tmp_path / "t")).save(2, tree)
    step, jgot = JaxManager(str(tmp_path / "t")).restore(jlike)
    assert step == 2
    for (_, a), (_, b) in zip(_flatten_with_names(jgot),
                              flatten_with_names(tree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    JaxManager(str(tmp_path / "j")).save(4, jgot)
    like = jax.tree.map(torch.zeros_like, tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    like = (like[0], AdamWState(*like[1]), like[2])
    step, got = CheckpointManager(str(tmp_path / "j")).restore(like)
    assert step == 4
    for (_, a), (_, b) in zip(flatten_with_names(got),
                              flatten_with_names(tree)):
        assert torch.equal(a, b)


def test_elastic_mesh_provider_degrades_the_model_axis():
    """A world of 1 on the CPU: any model_parallel degrades to 1. The
    process group it starts is taken down again."""
    import torch.distributed as dist
    started = not dist.is_initialized()
    try:
        mesh = ElasticMeshProvider(model_parallel=4).make(device="cpu")
        assert mesh.shape == {"data": 1, "model": 1}
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
