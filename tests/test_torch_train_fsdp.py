"""FSDP over "data" in the port's train step (`train.steps.make_train_step`
over a `launch.mesh.Mesh`, `models.sharding.DataGather`) on gloo ranks on
the CPU: each layer's blocks gathered inside its forward and its remat
recompute, each gradient summed over "data" only into the rank's block.

The ranks (`tests/torch_fsdp_ranks.py`, a subprocess a world of 1, 2 and
4 ranks, run side by side) take every family's reduced config in float32
and bf16, with remat on and off, two train steps from one seeded init,
and report:

- at (2, 1) and (2, 2): the new step's losses, clip norms, parameters
  and AdamW moments bit for bit those of the step that gathers every
  block whole at its start, sums every whole gradient over "data"
  (`Mesh.psum_ordered`, float32) and keeps the rank's block
  (`sharding.local_slice`), assembled in the ranks' script; also where
  "data" does not divide the batch (every rank takes it whole);
- at (1, 1): the new step over the mesh bit for bit the step with no
  mesh;
- from `Mesh.counts`' bytes, each collective's bytes: no all-gather over
  "data" brings more than one layer's blocks (or those of the leaves
  outside the layers, gathered once at the start), and the gradient
  exchange brings a rank D - 1 pieces of its own blocks, not D - 1 whole
  gradients;
- with `sharding.EXCHANGE_ROW_BYTES` cut to one row of a leaf (qwen2 in
  bf16, recurrentgemma in float32): the exchange in many all-to-alls, none
  above the cap a row, the step still bit for bit the gather-all step.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-0.5b", "deepseek-moe-16b", "falcon-mamba-7b",
         "recurrentgemma-2b", "pixtral-12b", "whisper-small")
WORLDS = {1: "1x1", 2: "2x1", 4: "2x2"}
STEPS = 2                # tests/torch_fsdp_ranks.py's
WHOLE_BATCH = 3
CAPPED = {"qwen2-0.5b": ("bfloat16", False),
          "recurrentgemma-2b": ("float32", True)}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{mesh name: [case]} from one ranks subprocess a world."""
    tmp = tmp_path_factory.mktemp("fsdp")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    procs = {world: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_fsdp_ranks.py"),
         "--world", str(world), "--store", str(tmp / f"store{world}")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for world in WORLDS}
    out = {}
    for world, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0 and "FSDP_OK" in stdout, \
            (world, stdout[-2000:], stderr[-6000:])
        out[WORLDS[world]] = [json.loads(line[len("CASE "):])
                              for line in stdout.splitlines()
                              if line.startswith("CASE ")]
    return out


def _bit_equal(case) -> list:
    """The ranks' reports of `case` where the two routes differ."""
    return [(i, r["equal"], r["unequal"]) for i, r in enumerate(case["ranks"])
            if not all(r["equal"].values()) or any(r["unequal"].values())]


def _tag(case) -> str:
    return (f"{case['arch']} {case['dtype']} remat={case['remat']} "
            f"rows={case['rows']} at {case['mesh']}")


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_step_is_the_gather_all_step(cases, arch, mesh):
    mine = [c for c in cases[mesh] if c["arch"] == arch
            and c["rows"] != WHOLE_BATCH and c["row_bytes"] is None]
    assert {(c["dtype"], c["remat"]) for c in mine} == {
        (d, r) for d in ("float32", "bfloat16") for r in (False, True)}
    for case in mine:
        assert all(r["rows_split"] for r in case["ranks"]), _tag(case)
        assert not _bit_equal(case), (_tag(case), _bit_equal(case))


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_whole_batch_on_every_rank_keeps_the_rank_block(cases, mesh):
    mine = [c for c in cases[mesh] if c["rows"] == WHOLE_BATCH]
    assert {c["remat"] for c in mine} == {False, True}
    for case in mine:
        assert not any(r["rows_split"] for r in case["ranks"]), _tag(case)
        # no gradient is summed over "data": every rank has it whole
        assert not any(e[0] == "scatter" for r in case["ranks"]
                       for e in r["log"]), _tag(case)
        assert not _bit_equal(case), (_tag(case), _bit_equal(case))


@pytest.mark.parametrize("arch", ARCHS)
def test_size_one_mesh_is_the_one_process_step(cases, arch):
    mine = [c for c in cases["1x1"] if c["arch"] == arch]
    assert len(mine) >= 4
    for case in mine:
        (rank,) = case["ranks"]
        assert rank["issued"] == 0 and not rank["log"], _tag(case)
        assert not _bit_equal(case), (_tag(case), _bit_equal(case))


def _data(axes) -> bool:
    return "data" in axes


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_data_gathers_hold_one_layer_at_a_time(cases, mesh):
    """Each all-gather over "data" brings at most one layer's blocks (or
    the outside leaves'), and a step gathers the outside leaves once and
    each layer once, twice with remat (its recompute)."""
    for case in cases[mesh]:
        for r in case["ranks"]:
            D = r["D"]
            gathered = r["gathered"]
            layers = {u: b for u, b in gathered.items() if u != "top"}
            assert len(layers) == r["layers"] > 1, _tag(case)
            got = [b for kind, axes, b, _ in r["log"]
                   if kind == "gather" and _data(axes)]
            assert got and max(got) <= (D - 1) * max(gathered.values()), \
                (_tag(case), got, gathered)
            per_step = (gathered["top"] + (1 + case["remat"])
                        * sum(layers.values()))
            assert sum(got) == STEPS * (D - 1) * per_step, \
                (_tag(case), sum(got), per_step)
            # the route before FSDP gathered every block in one go
            before = [b for kind, axes, b, _ in r["log_before"]
                      if kind == "gather" and _data(axes)]
            assert max(got) < max(before), (_tag(case), got, before)


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_gradient_exchange_brings_only_the_rank_blocks(cases, mesh):
    """Where the rows split over "data", the gradient exchange brings a
    rank D - 1 pieces the size of its own blocks: (D - 1) / D of the
    gradients whole over "data", of which the route before FSDP brought
    D - 1 whole copies."""
    for case in cases[mesh]:
        if case["rows"] == WHOLE_BATCH:
            continue
        for r in case["ranks"]:
            D = r["D"]
            got = sum(b for kind, axes, b, _ in r["log"]
                      if kind == "scatter" and _data(axes))
            assert got == STEPS * (D - 1) * r["rank_bytes"], (_tag(case),
                                                              got)
            # a leaf split over "data" is D of the rank's blocks whole
            whole = r["rank_bytes"] + (D - 1) * sum(r["gathered"].values())
            before = sum(b for kind, axes, b, n in r["log_before"]
                         if kind == "sum" and _data(axes) and n > 1)
            assert before == STEPS * (D - 1) * whole, (_tag(case), before)
            assert got < before, (_tag(case), got, before)


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
@pytest.mark.parametrize("arch", sorted(CAPPED))
def test_capped_exchange_is_the_gather_all_step(cases, arch, mesh):
    """With EXCHANGE_ROW_BYTES at one row of a leaf the gradient exchange
    takes many all-to-alls, each bringing at most D - 1 rows of the cap
    and all of them together the same bytes as the one exchange a layer
    and dtype; the step is still the gather-all step bit for bit."""
    dtype, remat = CAPPED[arch]
    (case,) = [c for c in cases[mesh] if c["arch"] == arch
               and c["row_bytes"] is not None]
    (whole,) = [c for c in cases[mesh] if c["arch"] == arch
                and c["row_bytes"] is None and c["dtype"] == dtype
                and c["remat"] == remat and c["rows"] != WHOLE_BATCH]
    assert (case["dtype"], case["remat"]) == (dtype, remat), _tag(case)
    assert not _bit_equal(case), (_tag(case), _bit_equal(case))
    for r, w in zip(case["ranks"], whole["ranks"]):
        D = r["D"]
        got = [b for kind, axes, b, _ in r["log"]
               if kind == "scatter" and _data(axes)]
        once = [b for kind, axes, b, _ in w["log"]
                if kind == "scatter" and _data(axes)]
        assert max(got) <= (D - 1) * case["row_bytes"], (_tag(case), got)
        assert len(got) > 2 * len(once), (_tag(case), len(got), len(once))
        assert sum(got) == sum(once) == STEPS * (D - 1) * r["rank_bytes"], \
            (_tag(case), sum(got), sum(once))
        assert r["losses"] == w["losses"], _tag(case)
