"""The port's train step computes each rank's share along "model": two
gloo ranks on the CPU at (1, 2) (`tests/torch_split_ranks.py`, a
subprocess) run one step of the reduced qwen2-0.5b, recurrentgemma-2b,
deepseek-moe-16b and falcon-mamba-7b and each shows logits over half
the padded vocabulary, half the heads (and the kv heads they read), half
of d_ff, half the experts, half the ssm and RG-LRU channels, and no
all-gather over "model" of a parameter block the rules split there but
the RG-LRU's w_a and w_i; a fused wqkv's loss and gradients match one
process's; the vocab-parallel loss and its gradient match the whole
vocabulary's; and a checkpoint saved at (1, 2) and at (2, 1) is byte
for byte one process's.

A file of its own: pytest's --dist loadfile puts it on another worker
than the in-process tests.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_each_rank_computes_its_share_along_model(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    (tmp_path / "ck").mkdir()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_split_ranks.py"),
         "--store", str(tmp_path / "store"), "--ckpt", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0 and "SPLIT_OK" in proc.stdout, \
        (proc.stdout[-2000:], proc.stderr[-6000:])
    seen = json.loads(next(x for x in proc.stdout.splitlines()
                           if x.startswith("SEEN "))[len("SEEN "):])
    assert set(seen) == {"qwen2-0.5b", "recurrentgemma-2b",
                         "deepseek-moe-16b", "falcon-mamba-7b"}
    assert seen["recurrentgemma-2b"]["gathered"]
    assert "gathered" not in seen["qwen2-0.5b"]
