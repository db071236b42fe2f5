"""`python -m repro_torch.launch.serve` and `launch.train` for the hybrid,
vlm and encdec families on the CPU: reduced configs, `--device cpu` (the
kernels' plain versions), one torch thread a case."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch import specs
from repro_torch.launch import train as ttrain
from repro_torch.models import decode as dec
from repro_torch.models.decls import init_params
from repro_torch.models.transformer import Model


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,prompt,calls", [
    ("recurrentgemma-2b", 2048, 1),   # one triple: one windowed layer
    ("recurrentgemma-2b", 40, 0),
    ("pixtral-12b", 2040, 2),         # 8 patches + 2040 tokens = 2048
    ("pixtral-12b", 2039, 0),
    ("whisper-small", 30, 0),
])
def test_serve_cli_runs_the_new_families(monkeypatch, arch, prompt, calls):
    """K6 (its plain version here) once an attention layer over 2048 keys
    or more, the hybrid's with its window; vlm's patches count."""
    seen = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: seen.append(k.get("window", 0)) or
                        real(*a, **k))
    out = serve.main(["--arch", arch, "--batch", "2", "--prompt-len",
                      str(prompt), "--new-tokens", "3", "--device", "cpu"])
    window = get_config(arch, reduced=True).hybrid
    assert seen == [window.window if window else 0] * calls
    assert out["tokens"].shape == (2, 3) and out["logits_finite"]
    assert np.all((out["tokens"] >= 0) & (out["tokens"] < 256))


@pytest.mark.parametrize("arch", ["pixtral-12b", "whisper-small"])
def test_serve_cli_is_the_model_driven_by_hand(arch):
    """Same seed: the CLI's continuation is prefill (with `prefix_specs`'
    patches or frames) + greedy decode_step on a model initialised from
    that seed."""
    args = ["--arch", arch, "--batch", "2", "--prompt-len", "9",
            "--new-tokens", "3", "--seed", "4", "--device", "cpu"]
    out = serve.main(args)
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(4))
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9))
    pre = specs.prefix_specs(cfg, 2, 4, "cpu")
    assert set(pre) == {"patches" if cfg.family == "vlm" else "frames"}
    extra = cfg.vlm.n_patches if cfg.family == "vlm" else 0
    logits, cache = dec.prefill(model, torch.as_tensor(prompts),
                                9 + 3 + extra, **pre)
    toks = []
    for _ in range(3):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks.append(tok)
        logits, cache = dec.decode_step(model, cache, tok)
    assert np.array_equal(out["tokens"], torch.cat(toks, 1).numpy())


def test_serve_cli_refuses_past_whisper_s_target_positions(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "whisper-small", "--prompt-len", "440",
                    "--new-tokens", "9", "--device", "cpu"])
    assert exc.value.code == 2
    assert "448 target positions" in capsys.readouterr().err


def test_prefix_specs_shapes_and_scale():
    for arch, key, n in (("pixtral-12b", "patches", 8),
                         ("whisper-small", "frames", 16)):
        cfg = get_config(arch, reduced=True)
        got = specs.prefix_specs(cfg, 3, 0, "cpu")[key]
        assert got.shape == (3, n, cfg.d_model)
        assert got.dtype == cfg.torch_dtype
        assert 0.015 < float(got.std()) < 0.025
    assert specs.prefix_specs(get_config("qwen2-0.5b", True), 3, 0,
                              "cpu") == {}


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "pixtral-12b",
                                  "whisper-small"])
def test_train_cli_trains_the_families_it_serves(arch, tmp_path):
    """`launch.train.main` in this process: two steps of the reduced
    config, finite losses, the kernels' plain versions (no launch)."""
    got = ttrain.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                       "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path)])
    assert got["loss_steps"] == [0, 1]
    assert np.all(np.isfinite(got["losses"]))
    assert sum(got["launches"].values()) == 0
