"""`python -m repro_torch.launch.serve` on the CPU: reduced configs,
`--device cpu` (the kernels' plain versions)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import decode as dec
from repro_torch.models.decls import init_params
from repro_torch.models.transformer import Model


def test_serve_cli_runs_reduced_qwen2(capsys):
    out = serve.main(["--arch", "qwen2-0.5b", "--batch", "3",
                      "--prompt-len", "12", "--new-tokens", "5",
                      "--device", "cpu"])
    assert out["tokens"].shape == (3, 5)
    assert np.all((out["tokens"] >= 0) & (out["tokens"] < 256))
    assert out["prefill_ms"] > 0 and out["decode_ms_per_token"] > 0
    assert out["tok_per_s"] > 0
    text = capsys.readouterr().out
    assert "prefill" in text and "tok/s" in text
    assert "sample continuations" in text


def test_serve_cli_is_the_model_driven_by_hand():
    """Same seed: the CLI's continuation is prefill + greedy decode_step on
    a model initialised from that seed, with numpy's prompts."""
    args = ["--arch", "gemma-7b", "--batch", "2", "--prompt-len", "9",
            "--new-tokens", "4", "--seed", "3", "--device", "cpu"]
    out = serve.main(args)
    assert np.array_equal(out["tokens"], serve.main(args)["tokens"])
    cfg = get_config("gemma-7b", reduced=True)
    model = Model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(3))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9))
    logits, cache = dec.prefill(model, torch.as_tensor(prompts), 13)
    toks = []
    for _ in range(4):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks.append(tok)
        logits, cache = dec.decode_step(model, cache, tok)
    assert np.array_equal(out["tokens"], torch.cat(toks, 1).numpy())


@pytest.mark.parametrize("prompt_len,calls", [(32, 0), (2048, 2)])
def test_prefill_takes_k6_from_2048_tokens(monkeypatch, prompt_len, calls):
    """Once a layer at 2048 tokens or more (reduced yi-6b: 2 layers), never
    below; on the CPU K6's plain version runs and counts no launch."""
    seen = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    ops.reset_launch_counts()
    serve.main(["--arch", "yi-6b", "--batch", "1", "--prompt-len",
                str(prompt_len), "--new-tokens", "2", "--device", "cpu"])
    assert len(seen) == calls
    assert ops.launch_counts()["flash_attention"] == 0


def test_serve_cli_one_new_token_has_no_decode_rate():
    out = serve.main(["--new-tokens", "1", "--prompt-len", "4",
                      "--device", "cpu"])
    assert out["tokens"].shape == (4, 1)
    assert out["decode_ms_per_token"] is None and out["tok_per_s"] is None


def test_serve_cli_refuses_unported_families(monkeypatch):
    """Every registered family is ported; a config of a family the port
    does not have is refused by name."""
    cfg = get_config("recurrentgemma-2b", reduced=True).replace(
        family="retnet")
    monkeypatch.setattr(serve, "get_config", lambda *a, **k: cfg)
    with pytest.raises(NotImplementedError, match="retnet"):
        serve.main(["--arch", "recurrentgemma-2b", "--device", "cpu"])


@pytest.mark.parametrize("arch,calls", [("deepseek-moe-16b", 3),
                                        ("grok-1-314b", 2),
                                        ("falcon-mamba-7b", 0)])
def test_serve_cli_runs_the_moe_and_ssm_families(monkeypatch, arch, calls):
    """Reduced configs at a 2048-token prompt: K6 (its plain version
    here) once an attention layer, deepseek's dense first layer included;
    none in the ssm family."""
    seen = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    out = serve.main(["--arch", arch, "--batch", "1", "--prompt-len",
                      "2048", "--new-tokens", "3", "--device", "cpu"])
    assert len(seen) == calls
    assert out["tokens"].shape == (1, 3)
    assert np.all((out["tokens"] >= 0) & (out["tokens"] < 256))


def test_serve_cli_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen2-0.5b"])
