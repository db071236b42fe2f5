"""Batched LM serving: prefill a batch of prompts, then decode greedily.
Port of `repro.launch.serve`, every family.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --full \\
        --batch 4 --prompt-len 4096 --new-tokens 32
    python -m repro_torch.launch.serve --arch deepseek-moe-16b --full ...
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --full ...
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --full ...
    python -m repro_torch.launch.serve --arch pixtral-12b --full ...
    python -m repro_torch.launch.serve --arch whisper-small --full \\
        --prompt-len 384 --new-tokens 32

Weights are random, drawn from a `torch.Generator` seeded with --seed on
the device; prompts come from `numpy.random.default_rng(seed)`, vlm's
patch embeddings and encdec's frame embeddings from `launch.specs.
prefix_specs` (a generator seeded with seed + 1). An attention layer over
BLOCKWISE_MIN_KV (2048) keys or more runs K6 (flash attention) in the
prefill (moe: deepseek's dense first layer too; the hybrid's attention
layers with their sliding window; vlm counts its patches), a shorter one
the dense route; decode attends with the dense route. The ssm family
(falcon-mamba) has no attention and runs no kernel; whisper's 1500
frames and at most 448 target positions stay on the dense route, and a
prompt plus new tokens past max_target_positions is refused.
grok-1-314b does not fit one card at full width: serve its reduced
config. Prints the
prefill time, the decode time a token and tokens/s over the decode steps
after the first, and the start of the continuations; returns them, and
whether the prefill's and the last step's logits were finite.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device, sync
from repro_torch.launch.specs import prefix_specs
from repro_torch.models import decode as dec
from repro_torch.models.decls import init_params
from repro_torch.models.transformer import Model
from repro_torch.train.steps import make_serve_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCH_IDS))
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the reduced one)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda raises when no card is present")
    args = ap.parse_args(argv)
    if args.new_tokens < 1:
        ap.error("--new-tokens must be at least 1")

    cfg = get_config(args.arch, reduced=not args.full)
    total = args.prompt_len + args.new_tokens
    if cfg.family == "encdec" and total > cfg.encdec.max_target_positions:
        ap.error(f"--prompt-len {args.prompt_len} + --new-tokens "
                 f"{args.new_tokens}: {args.arch} decodes at most "
                 f"{cfg.encdec.max_target_positions} target positions")
    dev = resolve_device(args.device)
    model = Model(cfg, dev)
    init_params(model, torch.Generator(device=dev).manual_seed(args.seed))
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    tokens = torch.as_tensor(prompts, device=dev)
    prefix = prefix_specs(cfg, args.batch, args.seed, dev)
    max_len = args.prompt_len + args.new_tokens + \
        (cfg.vlm.n_patches if cfg.family == "vlm" else 0)

    sync(tokens)
    t0 = time.perf_counter()
    logits, cache = dec.prefill(model, tokens, max_len=max_len, **prefix)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    sync(tok)
    prefill_s = time.perf_counter() - t0
    first_logits = logits

    serve_step = make_serve_step(model)
    generated = [tok]
    step_s = []
    for _ in range(args.new_tokens - 1):
        t0 = time.perf_counter()
        logits, cache = serve_step(cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        sync(tok)
        step_s.append(time.perf_counter() - t0)
        generated.append(tok)
    out = torch.cat(generated, dim=1).cpu().numpy()

    # the first decode step carries one-time costs (allocations, the
    # first launch of each op at the step's shapes): the rate leaves it out
    steady = step_s[1:]
    decode_ms = 1e3 * sum(steady) / len(steady) if steady else None
    tok_s = args.batch * len(steady) / sum(steady) if steady else None
    print(f"[serve] {args.arch}{' (full)' if args.full else ' (reduced)'} "
          f"on {dev}: batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new_tokens}; prefill {prefill_s * 1e3:.2f} ms, decode "
          + (f"{decode_ms:.3f} ms a token, {tok_s:.1f} tok/s (steps after "
             f"the first)" if steady else "n/a (fewer than 3 new tokens)"))
    print("[serve] sample continuations:", out[:2, :8].tolist())
    finite = all(bool(torch.isfinite(x).all()) for x in (first_logits,
                                                         logits))
    return {"arch": args.arch, "tokens": out, "logits_finite": finite,
            "prefill_ms": prefill_s * 1e3,
            "first_step_ms": step_s[0] * 1e3 if step_s else None,
            "decode_ms_per_token": decode_ms, "tok_per_s": tok_s}


if __name__ == "__main__":
    main()
