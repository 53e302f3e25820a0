"""Serving launcher: batched prefill + greedy decode with the KV/state cache.

On the card (the default), full width, bf16 weights drawn from seed 0:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \\
      --batch 4 --prompt-len 64 --gen 16

On the CPU, a reduced config:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x7b --reduced \\
      --batch 4 --prompt-len 32 --gen 16 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models import model

__all__ = ["generate", "main"]


def _greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    """The next tokens, (B, 1) or (B, 1, K), as int32."""
    nxt = logits.argmax(dim=-1).to(torch.int32)
    return nxt[:, None, :] if cfg.num_codebooks > 1 else nxt[:, None]


@torch.inference_mode()
def generate(cfg, params, prompt_tokens: torch.Tensor, gen_len: int,
             cache_len: int | None = None) -> torch.Tensor:
    """Prefill the prompt (filling the cache), then greedy-decode
    ``gen_len`` tokens; returns them, (B, gen_len) or (B, gen_len, K).
    The cache is written in place step by step."""
    s = prompt_tokens.shape[1]
    logits_last, cache = model.prefill_with_cache(
        cfg, params, prompt_tokens, cache_seq_len=cache_len or s + gen_len
    )
    toks = []
    nxt = _greedy(cfg, logits_last)
    for i in range(gen_len):
        toks.append(nxt)
        logits, cache = model.decode_step(cfg, params, cache, nxt, s + i)
        nxt = _greedy(cfg, logits)
    return torch.cat(toks, dim=1)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device; pass --device cpu for the CPU")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    elif device.type == "cuda":
        cfg = cfg.with_dtypes("bfloat16", "bfloat16")
    gen = torch.Generator(device=device).manual_seed(0)
    params, _ = model.init_params(cfg, gen)
    shape = (
        (args.batch, args.prompt_len, cfg.num_codebooks)
        if cfg.num_codebooks > 1
        else (args.batch, args.prompt_len)
    )
    prompt = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=device,
                           dtype=torch.int32)

    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, params, prompt, args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(json.dumps({
        "arch": args.arch,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "param_dtype": cfg.param_dtype,
        "generated_shape": list(out.shape),
        "tokens_per_s": round(args.batch * args.gen / dt, 2),
        "in_range": bool(((out >= 0) & (out < cfg.vocab_size)).all()),
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
