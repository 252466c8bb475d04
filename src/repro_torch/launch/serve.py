"""LM text generation: batched prefill + decode with KV caches.

Port of `repro.launch.serve`: the token-loop server for every family of
the model zoo: dense (GQA attention, KV caches), moe (DeepSeekMoE; MLA's
latent caches for deepseek-v2), ssm (RWKV-6, recurrent state), hybrid
(Jamba: Mamba states, one attention layer's KV cache, MoE), audio
(MusicGen: 4 codebook tokens a step) and vlm (llama-3.2-vision: the
image's K/V cached at prefill). `generate` runs one prefill and then one
decode step per new token
through the step functions of `launch.steps`, sampling greedily or at a
temperature from an explicit `torch.Generator`. The sampled token stays
on the model's device between steps; the host copies the tokens once,
at the end. The reference issues one more decode step after the last
token (its logits are never read); the port skips it, and the tokens
are the same.

    python -m repro_torch.launch.serve --arch qwen3-0.6b            # CUDA
    python -m repro_torch.launch.serve --arch qwen3-0.6b --device cpu
    python -m repro_torch.launch.serve --arch rwkv6-3b --device cpu
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --device cpu
    python -m repro_torch.launch.serve --arch llama-3.2-vision-90b --device cpu
    python -m repro_torch.launch.serve --arch musicgen-large --device cpu

As in the reference, `--reduced` is on and cannot be switched off
(`store_true` with `default=True`); serving a full-width config goes
through `generate` directly (as `chip_smoke.py` does).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model


@torch.no_grad()
def generate(model, prompts, *, max_new: int, max_len: int,
             temperature: float = 0.0, seed: int = 0,
             generator: Optional[torch.Generator] = None,
             image_embeds=None) -> np.ndarray:
    """prompts: (B, S) ints, or (B, S, K) for K codebooks (numpy or a
    tensor); image_embeds: (B, n_image_tokens, D) for the vision model.
    Returns the (B, max_new) int32 tokens, or (B, max_new, K); each step's
    K codebook tokens are fed back as (B, 1, K). Greedy at temperature 0,
    else sampled from softmax(logits / temperature) with `generator`
    (default: one on the model's device seeded with `seed`)."""
    dev = model.device
    tokens = torch.as_tensor(prompts).to(dev)
    prefill = make_prefill_step(model, max_len=max_len)
    decode = make_decode_step(model)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    logits, caches = prefill(tokens, image_embeds)
    cur = tokens.shape[1]
    out = []
    for i in range(max_new):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                    generator=generator)
        else:
            tok = torch.argmax(logits, dim=-1)
        # (B, 1), or (B, 1, K) for K codebooks
        tok = tok.reshape(logits.shape[0], 1, *logits.shape[1:-1])
        out.append(tok)
        if i + 1 < max_new:
            logits, caches = decode(tok, caches, cur + i)
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(0)
    shape = (args.batch, args.prompt_len, cfg.n_codebooks) \
        if cfg.n_codebooks else (args.batch, args.prompt_len)
    prompts = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    img = None
    if cfg.family == "vlm":
        from repro_torch.data.frontends import vision_embeddings
        cfg = cfg.with_(n_image_tokens=16)
        img = vision_embeddings(args.batch, 16, cfg.d_model)
    model = build_model(cfg, device=args.device).init(seed=0)
    max_len = args.prompt_len + args.max_new
    t0 = time.time()
    toks = generate(model, prompts, max_new=args.max_new, max_len=max_len,
                    temperature=args.temperature, image_embeds=img)
    dt = time.time() - t0
    print(f"arch={cfg.name} device={model.device} generated {toks.shape} "
          f"in {dt:.2f}s ({args.batch * args.max_new / dt:.1f} tok/s)")
    print("sample:", toks[0].reshape(args.max_new, -1)[:8].tolist())


if __name__ == "__main__":
    main()
