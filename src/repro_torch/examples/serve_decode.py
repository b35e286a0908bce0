"""Serving path demo: batched one-token decode with per-family caches.

Loads reduced variants of three assigned architectures — dense GQA
(qwen2-0.5b, KV cache), SSM (mamba2-130m, O(1) recurrent state) and MLA
(deepseek-v2, compressed latent cache) — attaches a LoRA adapter, prefills a
prompt and greedily decodes continuations through ``serve_step``, verifying
decode-vs-prefill logits agreement along the way.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced_config
from repro_torch.core.lora import LoRAConfig, init_lora_params
from repro_torch.core.tree import tree_leaves
from repro_torch.examples import device_parser
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as T

ARCHS = ("qwen2-0.5b", "mamba2-130m", "deepseek-v2-236b")
LORA_SCALE = 0.5
ATOL = 2e-3


def config(arch: str):
    cfg = get_reduced_config(arch)
    if cfg.moe is not None:
        # raise expert capacity so no token drops — prefill routes per full
        # batch while decode routes per step, and dropped tokens would make
        # the two paths (correctly) disagree
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


@torch.no_grad()
def demo(arch: str, prompt_len=8, gen_len=8, batch=4, *, params=None,
         lora=None, prompt=None, device=None) -> dict:
    """Stream a prompt through ``serve_step`` against the forward pass,
    then decode greedily.  ``params``, ``lora`` (port trees on ``device``)
    and ``prompt`` (int [batch, prompt_len]) default to draws from
    generators seeded 0."""
    device = resolve_device(device)
    cfg = config(arch)
    if params is None:
        params = T.init_params(cfg, seed=0, device=device)
    if lora is None:
        lora = init_lora_params(
            T.lora_specs(cfg), LoRAConfig(rank=8),
            generator=torch.Generator(device=device).manual_seed(0))
    if prompt is None:
        prompt = torch.randint(
            4, cfg.vocab_size, (batch, prompt_len), device=device,
            generator=torch.Generator(device=device).manual_seed(0))
    prompt = torch.as_tensor(prompt, device=device).long()
    serve_step = make_serve_step(cfg, lora_scale=LORA_SCALE)
    max_len = prompt_len + gen_len
    cache = T.init_cache(cfg, params, batch, max_len)

    # prefill by streaming the prompt through serve_step (teacher forcing)
    full, _ = T.forward(cfg, params, prompt, lora=lora, lora_scale=LORA_SCALE)
    last, errs = None, []
    for t in range(prompt_len):
        last, cache = serve_step(params, lora, cache, prompt[:, t], t)
        err = float((last - full[:, t].float()).abs().max())
        if not err < ATOL:
            raise AssertionError(f"{arch}: decode/prefill mismatch {err}")
        errs.append(err)

    toks = [last.argmax(-1)]
    for t in range(prompt_len, max_len - 1):
        last, cache = serve_step(params, lora, cache, toks[-1], t)
        toks.append(last.argmax(-1))
    gen = torch.stack(toks, 1).cpu().numpy()
    cache_mb = sum(x.numel() * x.element_size()
                   for x in tree_leaves(cache)) / 2 ** 20
    print(f"{arch:<22} generated {gen.shape} | cache {cache_mb:.2f} MiB "
          f"| decode==prefill ✓")
    return {"gen": gen, "cache_mib": cache_mb, "errs": errs}


def main(argv=None) -> dict:
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    return {arch: demo(arch, device=args.device) for arch in ARCHS}


if __name__ == "__main__":
    main()
