"""Batched serving: prefill, then a greedy or temperature decode loop
(counterpart of ``repro/launch/serve.py``; every family).

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --full \\
        --batch 8 --prompt-len 512 --gen 64
    python -m repro_torch.launch.serve --device cpu --batch 4 \\
        --prompt-len 16 --gen 16          # smoke config on the CPU
    python -m repro_torch.launch.serve --arch llama-3.2-vision-11b \\
        --device cpu --batch 2 --prompt-len 16 --gen 8

The prompt's prefill takes the flash-attention kernel on the card for
every self-attention (``models/attention.py:prefill_attn``, and the
encoder's without the causal mask; an SSM prefill has none;
cross-attention is plain); each decode step is plain PyTorch, as the
reference's is XLA. Temperature sampling is
``argmax(logits / T + gumbel)``, the form of ``jax.random.categorical``
(``sample_next``), with the Gumbel noise from the server's own
``torch.Generator`` (other draws than JAX's). The vlm and encdec
frontends are stubs, as in the reference (``_aux_inputs``):
``image_embeds`` (B, image_tokens, d) or ``frames`` (B, encoder_len(P),
frontend_dim), standard normal bfloat16 draws from the same generator
before any noise (``stub_inputs``), unless the caller gives them
(``generate(aux=...)``). The CLI prints one JSON
object: ``wall_s`` and ``tokens_per_s`` of a second ``generate`` (the
first warms up), and row 0's tokens.

On a mesh (``Server(ctx=...)``, the reference's ``ShardCtx``; the dense
and MoE families) each rank holds its shards of the parameters and the cache and
serves its rows of the prompt batch; the logits are gathered over the
vocabulary, each row's noise is its row of one (B, V) draw, and
``generate`` returns every row on every rank.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..configs.registry import get_config, get_smoke_config, list_archs
from ..models.layers import ShardCtx
from ..models.model import (decode_step, encoder_len, image_tokens,
                            init_cache, prefill)
from ..models.transformer import check_mesh, init_lm


def sample_next(logits: torch.Tensor, temperature: float,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, V) float32 logits -> (B,) next tokens: the argmax at
    temperature 0, else ``argmax(logits / temperature + noise)`` with
    ``noise`` standard Gumbel draws of the logits' shape."""
    if temperature > 0:
        return torch.argmax(logits / temperature + noise, dim=-1)
    return torch.argmax(logits, dim=-1)


def gumbel_noise(shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Standard Gumbel draws, -log(E) with E ~ Exp(1), from ``generator``."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -torch.log(e.exponential_(generator=generator))


class Server:
    """Prefill + decode over a model's parameters.

    ``params`` (the port's parameter dict) is read as given, not copied:
    the online service passes the trainer's live tensors, which AdamW
    updates in place. Without it the parameters are drawn from ``seed``.
    ``device`` defaults to ``cuda`` and raises without a GPU."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 params: Optional[Dict] = None,
                 ctx: ShardCtx = ShardCtx()):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Server: device 'cuda' requested but no CUDA "
                               "device is available; pass device='cpu' to "
                               "run on the CPU")
        check_mesh(cfg, ctx)
        self.cfg = cfg
        self.ctx = ctx
        self.params = params if params is not None else init_lm(
            cfg, torch.Generator(device=self.device).manual_seed(seed),
            self.device, ctx)

    def set_params(self, params: Dict) -> None:
        """Serve other weights of the same tree (e.g. the live training
        state's)."""
        self.params = params

    def stub_inputs(self, B: int, prompt_len: int,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The frontend stubs of a batch of B prompts of ``prompt_len``
        (none for a family without a memory), on the server's device."""
        cfg, extra = self.cfg, {}

        def draw(shape):
            return torch.randn(shape, generator=generator,
                               device=self.device, dtype=torch.bfloat16)
        if cfg.is_encdec:
            extra["frames"] = draw((B, encoder_len(cfg, prompt_len),
                                    cfg.frontend_dim or cfg.d_model))
        if cfg.family == "vlm":
            extra["image_embeds"] = draw((B, image_tokens(cfg),
                                          cfg.d_model))
        return extra

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, gen_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 aux: Optional[Dict[str, torch.Tensor]] = None
                 ) -> np.ndarray:
        """prompts (B, P) int32 -> (B, P + gen_len): the prompt and its
        continuation. Greedy at temperature 0; the Gumbel noise of
        temperature sampling (and the frontend stubs, unless ``aux`` gives
        them) come from a generator seeded with ``seed``. Tokens stay on
        the device until the end (one copy out)."""
        B, P = prompts.shape
        dev, ctx = self.device, self.ctx
        gen = torch.Generator(device=dev).manual_seed(seed)
        cache = init_cache(self.cfg, B, P + gen_len, device=dev, ctx=ctx)
        lo, n = ctx.local("batch", B)
        tokens = torch.as_tensor(np.asarray(prompts[lo:lo + n], np.int32),
                                 device=dev)
        if aux is None:
            aux = self.stub_inputs(B, P, gen)
        batch = {"tokens": tokens,
                 **{k: torch.as_tensor(v, device=dev)
                    for k, v in aux.items()}}
        logits, cache = prefill(self.cfg, self.params, batch, cache, ctx)
        out = [tokens]
        pos = torch.full((1,), P, dtype=torch.long, device=dev)
        for i in range(gen_len):
            noise = None
            if temperature > 0:
                noise = gumbel_noise((B,) + tuple(logits.shape[1:]), gen,
                                     dev)
                noise = noise[lo:lo + n] if n < B else noise
            tok = sample_next(logits, temperature, noise)[:, None].to(
                torch.int32)
            out.append(tok)
            if i < gen_len - 1:    # the last token needs no next logits
                logits, cache = decode_step(self.cfg, self.params, tok,
                                            cache, pos, ctx)
                pos += 1
        return ctx.all_gather(torch.cat(out, dim=1), "batch",
                              0).cpu().numpy()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Prefill + decode (PyTorch "
                                 "port)")
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    server = Server(cfg, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    server.generate(prompts, args.gen, args.temperature)     # warm-up
    t0 = time.perf_counter()
    out = server.generate(prompts, args.gen, args.temperature)
    dt = time.perf_counter() - t0
    report = {"arch": cfg.name, "device": str(server.device),
              "batch": args.batch, "prompt_len": args.prompt_len,
              "generated": args.gen, "wall_s": dt,
              "tokens_per_s": args.batch * args.gen / dt,
              "sample_output": out[0].tolist()}
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
