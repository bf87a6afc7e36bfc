"""Serving engine: prefill + decode steps and a batched request loop.

Port of `repro.serve.lm_engine`.  `make_prefill_step` and
`make_decode_step` build the step functions; `ServeEngine` batches
requests, prefills them together, then decodes all lanes in lock-step
with per-lane stop handling.

    params = lm.init_model(torch.Generator("cuda").manual_seed(0), cfg)
    tokens = ServeEngine(cfg, params).generate(prompts, num_steps=32)

The engine runs where ``prompts`` lie (the parameters must be there
too), or on a mesh: ``ServeEngine(cfg, params, ctx=ctx)`` with the
parameters placed as DTensors by `parallel.sharding`.  Greedy decoding is the JAX package's token for token.  Sampling
(``temperature > 0`` with a ``generator``) draws Gumbel noise from that
`torch.Generator`: the same distribution as ``jax.random.categorical``,
not its numbers.  As in the JAX package, ``temperature > 0`` without a
generator decodes greedily.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm
from repro_torch.models.blocks import LOCAL, ShardCtx
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx = LOCAL):
    def prefill_step(params, batch, cache):
        out = lm.forward(params, batch, cfg, mode="prefill", cache=cache,
                         ctx=ctx)
        # next-token logits from the last position
        return out["logits"][:, -1], out["cache"]
    return prefill_step


def make_decode_step(cfg: ModelConfig, ctx: ShardCtx = LOCAL):
    def decode_step(params, cache, tokens, cache_len: int):
        """tokens (B, 1) -> (logits (B, V), the cache updated in place)."""
        out = lm.forward(params, {"tokens": tokens}, cfg, mode="decode",
                         cache=cache, cache_len=cache_len, ctx=ctx)
        return out["logits"][:, -1], out["cache"]
    return decode_step


def sample_categorical(generator: torch.Generator, logits: torch.Tensor):
    """One draw per row from softmax(logits), by the Gumbel-max trick with
    uniforms from ``generator`` (on its device)."""
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).to(logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


@dataclasses.dataclass
class ServeEngine:
    """Minimal batched-serving loop (greedy or sampled).  With an enabled
    ``ctx`` (`parallel.sharding.make_shard_ctx`) the parameters are
    DTensors on its mesh, the cache is placed by `cache_pspecs`, and
    every rank draws the same tokens from the gathered logits."""

    cfg: ModelConfig
    params: dict
    max_len: int = 256
    temperature: float = 0.0
    ctx: ShardCtx = LOCAL

    def __post_init__(self):
        self._prefill = make_prefill_step(self.cfg, self.ctx)
        self._decode = make_decode_step(self.cfg, self.ctx)

    @torch.no_grad()
    def generate(self, prompts: torch.Tensor, num_steps: int,
                 eos_id: int = -1,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """prompts (B, Tp) int -> (B, num_steps) int32 generated tokens."""
        b, tp = prompts.shape
        cache = lm.init_cache(self.cfg, b, self.max_len, device=prompts.device)
        if self.ctx.enabled:
            from repro_torch.parallel import regions, sharding
            cache = sharding.shard_tree(
                cache, sharding.cache_pspecs(cache, self.cfg, self.ctx),
                self.ctx.mesh)
            full = regions.full
        else:
            full = (lambda t: t)
        logits, cache = self._prefill(self.params, {"tokens": prompts}, cache)
        logits = full(logits)
        cache_len = tp
        toks = []
        done = torch.zeros((b,), dtype=torch.bool, device=prompts.device)
        for _ in range(num_steps):
            if self.temperature > 0.0 and generator is not None:
                nxt = sample_categorical(generator, logits / self.temperature)
            else:
                nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(done, 0, nxt.to(torch.int32))
            done = done | (nxt == eos_id)
            toks.append(nxt)
            logits, cache = self._decode(self.params, cache, nxt[:, None],
                                         cache_len)
            logits = full(logits)
            cache_len += 1
        return torch.stack(toks, dim=1)
