"""Input data of the port: SNN rasters and LM token batches.

Port of `repro.data.pipeline`: `snn_batch` (rate-coded class rasters)
and `Pipeline` (`DataConfig`, `synth_tokens`) for the token, audio and
vision families.  They
draw from a `torch.Generator`, so their numbers differ from
`jax.random`'s for the same seed; the batches have the same shapes and
statistics.  Give both packages one batch as numpy arrays where bits
must agree.

`SNNPipeline` and `Pipeline` are the training streams: step -> batch, a
pure function of (seed, step) drawn on the CPU, so any step's batch can
be regenerated after a restart and every device trains on the same
numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.interface.session import resolve_device

PROTO_SEED = 7      # the JAX package draws its class prototypes from key 7


def snn_batch(generator: torch.Generator, batch: int, t_steps: int,
              d_in: int, n_classes: int, rate: float = 0.3, device=None):
    """Rate-coded event rasters with class-dependent firing patterns.

    Returns ``{"x": (batch, t_steps, d_in) float32 {0,1}, "y": (batch,)
    int64 labels}``: input i of a class-y sample fires with probability
    ``rate * (0.4 + proto[y, i])`` each step, ``proto`` a fixed {0,1}
    pattern per class.  Drawn on ``generator``'s device, returned on
    ``device`` (the CUDA device when None; pass ``device="cpu"`` for the
    CPU).
    """
    device = resolve_device(device)
    gdev = generator.device
    y = torch.randint(0, n_classes, (batch,), generator=generator,
                      device=gdev)
    proto = (torch.rand((n_classes, d_in),
                        generator=torch.Generator().manual_seed(PROTO_SEED))
             < 0.5).to(torch.float32).to(gdev)
    rates = rate * (0.4 + proto[y])                       # (B, d_in)
    x = (torch.rand((batch, t_steps, d_in), generator=generator, device=gdev)
         < rates[:, None, :]).to(torch.float32)
    return {"x": x.to(device), "y": y.to(device)}


class SNNPipeline:
    """step -> `snn_batch` of ``batch`` samples of ``cfg`` (an
    `SNNConfig`), drawn from a CPU generator seeded by (seed, step) and
    placed on ``device`` (the CUDA device when None; ``device="cpu"``
    for the CPU)."""

    def __init__(self, cfg, batch: int, seed: int = 0, device=None):
        self.cfg = cfg
        self.batch_size = batch
        self.seed = seed
        self.device = resolve_device(device)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        seed = np.random.SeedSequence([self.seed, step]).generate_state(1)
        gen = torch.Generator().manual_seed(int(seed[0]))
        return snn_batch(gen, self.batch_size, cfg.t_steps, cfg.d_in,
                         cfg.d_out, device=self.device)


# ---------------------------------------------------------------------------
# LM token batches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    copy_frac: float = 0.5      # fraction of positions in copy runs
    zipf_alpha: float = 1.1


COPY_BACK = 8               # a copied token repeats the one 8 positions back


def _zipf_logits(vocab: int, alpha: float) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
    return -alpha * torch.log(ranks)


def synth_tokens(generator: torch.Generator, batch: int, seq: int,
                 vocab: int, cfg: DataConfig) -> torch.Tensor:
    """(batch, seq) int32 tokens on ``generator``'s device: Zipfian
    unigrams (``p(rank k) ~ k^-alpha``), and with probability
    ``copy_frac`` a position repeats the token `COPY_BACK` positions back
    (cyclically, as ``jnp.roll``), so the CE loss has structure to
    learn.  The JAX package's distribution, not its numbers."""
    dev = generator.device
    probs = torch.softmax(_zipf_logits(vocab, cfg.zipf_alpha), -1).to(dev)
    base = torch.multinomial(probs, batch * seq, replacement=True,
                             generator=generator).reshape(batch, seq)
    copy_mask = torch.rand((batch, seq), generator=generator,
                           device=dev) < cfg.copy_frac
    shifted = torch.roll(base, COPY_BACK, dims=1)
    return torch.where(copy_mask, shifted, base).to(torch.int32)


AUDIO_MASK_RATE = 0.08      # HuBERT: frames masked, and scored, at 8%


class Pipeline:
    """step -> the LM batch of the model's family, a pure function of
    (seed, step): drawn from a CPU generator seeded by both and placed on
    ``device`` (the CUDA device when None; ``device="cpu"`` for the CPU),
    so any step's batch can be regenerated after a restart.

    - tokens: ``{"tokens", "labels"}``, each (global_batch, seq_len)
      int32, labels the next token and -100 at the last position;
    - audio: ``{"frames"}`` (B, S, d_in) float32 N(0, 1), ``{"mask"}``
      (B, S) bool at rate `AUDIO_MASK_RATE`, ``{"labels"}`` int32 units
      uniform in [0, vocab) where masked and -100 elsewhere (HuBERT
      scores the masked frames only);
    - vision: the token batch plus ``{"image_embeds"}`` (B, max(
      max_prefix, 1), d_in) float32 N(0, 1).

    The JAX package's distributions, not its numbers."""

    def __init__(self, model_cfg, data_cfg: DataConfig, device=None):
        self.mc = model_cfg
        self.dc = data_cfg
        self.device = resolve_device(device)

    def batch(self, step: int) -> dict:
        mc, dc = self.mc, self.dc
        b, s = dc.global_batch, dc.seq_len
        seed = np.random.SeedSequence([dc.seed, step]).generate_state(1)
        gen = torch.Generator().manual_seed(int(seed[0]))
        if mc.frontend.kind == "audio":
            frames = torch.randn((b, s, mc.frontend.d_in), generator=gen)
            mask = torch.rand((b, s), generator=gen) < AUDIO_MASK_RATE
            units = torch.randint(0, mc.vocab, (b, s), generator=gen,
                                  dtype=torch.int32)
            out = {"frames": frames, "mask": mask,
                   "labels": torch.where(mask, units, -100).to(torch.int32)}
        else:
            toks = synth_tokens(gen, b, s, mc.vocab, dc)
            out = {"tokens": toks, "labels": torch.cat(
                [toks[:, 1:], torch.full((b, 1), -100, dtype=torch.int32)],
                dim=1)}
            if mc.frontend.kind == "vision":
                out["image_embeds"] = torch.randn(
                    (b, max(mc.frontend.max_prefix, 1), mc.frontend.d_in),
                    generator=gen)
        return {k: v.to(self.device) for k, v in out.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
