"""Batched serving on the PyTorch port: prefill + lock-step decode over
request lanes.

    python examples/serve_lm_torch.py --arch llama3.2-3b
    python examples/serve_lm_torch.py --device cpu   (plain torch)

The same flags as examples/serve_lm.py (the arch's reduced smoke config,
temperature 0.8): sampling draws from a seeded `torch.Generator`, the
same distribution as the JAX example's, not its tokens.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import configs
from repro_torch.interface.types import resolve_device
from repro_torch.models import lm
from repro_torch.serve.lm_engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = configs.get_smoke_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only - no decode")
    params = lm.init_model(torch.Generator().manual_seed(0), cfg,
                           device=device)
    engine = ServeEngine(cfg=cfg, params=params, max_len=128,
                         temperature=0.8)

    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab, (args.lanes, 12), generator=gen,
                            dtype=torch.int32).to(device)
    sampler = torch.Generator(device).manual_seed(7)
    t0 = time.perf_counter()
    out = engine.generate(prompts, num_steps=args.steps, generator=sampler)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = args.lanes * args.steps
    print(f"[serve] {args.arch} ({cfg.name}): {args.lanes} lanes x "
          f"{args.steps} tokens in {dt:.2f}s ({total/dt:.1f} tok/s)")
    for i in range(args.lanes):
        print(f"  lane {i}: {out[i, :12].tolist()} ...")
    return out


if __name__ == "__main__":
    main()
