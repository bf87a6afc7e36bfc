"""End-to-end LM training on the PyTorch port: a ~10M- or ~100M-param LM
for a few hundred steps, with checkpoint/restart fault tolerance (kill it
mid-run; rerun resumes).

    python examples/train_lm_torch.py --steps 300 --preset 100m
    python examples/train_lm_torch.py --steps 50 --preset 10m
    python examples/train_lm_torch.py --arch internlm2-1.8b ...
        (--arch uses the assigned architecture's reduced smoke config)
    python examples/train_lm_torch.py --device cpu ...   (plain torch)

The same flags as examples/train_lm.py, on `repro_torch`; the run is
`ft.runner.run_training` with a `CheckpointManager` (every 50 steps,
keep 2) and a `Watchdog`.  The default checkpoint directory lies under
the system's temporary directory.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import configs
from repro_torch.ckpt.manager import CheckpointManager, tree_leaves
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.ft.runner import Watchdog, run_training
from repro_torch.interface.types import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import step as ts

PRESETS = {
    "10m": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                head_dim=64, d_ff=1024, vocab=4096),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab=8192),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=sorted(PRESETS))
    ap.add_argument("--arch", default=None,
                    help="use an assigned arch's smoke config instead")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.arch:
        cfg = configs.get_smoke_config(args.arch)
    else:
        cfg = ModelConfig(name=f"lm-{args.preset}", family="dense",
                          param_dtype="float32", compute_dtype="float32",
                          **PRESETS[args.preset])
    opt = adamw.AdamWConfig(lr=3e-4 if args.preset == "100m" else 1e-3,
                            warmup_steps=20, total_steps=max(args.steps, 100))
    state = ts.init_state(torch.Generator().manual_seed(0), cfg, opt,
                          device=device)
    n = sum(x.numel() for x in tree_leaves(state.params))
    print(f"[train_lm] {cfg.name}: {n/1e6:.1f}M params, {args.steps} steps")

    pipe = Pipeline(cfg, DataConfig(global_batch=args.batch,
                                    seq_len=args.seq, seed=0), device=device)
    train = ts.make_train_step(cfg, opt, microbatch=args.microbatch)
    mgr = CheckpointManager(args.ckpt_dir, every=50, keep=2)
    state, history = run_training(train, state, pipe, num_steps=args.steps,
                                  manager=mgr, watchdog=Watchdog())
    print(f"[train_lm] done: loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f}")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f)
    return state, history


if __name__ == "__main__":
    main()
