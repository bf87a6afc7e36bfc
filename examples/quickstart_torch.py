"""Quickstart on the PyTorch port: train a tiny LM for 30 steps,
checkpoint it, generate.

    python examples/quickstart_torch.py                # on the GPU
    python examples/quickstart_torch.py --device cpu   # plain torch

The same workload as examples/quickstart.py, on `repro_torch`: the
training loop is `ft.runner.run_training` with a `CheckpointManager`
that keeps the final step.  Parameters and batches are drawn from CPU
generators, so every device starts from the same numbers.

Smoke knobs, as in examples/quickstart.py: QUICKSTART_STEPS,
QUICKSTART_GEN_STEPS, QUICKSTART_CKPT_DIR (default: a directory under
the system's temporary directory).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.ckpt.manager import CheckpointManager, tree_leaves
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.ft.runner import run_training
from repro_torch.interface.types import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.serve.lm_engine import ServeEngine
from repro_torch.train import step as ts

STEPS = int(os.environ.get("QUICKSTART_STEPS", "30"))
GEN_STEPS = int(os.environ.get("QUICKSTART_GEN_STEPS", "16"))
CKPT_DIR = os.environ.get("QUICKSTART_CKPT_DIR", os.path.join(
    tempfile.gettempdir(), "repro_torch_quickstart"))


def main(device=None):
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="quickstart", family="dense", n_layers=4,
                      d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                      d_ff=512, vocab=512, param_dtype="float32",
                      compute_dtype="float32")
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=200)
    state = ts.init_state(torch.Generator().manual_seed(0), cfg, opt,
                          device=device)
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    print(f"model: {n_params/1e6:.1f}M params")

    pipe = Pipeline(cfg, DataConfig(global_batch=8, seq_len=128, seed=0),
                    device=device)
    mgr = CheckpointManager(CKPT_DIR, every=STEPS, keep=1, async_save=False)
    state, history = run_training(ts.make_train_step(cfg, opt), state, pipe,
                                  num_steps=STEPS, manager=mgr, log_every=5)
    print("checkpointed:", mgr.latest_step())

    engine = ServeEngine(cfg=cfg, params=state.params, max_len=160)
    prompts = pipe.batch(0)["tokens"][:2, :16]
    out = engine.generate(prompts, num_steps=GEN_STEPS)
    print("generated:", out[0].tolist())
    return history, out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    main(ap.parse_args().device)
