"""The port's dense GQA LMs and LM training on the card.

Marked ``gpu``: each test decides inside itself whether there is a CUDA
device and skips with a reason when there is none.  Run on a machine
with the card (no JAX needed there, so the JAX conftest is left out):

    python -m pytest --noconftest -q -m gpu tests/test_torch_lm_gpu.py

The dense path launches no kernel of the port: it is plain torch, held
here card against CPU at the four architectures' smoke configs (logits
within rtol 1e-4 / atol 1e-5, as the CPU tests hold them to JAX; greedy
tokens equal), banded against masked full attention at gemma3-12b's
head shapes, and training (one step card against CPU; the restart drill
bitwise under deterministic algorithms).
"""

import dataclasses
import tempfile

import pytest
import torch

from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.ft import FailureInjector, run_training, run_with_restarts
from repro_torch.models import blocks, lm
from repro_torch.optim import adamw
from repro_torch.serve.lm_engine import ServeEngine
from repro_torch.train import step as train_step

ARCHS = ("internlm2-1.8b", "llama3.2-3b", "qwen3-32b", "gemma3-12b")
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the LM runs there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_on_the_card_matches_the_cpu(arch):
    device = _cuda()
    cfg = configs.get_smoke_config(arch)
    params = lm.init_model(torch.Generator().manual_seed(0), cfg,
                           device=device)
    cpu = _to(params, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    with torch.no_grad():
        got = lm.forward(params, {"tokens": toks.to(device)}, cfg)["logits"]
        want = lm.forward(cpu, {"tokens": toks}, cfg)["logits"]
    assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-5)
    prompts = toks[:, :12]
    a = ServeEngine(cfg, params, max_len=32).generate(prompts.to(device), 8)
    b = ServeEngine(cfg, cpu, max_len=32).generate(prompts, 8)
    assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_banded_attention_at_gemma3_heads_matches_masked_flash():
    device = _cuda()
    cfg = configs.get_config("gemma3-12b")
    gen = torch.Generator(device).manual_seed(0)
    t = 2048
    q = torch.randn((1, t, cfg.n_kv_heads, cfg.n_rep, cfg.head_dim),
                    generator=gen, device=device)
    k = torch.randn((1, t, cfg.n_kv_heads, cfg.head_dim), generator=gen,
                    device=device)
    v = torch.randn_like(k)
    with torch.no_grad():
        band = blocks.banded_attention(q, k, v, window=cfg.sliding_window)
        full = blocks.flash_attention(q, k, v, causal=True,
                                      window=cfg.sliding_window)
    assert torch.allclose(band, full, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu():
    """The loss within 1e-5 relative and each gradient within rtol 1e-4 /
    atol 1e-5 of its leaf's largest, card against CPU; the card's step is
    `adamw.update` of the card's own gradient, bit for bit."""
    device = _cuda()
    cfg = configs.get_smoke_config("gemma3-12b")
    state = train_step.init_state(torch.Generator().manual_seed(0), cfg, OPT,
                                  device=device)
    cpu_params = _to(state.params, "cpu")
    batch = Pipeline(cfg, DataConfig(4, 16), device="cpu").batch(0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, _, grads = train_step.value_and_grad(
            state.params, _to(batch, device), cfg, blocks.LOCAL, True, None)
        new, m = train_step.make_train_step(cfg, OPT)(state,
                                                      _to(batch, device))
    finally:
        torch.use_deterministic_algorithms(False)
    loss_cpu, _, grads_cpu = train_step.value_and_grad(
        cpu_params, batch, cfg, blocks.LOCAL, True, None)
    assert torch.allclose(loss.cpu(), loss_cpu, rtol=1e-5)
    for g, w in zip(grads, grads_cpu):
        tol = 1e-4 * w.abs() + 1e-5 * float(w.abs().max())
        assert bool(((g.cpu() - w).abs() <= tol).all())
    own, _, _ = adamw.update(OPT, tree_unflatten(state.params, grads),
                             state.opt, state.params)
    for a, b in zip(tree_leaves(new.params), tree_leaves(own)):
        assert torch.equal(a, b)
    assert float(m["loss"]) == float(loss)


@pytest.mark.gpu
def test_lm_restart_drill_is_bitwise_on_the_card():
    device = _cuda()
    cfg = dataclasses.replace(configs.get_smoke_config("internlm2-1.8b"),
                              compute_dtype="bfloat16")
    pipe = Pipeline(cfg, DataConfig(4, 32, seed=3), device=device)
    step = train_step.make_train_step(cfg, OPT)

    def fresh():
        return train_step.init_state(torch.Generator().manual_seed(0), cfg,
                                     OPT, device=device)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as d:
            clean, _ = run_training(
                step, fresh(), pipe, num_steps=6,
                manager=CheckpointManager(d + "/clean", every=2),
                logger=lambda *_: None)
            drilled, history = run_with_restarts(
                fresh, step, pipe, num_steps=6,
                manager=CheckpointManager(d + "/drill", every=2),
                injector=FailureInjector(fail_at_steps=(5,)),
                logger=lambda *_: None)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(history) == 2
    for a, b in zip(tree_leaves(drilled), tree_leaves(clean)):
        assert a.device.type == "cuda" and torch.equal(a, b)
