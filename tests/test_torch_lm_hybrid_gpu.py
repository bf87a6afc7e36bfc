"""The port's RWKV6, Jamba, frontend and int8-expert models on the card.

Marked ``gpu``: each test decides inside itself whether there is a CUDA
device and skips with a reason when there is none.  Run on a machine
with the card (no JAX needed there, so the JAX conftest is left out):

    python -m pytest --noconftest -q -m gpu tests/test_torch_lm_hybrid_gpu.py

Held card against CPU at the smoke configs of rwkv6-3b,
jamba-1.5-large-398b, hubert-xlarge, phi-3-vision-4.2b and
deepseek-v2-236b (bfloat16 and int8 experts): logits within rtol 1e-4 /
atol 1e-4, as the CPU tests hold them to JAX; greedy tokens equal; every
B5 launch of the MoE paths equal to its plain version; one RWKV training
step card against CPU; the Mamba scan over two chunks.
"""

import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
from repro_torch.kernels.moe_dispatch import ref as moe_ref
from repro_torch.models import blocks, lm, mamba
from repro_torch.optim import adamw
from repro_torch.serve.lm_engine import ServeEngine
from repro_torch.train import step as train_step

ARCHS = ("rwkv6-3b", "jamba-1.5-large-398b", "hubert-xlarge",
         "phi-3-vision-4.2b", "deepseek-v2-236b")
RTOL, ATOL = 1e-4, 1e-4
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


def _launches_held(calls):
    """Every recorded B5 launch against its plain version."""
    for args, _, (pos, load) in calls:
        want_pos, want_load = moe_ref.dispatch_positions_ref(*args)
        assert torch.equal(pos, want_pos) and torch.equal(load, want_load)
    return len(calls)


class _Record:
    """Record B5's launches while the block runs."""

    def __enter__(self):
        self.calls, self.orig = [], moe_kernel.dispatch_positions_cuda

        def wrapper(*args):
            out = self.orig(*args)
            self.calls.append((args, {}, out))
            return out
        moe_kernel.dispatch_positions_cuda = wrapper
        return self.calls

    def __exit__(self, *exc):
        moe_kernel.dispatch_positions_cuda = self.orig


@pytest.mark.gpu
@pytest.mark.parametrize("arch,int8", [(a, False) for a in ARCHS]
                         + [("deepseek-v2-236b", True)])
def test_smoke_model_on_the_card_matches_the_cpu(arch, int8):
    device = _cuda()
    cfg = configs.get_smoke_config(arch)
    if int8:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, quant_int8=True))
    params = lm.init_model(torch.Generator().manual_seed(0), cfg,
                           device=device)
    cpu = _to(params, "cpu")
    batch = Pipeline(cfg, DataConfig(2, 20, seed=1), device="cpu").batch(0)
    batch.pop("labels")
    with torch.no_grad(), _Record() as calls:
        got = lm.forward(params, _to(batch, device), cfg)["logits"]
    want = lm.forward(cpu, batch, cfg)["logits"]
    assert torch.allclose(got.cpu(), want, rtol=RTOL, atol=ATOL)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    assert _launches_held(calls) == n_moe
    if cfg.encoder_only:
        return
    prompts = Pipeline(cfg, DataConfig(2, 12, seed=2),
                       device="cpu").batch(0)["tokens"]
    with _Record() as calls:
        a = ServeEngine(cfg, params, max_len=32).generate(prompts.to(device),
                                                          8)
    b = ServeEngine(cfg, cpu, max_len=32).generate(prompts, 8)
    assert torch.equal(a.cpu(), b)
    assert _launches_held(calls) == n_moe * 9


@pytest.mark.gpu
def test_rwkv_train_step_on_the_card_matches_the_cpu():
    """The loss within 1e-5 relative and each gradient within rtol 1e-3 /
    atol 1e-3 of its leaf's largest, card against CPU (the chunked WKV's
    factored decay makes its gradients ten times as sensitive to the
    summation order as the dense models': `tests/test_torch_lm_hybrid.py`
    measures 4.05e-4 of the leaf's largest against JAX); the card's step
    is `adamw.update` of the card's own gradient, bit for bit."""
    device = _cuda()
    cfg = configs.get_smoke_config("rwkv6-3b")
    state = train_step.init_state(torch.Generator().manual_seed(0), cfg, OPT,
                                  device=device)
    cpu_params = _to(state.params, "cpu")
    batch = Pipeline(cfg, DataConfig(4, 32), device="cpu").batch(0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, _, grads = train_step.value_and_grad(
            state.params, _to(batch, device), cfg, blocks.LOCAL, True, None)
        new, _ = train_step.make_train_step(cfg, OPT)(state,
                                                      _to(batch, device))
    finally:
        torch.use_deterministic_algorithms(False)
    loss_cpu, _, grads_cpu = train_step.value_and_grad(
        cpu_params, batch, cfg, blocks.LOCAL, True, None)
    assert torch.allclose(loss.cpu(), loss_cpu, rtol=1e-5)
    for g, w in zip(grads, grads_cpu):
        tol = 1e-3 * w.abs() + 1e-3 * float(w.abs().max())
        assert bool(((g.cpu() - w).abs() <= tol).all())
    own, _, _ = adamw.update(OPT, tree_unflatten(state.params, grads),
                             state.opt, state.params)
    for a, b in zip(tree_leaves(new.params), tree_leaves(own)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_mamba_scan_over_two_chunks_matches_the_cpu():
    device = _cuda()
    gen = torch.Generator().manual_seed(3)
    t, di, n = 2 * mamba.SCAN_CHUNK, 64, 16
    u = torch.randn((2, t, di), generator=gen)
    dt = torch.rand((2, t, di), generator=gen) * 0.2
    b_t, c_t = (torch.randn((2, t, n), generator=gen) for _ in range(2))
    a = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(di, n)
    s0 = torch.randn((2, di, n), generator=gen) * 0.1
    args = (u, dt, b_t, c_t, a, s0)
    y, s = mamba._ssm_scan_chunked(*(x.to(device) for x in args))
    y_cpu, s_cpu = mamba._ssm_scan_chunked(*args)
    assert torch.allclose(y.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
    assert torch.allclose(s.cpu(), s_cpu, rtol=1e-5, atol=1e-5)
