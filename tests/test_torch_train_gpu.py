"""The port's SNN training tier on the card.

Marked ``gpu``: each test decides inside itself whether there is a CUDA
device and skips with a reason when there is none.  Run on a machine
with the card (no JAX needed there, so the JAX conftest is left out):

    python -m pytest --noconftest -q -m gpu tests/test_torch_train_gpu.py
"""

import functools

import pytest
import torch

from repro_torch.ckpt import manager as ckpt
from repro_torch.configs import paper_dynaps
from repro_torch.data.pipeline import SNNPipeline
from repro_torch.models import snn
from repro_torch.optim import adamw

OPT = adamw.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=80,
                        weight_decay=0.0)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the training step runs there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _state(cfg, device):
    params, topo = snn.init_snn(torch.Generator().manual_seed(0), cfg,
                                device=device)
    return (params, adamw.init(OPT, params)), topo


@pytest.mark.gpu
def test_train_step_is_bitwise_repeatable_on_the_card():
    device = _cuda()
    cfg = paper_dynaps.smoke_config()
    state, topo = _state(cfg, device)
    step = functools.partial(snn.train_step, topology=topo, cfg=cfg,
                             opt_cfg=OPT)
    pipe = SNNPipeline(cfg, 32, seed=1, device=device)
    runs = []
    for _ in range(2):
        s = state
        for i in range(3):
            s, metrics = step(s, pipe.batch(i))
        torch.cuda.synchronize()
        runs.append((s, metrics))
    (a, ma), (b, mb) = runs
    assert a[0]["syn_w"].is_cuda and int(a[1].step) == 3
    for x, y in zip(ckpt.tree_leaves(a), ckpt.tree_leaves(b)):
        assert torch.equal(x, y)
    assert torch.equal(ma["loss"], mb["loss"])
    assert bool(torch.isfinite(ma["loss"]))


@pytest.mark.gpu
def test_restore_lands_on_the_card_by_default(tmp_path):
    device = _cuda()
    cfg = paper_dynaps.smoke_config()
    state, _ = _state(cfg, "cpu")
    path = str(tmp_path / "c.npz")
    ckpt.save(path, state, step=0)
    back = ckpt.restore(path, state)
    for got, want in zip(ckpt.tree_leaves(back), ckpt.tree_leaves(state)):
        assert got.device.type == device.type
        assert torch.equal(got.cpu(), want)
    on_cpu = ckpt.restore(path, state, device="cpu")
    assert on_cpu[0]["w_in"].device.type == "cpu"
