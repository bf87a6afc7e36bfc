"""Every architecture of the registry on the port, as
`tests/test_arch_smoke.py` runs them in the JAX package.

For each of the ten archs: `get_config`, `get_smoke_config` and
`train_overrides` equal the JAX registry's field by field; the smoke
config runs one forward and one training step on the CPU on a
`Pipeline` batch of its family (tokens, audio frames, or tokens after
image patches), with finite logits of the expected shape, a finite loss
and gradient norm, and parameters that move.
"""

import numpy as np
import pytest
import torch

from repro import configs as jregistry
from repro_torch import configs as tregistry
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models import lm as tlm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep
from tests.test_torch_lm import _leaves, port_config

ARCHS = sorted(jregistry.ARCHS)


def test_registry_names_every_jax_arch():
    assert tregistry.ARCHS == jregistry.ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        tregistry.get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_overrides_are_the_jax_ones(arch):
    for get in ("get_config", "get_smoke_config"):
        assert getattr(tregistry, get)(arch) == port_config(
            getattr(jregistry, get)(arch)), (arch, get)
    assert tregistry.train_overrides(arch) == jregistry.train_overrides(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    cfg = tregistry.get_smoke_config(arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = tstep.init_state(torch.Generator().manual_seed(0), cfg, opt,
                             device="cpu")
    batch = Pipeline(cfg, DataConfig(global_batch=2, seq_len=16, seed=0),
                     device="cpu").batch(0)
    with torch.no_grad():
        out = tlm.forward(state.params, batch, cfg, mode="train",
                          remat=False)
    t_expect = 16 + (cfg.frontend.max_prefix
                     if cfg.frontend.kind == "vision" else 0)
    assert tuple(out["logits"].shape) == (2, t_expect, cfg.vocab)
    assert bool(out["logits"].isfinite().all()), f"{arch}: NaN logits"

    new, metrics = tstep.make_train_step(cfg, opt)(state, batch)
    assert np.isfinite(float(metrics["loss"])), f"{arch}: NaN loss"
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0.0
    delta = max(float((a - b).abs().max()) for (_, a), (_, b) in
                zip(_leaves(state.params), _leaves(new.params)))
    assert delta > 0.0


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
def test_remat_over_two_layer_groups_gives_the_same_gradients(arch):
    """The smoke configs stack a dense layer and two MoE layers as two
    groups; remat recomputes each group's repeats in the backward pass
    with that group's own parameters, so the gradients are bitwise the
    ones without remat."""
    cfg = tregistry.get_smoke_config(arch)
    assert len(cfg.scan_groups()) == 2
    params = tlm.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = Pipeline(cfg, DataConfig(global_batch=2, seq_len=16, seed=1),
                     device="cpu").batch(0)
    grads = {remat: tstep.value_and_grad(params, batch, cfg,
                                         remat=remat)[2]
             for remat in (False, True)}
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)
