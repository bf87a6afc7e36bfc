"""Multi-core spiking neural network on the simulated core-interface fabric.

Port of `repro.models.snn`: the paper's target workload, LIF neuron
cores exchanging spikes through the core interface (HAT arbiter out, CAM
routing LUT in).  The synaptic routing of the forward pass is the dense
matrix equivalent of the CAM fan-out (`routing_matrix`, bitwise equal to
the JAX one); ``account=True`` replays the spike raster through a
compiled `InterfaceSession` to report latency and energy per timestep.

Entry points, on torch tensors:

    params, topo = init_snn(torch.Generator().manual_seed(0), cfg)
    logits, rates, stats = snn_forward(params, topo, x, cfg,
                                       impl="pallas", account=True)

Tensors go to the CUDA device unless the caller passes ``device="cpu"``
(`init_snn`, `snn_params_from_numpy`); `snn_forward` runs where its
operands lie.  ``impl="xla"`` is the differentiable path (surrogate
gradient through `spike_fn`); ``impl="pallas"`` runs the neuron update
through the `lif_step` kernel on CUDA tensors (its plain version on CPU
tensors) and is for inference: call it under ``torch.no_grad()``.

On the card, the step's float32 matrix products must stay full float32:
`snn_forward` refuses to run with TF32 allowed for them
(``torch.backends.cuda.matmul.allow_tf32``), which would flip spikes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.interface.config import InterfaceConfig
from repro_torch.interface.session import Interface, resolve_device
from repro_torch.interface.types import (InterfaceParams, params_from_numpy,
                                         random_connectivity)
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.lif_step import ref as lif_ref


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    fabric: InterfaceConfig
    d_in: int = 64
    d_out: int = 10
    t_steps: int = 16
    decay: float = 0.9
    threshold: float = 1.0
    input_rate: float = 0.3

    @property
    def n_total(self) -> int:
        return self.fabric.cores * self.fabric.neurons_per_core


class SpikeFn(torch.autograd.Function):
    """Heaviside spike with the sigmoid surrogate gradient
    ``4 sigmoid(4v) (1 - sigmoid(4v))`` (the JAX package's custom JVP)."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return (v >= 0.0).to(v.dtype)

    @staticmethod
    def backward(ctx, grad):
        (v,) = ctx.saved_tensors
        sig = torch.sigmoid(4.0 * v)
        return 4.0 * sig * (1.0 - sig) * grad


def spike_fn(v: torch.Tensor) -> torch.Tensor:
    """Heaviside spike ``v >= 0`` with a sigmoid surrogate gradient."""
    return SpikeFn.apply(v)


def init_snn(generator: torch.Generator, cfg: SNNConfig, device=None):
    """Returns (params, topology), drawn from ``generator`` on its device
    and placed on ``device`` (the CUDA device when None).

    params: float tensors (differentiable) - input/readout/synapse weights.
    topology: static int/bool routing structure (CAM tags, targets, valid).
    The numbers differ from `repro.models.snn.init_snn` for the same seed;
    `snn_params_from_numpy` carries the JAX package's weights across.
    """
    device = resolve_device(device)
    gdev = generator.device
    n = cfg.n_total
    w_in = torch.randn((cfg.d_in, n), generator=generator,
                       device=gdev) / math.sqrt(cfg.d_in)
    fab = random_connectivity(generator, cfg.fabric)
    w_out = torch.randn((n, cfg.d_out), generator=generator,
                        device=gdev) / math.sqrt(n)
    params = {"w_in": w_in, "syn_w": fab.weights, "w_out": w_out}
    topology = {"tags": fab.tags, "valid": fab.valid, "targets": fab.targets}
    return ({k: v.to(device) for k, v in params.items()},
            {k: v.to(device) for k, v in topology.items()})


def snn_params_from_numpy(params, topology, device=None):
    """(params, topology) as torch tensors on ``device`` (the CUDA device
    when None) from numpy arrays, e.g. ``np.asarray`` of each leaf of the
    JAX package's `init_snn` output: ``w_in``, ``syn_w``, ``w_out``;
    ``tags``, ``valid``, ``targets``."""
    device = resolve_device(device)
    fab = params_from_numpy(topology["tags"], topology["valid"],
                            params["syn_w"], topology["targets"],
                            device=device)
    return ({"w_in": torch.tensor(np.asarray(params["w_in"], np.float32),
                                  device=device),
             "syn_w": fab.weights,
             "w_out": torch.tensor(np.asarray(params["w_out"], np.float32),
                                   device=device)},
            {"tags": fab.tags, "valid": fab.valid, "targets": fab.targets})


def fabric_params(params, topology) -> InterfaceParams:
    return InterfaceParams(tags=topology["tags"], valid=topology["valid"],
                           weights=params["syn_w"],
                           targets=topology["targets"])


def routing_matrix(fp: InterfaceParams, cfg) -> torch.Tensor:
    """Dense (N_total, N_total) equivalent of the CAM fan-out routing.

    ``r[src, core * n + target]`` sums the weights of the core's valid
    CAM entries whose tag is ``src`` and whose target is ``target``.
    Tags are decoded to addresses (a tag that is not a {0,1} address
    below N_total matches no source, as in the JAX tag comparison), and
    an entry's weight lands with one ``index_add`` per occurrence rank,
    so duplicate (source, target) pairs of a core add in ascending entry
    order without atomics: the JAX scatter's order, on any device.
    Differentiable in ``fp.weights``.
    """
    cores, _ = fp.valid.shape
    n = cfg.neurons_per_core
    total = cores * n
    dev = fp.weights.device
    tags = fp.tags.long()
    bit_w = 1 << torch.arange(cfg.tag_bits - 1, -1, -1, device=dev)
    src = (tags * bit_w).sum(-1)                                  # (C, E)
    hit = fp.valid & (src < total) & ((tags == 0) | (tags == 1)).all(-1)
    tgt = (torch.arange(cores, device=dev)[:, None] * n
           + fp.targets.long())
    idx = (src * total + tgt)[hit]          # core-major, ascending entries
    w = fp.weights[hit]
    r = torch.zeros(total * total, dtype=fp.weights.dtype, device=dev)
    if idx.numel():
        order = torch.argsort(idx, stable=True)
        sorted_idx = idx[order]
        pos = torch.arange(idx.numel(), device=dev)
        first = torch.ones_like(sorted_idx, dtype=torch.bool)
        first[1:] = sorted_idx[1:] != sorted_idx[:-1]
        start = torch.cummax(torch.where(first, pos, 0), 0).values
        rank = torch.empty_like(pos)
        rank[order] = pos - start           # occurrence rank of each entry
        for k in range(int(rank.max()) + 1):
            sel = rank == k
            r.index_add_(0, idx[sel], w[sel])
    return r.view(total, total)


def _check_matmul_precision(x: torch.Tensor) -> None:
    if x.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "snn_forward needs full float32 matrix products on the card; "
            "TF32 is allowed (torch.backends.cuda.matmul.allow_tf32 / "
            "torch.set_float32_matmul_precision): set it to 'highest'")


def spike_raster(params, r_mat, x_seq, cfg: SNNConfig, *,
                 impl: str = "xla") -> torch.Tensor:
    """The step loop of `snn_forward`: (B, T, d_in) inputs and the
    routing matrix -> (B, T, N_total) float32 {0,1} spikes.

    Each step drives the neurons with ``x_t @ w_in + s_prev @ r_mat`` in
    full float32 and updates them: under ``impl="xla"`` through the
    surrogate-gradient spike, otherwise through `lif_ops.lif_step` (the
    kernel on CUDA tensors), with bit-identical forward values.
    """
    b = x_seq.shape[0]
    v = torch.zeros((b, cfg.n_total), dtype=x_seq.dtype, device=x_seq.device)
    s = torch.zeros_like(v)
    spikes = []
    for t in range(x_seq.shape[1]):
        current = x_seq[:, t] @ params["w_in"] + s @ r_mat
        if impl == "xla":
            # differentiable path: surrogate-gradient spike + reset, with
            # the membrane update rounded once, as the jitted JAX step is
            v_pre = lif_ref.mul_add_once(v, cfg.decay, current)
            s = spike_fn(v_pre - cfg.threshold)
            v = v_pre * (1.0 - s)                         # reset to 0
        else:
            # fused kernel path (inference): bit-identical forward values
            v, s = lif_ops.lif_step(v, current, decay=cfg.decay,
                                    threshold=cfg.threshold, impl=impl)
        spikes.append(s)
    return torch.stack(spikes, 1)


def snn_forward(params, topology, x_seq, cfg: SNNConfig, *,
                impl: str = "xla", account: bool = False):
    """x_seq (B, T, d_in) spike/rate inputs -> logits (B, d_out).

    Returns (logits, rates (B, N_total), stats|None): ``stats`` holds the
    per-tick mean `StepStats` of the interface session that replays the
    spike raster, ``B * t_steps`` ticks in batch-major order, when
    ``account`` is true.

    Raises:
      ValueError: on an unknown ``impl`` (from `lif_ops.lif_step`).
      RuntimeError: on CUDA operands with TF32 matrix products allowed,
        or ``impl="pallas"`` with parameters that require grad while
        grad mode is on.
    """
    _check_matmul_precision(x_seq)
    b = x_seq.shape[0]
    fab = fabric_params(params, topology)
    r_mat = routing_matrix(fab, cfg.fabric)
    spikes = spike_raster(params, r_mat, x_seq, cfg, impl=impl)
    rates = spikes.mean(1)
    logits = rates @ params["w_out"]

    stats = None
    if account:
        sp = spikes.detach().reshape(b * cfg.t_steps, cfg.fabric.cores,
                                     cfg.fabric.neurons_per_core) > 0.5
        fab = InterfaceParams(*(f.detach() for f in fab))
        sess = Interface(cfg.fabric).compile(fab, device=sp.device)
        _, acc = sess.run(sp)
        stats = acc.mean(b * cfg.t_steps)
    return logits, rates, stats


def snn_loss(params, topology, batch, cfg: SNNConfig, *, impl: str = "xla"):
    logits, rates, _ = snn_forward(params, topology, batch["x"], cfg,
                                   impl=impl)
    labels = batch["y"].long()
    logp = torch.log_softmax(logits, -1)
    loss = -logp.gather(1, labels[:, None]).mean()
    # mild rate regularization keeps events sparse (the paper's regime)
    return loss + 0.01 * rates.square().mean()


class SNN(nn.Module):
    """The SNN as a module: ``w_in``, ``syn_w`` and ``w_out`` are
    parameters, the routing topology (``tags``, ``valid``, ``targets``)
    buffers; `forward` is `snn_forward`.

        model = SNN(cfg, *init_snn(generator, cfg))
    """

    def __init__(self, cfg: SNNConfig, params, topology):
        super().__init__()
        self.cfg = cfg
        self.w_in = nn.Parameter(params["w_in"])
        self.syn_w = nn.Parameter(params["syn_w"])
        self.w_out = nn.Parameter(params["w_out"])
        for name in ("tags", "valid", "targets"):
            self.register_buffer(name, topology[name])

    def param_dict(self) -> dict:
        return {"w_in": self.w_in, "syn_w": self.syn_w, "w_out": self.w_out}

    def topology(self) -> dict:
        return {"tags": self.tags, "valid": self.valid,
                "targets": self.targets}

    def forward(self, x_seq, impl: str = "xla", account: bool = False):
        return snn_forward(self.param_dict(), self.topology(), x_seq,
                           self.cfg, impl=impl, account=account)
