"""The paper's own workload on the PyTorch port: train a multi-core SNN
and report what the core interface costs - comparing HAT against the
other arbitration schemes and the CSCD CAM against the conventional one.

    python examples/snn_multicore_torch.py                # on the GPU
    python examples/snn_multicore_torch.py --device cpu   # plain torch

The same workload as examples/snn_multicore.py, on `repro_torch`: AdamW
steps on the gradient of `snn_loss` through ``impl="xla"``, then the
accounted evaluation with the neurons through the `lif_step` kernel
(``impl="pallas"``) and the spike raster replayed with the fabric at
``impl="pallas_sparse"``: the `sparse_tick` whole-run kernel takes the
ticks within its event capacity, the dense fallback the rest (most of
them, once the net is trained), both under ``torch.no_grad()`` (on the
CPU their plain versions run), then the interface and NoC report.
Weights and batches are drawn from CPU generators, so every device
starts from the same numbers.

Smoke knobs, as in examples/snn_multicore.py: SNN_STEPS (train steps),
SNN_EVAL_BATCH (accuracy batch size).  `main` takes the config, the
step count and the device, and returns what it computed.
"""

import argparse
import dataclasses as dc
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import paper_dynaps
from repro_torch.core import arbiter, cam, ppa
from repro_torch.data.pipeline import SNNPipeline, snn_batch
from repro_torch.interface import Interface, ppa_report
from repro_torch.interface.types import resolve_device
from repro_torch.models import snn
from repro_torch.noc import placement, topology
from repro_torch.optim import adamw

STEPS = int(os.environ.get("SNN_STEPS", "40"))
EVAL_BATCH = int(os.environ.get("SNN_EVAL_BATCH", "128"))
TRAIN_BATCH = 32
OPT_CFG = adamw.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=80,
                            weight_decay=0.0)


def eval_config(cfg: snn.SNNConfig) -> snn.SNNConfig:
    """The accounted evaluation's config: the fabric at
    ``pallas_sparse`` (the whole-run sparse tick on the ticks within its
    event capacity, the dense fallback on the rest)."""
    return dc.replace(cfg, fabric=dc.replace(cfg.fabric,
                                             impl="pallas_sparse"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, steps: int, device):
    """``steps`` AdamW steps from the seed-0 SNN on `SNNPipeline`
    batches (seed 1).  Returns (params, topology, losses, host ms per
    step, each ending in a device sync)."""
    params, topo = snn.init_snn(torch.Generator().manual_seed(0), cfg,
                                device=device)
    state = (params, adamw.init(OPT_CFG, params))
    step_fn = functools.partial(snn.train_step, topology=topo, cfg=cfg,
                                opt_cfg=OPT_CFG)
    pipe = SNNPipeline(cfg, TRAIN_BATCH, seed=1, device=device)
    losses, step_ms = [], []
    for step in range(steps):
        t = time.perf_counter()
        state, metrics = step_fn(state, pipe.batch(step))
        _sync(device)
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"])
        if step % 10 == 0:
            print(f"  step {step:2d} loss {float(metrics['loss']):.4f}")
    return state[0], topo, [float(l) for l in losses], step_ms


def main(cfg=None, steps: int = STEPS, device=None,
         eval_batch: int = EVAL_BATCH) -> dict:
    cfg = paper_dynaps.smoke_config() if cfg is None else cfg
    device = resolve_device(device)
    print(f"[snn] {cfg.fabric.cores} cores x {cfg.fabric.neurons_per_core} "
          f"neurons, CAM {cfg.fabric.cam.entries}x{cfg.fabric.cam.bits}, on "
          f"{device}")
    params, topo, losses, step_ms = train(cfg, steps, device)

    # accuracy, with the interface accounted on the evaluation raster
    batch = snn_batch(torch.Generator().manual_seed(99), eval_batch,
                      cfg.t_steps, cfg.d_in, cfg.d_out, device=device)
    with torch.no_grad():
        logits, rates, stats = snn.snn_forward(
            params, topo, batch["x"], eval_config(cfg), impl="pallas",
            account=True)
    acc = float((logits.argmax(-1) == batch["y"]).float().mean())
    print(f"[snn] accuracy {acc:.2%}, mean rate {float(rates.mean()):.3f}")

    # --- core-interface report (the paper's PPA story) ---------------------
    n = cfg.fabric.neurons_per_core
    print("\n[interface] per-tick stats (trained network):")
    for k, v in stats._asdict().items():
        print(f"  {k:16s} {float(v):10.2f}")

    print("\n[interface] arbitration alternatives at this core size:")
    for scheme in arbiter.SCHEMES:
        sp = ppa.sparse_latency_units(scheme, n)
        ar = ppa.area_units(scheme, n)
        print(f"  {scheme:12s} sparse {sp:7.1f} units  "
              f"area {ar:6.1f} arbiters")

    print("\n[interface] CAM variants (512x11, per-search energy units):")
    for name, c in {
        "conventional": cam.CamConfig(512, cscd=False, feedback=False,
                                      speculative=False),
        "proposed (CSCD+fb+ss)": cam.CamConfig(512),
    }.items():
        e = cam.search_energy(c, n_match=1, n_mismatch=511)
        t = cam.cycle_time_ns(c)
        print(f"  {name:22s} energy {e:8.1f}  cycle {t:5.2f} ns")

    # --- NoC: what the inter-core transport costs on this trained net ------
    # one precompiled session per transport scheme; same spikes, and the
    # currents are bit-identical across sessions (tested invariant)
    fab = snn.fabric_params(params, topo)
    sp = (torch.rand((cfg.fabric.cores, n),
                     generator=torch.Generator().manual_seed(3))
          < float(rates.mean())).to(device)
    print("\n[noc] transport schemes (same spikes, same currents):")
    noc = {}
    for scheme in ("broadcast", "unicast", "multicast_tree"):
        c2 = dc.replace(cfg.fabric, noc=topology.NocConfig(scheme))
        _, st2 = Interface(c2).compile(fab, device=device).step(sp)
        noc[scheme] = st2
        print(f"  {scheme:14s} cam_searches {float(st2.cam_searches):8.0f}"
              f"  noc_hops {float(st2.noc_hops):7.0f}"
              f"  noc_energy {float(st2.noc_energy):9.0f}")

    # --- unified static PPA report (area / latency / energy per config) ----
    rep = ppa_report(cfg.fabric)
    print("\n[ppa] unified interface report:")
    for section in ("arbiter", "cam", "noc"):
        vals = ", ".join(f"{k}={v:.3g}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in rep[section].items())
        print(f"  {section:8s} {vals}")

    print("\n[noc] neuron-to-core placement (hyperedge-overlap optimizer):")
    a = placement.fanout_adjacency(fab, cfg.fabric)
    total = cfg.fabric.cores * n
    costs = {}
    for name, perm in {
        "identity": placement.identity_placement(total),
        "greedy": placement.greedy_overlap_placement(
            a, cfg.fabric.cores, n),
    }.items():
        cost = placement.traffic_cost(a, perm, cfg.fabric.cores, n)
        srch = placement.cam_search_count(a, perm, cfg.fabric.cores, n)
        costs[name] = (cost, srch)
        print(f"  {name:10s} traffic_cost {cost:8.0f}  cam_searches/tick"
              f" (all-fire) {srch:8.0f}")

    return {"params": params, "topology": topo, "losses": losses,
            "step_ms": step_ms, "accuracy": acc, "eval_batch": batch,
            "logits": logits, "rates": rates, "stats": stats, "noc": noc,
            "ppa": rep, "placement": costs}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    main(device=parser.parse_args().device)
