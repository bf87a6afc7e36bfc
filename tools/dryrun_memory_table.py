"""The dry runs' per-device memory, FLOPs and collective bytes, the
port's beside JAX's.

    python tools/dryrun_memory_table.py --shape train_4k \\
        --port build/dryrun_torch --jax build/dryrun_jax [--before DIR]
    python tools/dryrun_memory_table.py --view costs \\
        --shape decode_32k,long_500k,prefill_32k --port build/dryrun_torch \\
        --jax build/dryrun_jax --before DIR [--arch rwkv6-3b,llama3.2-3b]
        [--variant rwkv48]

Reads the cell records that ``python -m repro_torch.launch.dryrun``
(``--out``: the port's ``memory.peak_bytes``, rank 0's peak of the step
with its placed operands, and ``cost_calibrated``) and ``python -m
repro.launch.dryrun`` (``--out``: XLA's ``memory_analysis``, argument +
temp bytes, and ``cost_calibrated``) write, one JSON a cell, and prints
a markdown table.  ``--view peak`` (GB, 1e9 B): for each arch of
``--shape``, on each production mesh, the port's peak (and, given
``--before``, an earlier run's beside it), JAX's argument + temp and
their ratio.  ``--view costs``: a row a cell (arch, shape, mesh) of
every shape listed, per device and calibrated to the real depth: FLOPs,
collective bytes and all-gather bytes (GB), each the earlier run's
(``--before``), the port's, JAX's and port / JAX, and the port's peak
beside the earlier run's.  ``--variant`` reads each directory's
records of that dry-run variant instead (``--variant rwkv48``).  A
cell with no record reads "not run".
"""

from __future__ import annotations

import argparse
import json
import os


VARIANT = ""                      # "__<name>" under --variant


def _record(directory, arch, shape, mesh):
    if directory is None:
        return None
    path = os.path.join(directory, f"{arch}__{shape}__{mesh}{VARIANT}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    return rec if rec.get("status") == "ok" else None


def _port_peak(rec):
    return None if rec is None else rec["memory"].get("peak_bytes")


def _jax_bytes(rec):
    if rec is None:
        return None
    mem = rec["memory"]
    return mem["argument_bytes"] + mem["temp_bytes"]


def _gb(n):
    return "not run" if n is None else f"{n / 1e9:.2f}"


MESHES = (("singlepod", "16 × 16"), ("multipod", "2 × 16 × 16"))


def _cost(rec, key):
    """A record's calibrated per-device FLOPs (``"flops"``) or collective
    bytes of one op or in all (``"all-gather"``, ``"total"``); None
    without a record."""
    if rec is None or "cost_calibrated" not in rec:
        return None
    cal = rec["cost_calibrated"]
    return cal["flops"] if key == "flops" else cal["collectives"].get(
        key, 0)


def _ratio(new, jax):
    return f"{new / jax:.2f}" if new is not None and jax else "-"


def _flops(n):
    return "not run" if n is None else f"{n:.3e}"


def _gb4(n):
    return "not run" if n is None else f"{n / 1e9:.4g}"


def cost_rows(shapes, port, jax_dir, before=None, archs=None):
    """A row a (arch, shape, mesh) that either side recorded: FLOPs,
    collective bytes in all and all-gather bytes before, now and JAX's,
    and the peak before and now."""
    out = []
    for shape in shapes:
        names = {arch for arch, _ in rows(shape, port, jax_dir, before)}
        for arch in sorted(names & set(archs) if archs else names):
            for mesh, label in MESHES:
                recs = [_record(d, arch, shape, mesh)
                        for d in (before, port, jax_dir)]
                if not any(recs):
                    continue
                out.append((arch, shape, label,
                            [_cost(r, "flops") for r in recs],
                            [_cost(r, "total") for r in recs],
                            [_cost(r, "all-gather") for r in recs],
                            [_port_peak(r) for r in recs[:2]]))
    return out


def print_costs(shapes, port, jax_dir, before=None, archs=None):
    head = ["arch", "shape", "mesh", "FLOPs before", "FLOPs", "FLOPs JAX",
            "FLOPs port / JAX", "collectives GB before", "collectives GB",
            "collectives GB JAX", "collectives port / JAX",
            "all-gather GB before", "all-gather GB", "all-gather GB JAX",
            "all-gather port / JAX", "peak GB before", "peak GB"]
    print("| " + " | ".join(head) + " |")
    print("|" + " --- |" * len(head))
    for arch, shape, mesh, flops, coll, gathers, peak in cost_rows(
            shapes, port, jax_dir, before, archs):
        line = [arch, shape, mesh, *map(_flops, flops),
                _ratio(flops[1], flops[2]), *map(_gb4, coll),
                _ratio(coll[1], coll[2]), *map(_gb4, gathers),
                _ratio(gathers[1], gathers[2]), *map(_gb, peak)]
        print("| " + " | ".join(line) + " |")


def rows(shape, port, jax_dir, before=None):
    """(arch, [(before peak, peak, JAX argument + temp) for each of
    `MESHES`]) of every arch of ``shape`` that either side recorded."""
    archs = set()
    for d in (port, jax_dir, before):
        if d is not None and os.path.isdir(d):
            archs |= {n.split("__")[0] for n in os.listdir(d)
                      if n.endswith(f"{VARIANT}.json")
                      and f"__{shape}__" in n
                      and n.count("__") == 2 + bool(VARIANT)}
    return [(arch, [(_port_peak(_record(before, arch, shape, mesh)),
                     _port_peak(_record(port, arch, shape, mesh)),
                     _jax_bytes(_record(jax_dir, arch, shape, mesh)))
                    for mesh, _ in MESHES])
            for arch in sorted(archs)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--port", required=True)
    ap.add_argument("--jax", required=True)
    ap.add_argument("--before", default=None)
    ap.add_argument("--view", choices=("peak", "costs"), default="peak")
    ap.add_argument("--arch", default=None,
                    help="comma-separated archs (--view costs)")
    ap.add_argument("--variant", default=None,
                    help="a dry-run variant's records (rwkv48, ...)")
    args = ap.parse_args(argv)
    global VARIANT
    VARIANT = f"__{args.variant}" if args.variant else ""
    if args.view == "costs":
        print_costs(args.shape.split(","), args.port, args.jax, args.before,
                    args.arch.split(",") if args.arch else None)
        return
    head = ["arch"]
    for _, name in MESHES:
        head += ([f"{name} port before"] if args.before else []) + [
            f"{name} port", f"{name} JAX", "port / JAX"]
    print("| " + " | ".join(head) + " |")
    print("|" + " --- |" * len(head))
    for arch, cells in rows(args.shape, args.port, args.jax, args.before):
        line = [arch]
        for old, new, jax in cells:
            line += [_gb(old)] if args.before else []
            line += [_gb(new), _gb(jax),
                     f"{new / jax:.2f}" if new and jax else "-"]
        print("| " + " | ".join(line) + " |")


if __name__ == "__main__":
    main()
