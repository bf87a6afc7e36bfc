"""The dry runs' per-device memory of one shape, the port's beside JAX's.

    python tools/dryrun_memory_table.py --shape train_4k \\
        --port build/dryrun_torch --jax build/dryrun_jax [--before DIR]

Reads the cell records that ``python -m repro_torch.launch.dryrun``
(``--out``: the port's ``memory.peak_bytes``, rank 0's peak of the step
with its placed operands) and ``python -m repro.launch.dryrun``
(``--out``: XLA's ``memory_analysis``, argument + temp bytes) write, one
JSON a cell, and prints a markdown table of GB (1e9 B): for each arch
of ``--shape``, on each production mesh, the port's peak (and, given
``--before``, an earlier run's beside it), JAX's argument + temp and
their ratio.  A cell with no record reads "not run".
"""

from __future__ import annotations

import argparse
import json
import os


def _record(directory, arch, shape, mesh):
    if directory is None:
        return None
    path = os.path.join(directory, f"{arch}__{shape}__{mesh}.json")
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


def rows(shape, port, jax_dir, before=None):
    """(arch, [(before peak, peak, JAX argument + temp) for each of
    `MESHES`]) of every arch of ``shape`` that either side recorded."""
    archs = set()
    for d in (port, jax_dir, before):
        if d is not None and os.path.isdir(d):
            archs |= {n.split("__")[0] for n in os.listdir(d)
                      if n.endswith(".json") and f"__{shape}__" in n
                      and n.count("__") == 2}
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
    args = ap.parse_args(argv)
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
