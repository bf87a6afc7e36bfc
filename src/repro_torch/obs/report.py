"""Per-tier breakdown reporting over benchmark / telemetry records.

    PYTHONPATH=src python -m repro_torch.obs.report BENCH_interface.json
    PYTHONPATH=src python -m repro_torch.obs.report serve.jsonl --scenario sparse_poisson

The port's own copy of `repro.obs.report`: it renders the records of
`repro_torch.serve.ServeEngine.serve_report()` (written by
`emit_report` through a `repro_torch.obs.metrics.JsonlSink`) as the JAX
package's CLI renders its own.

The paper's argument is a per-tier PPA accounting exercise - arbiter vs
CAM vs NoC vs inter-chip - so this CLI renders exactly that split.  Input
is either a ``benchmarks/noc_bench.py --json`` payload (records live
under ``"records"``) or a JSONL stream (one record per line, e.g. from
`repro_torch.obs.metrics.JsonlSink`).  Every record carrying a
``stats_per_tick`` dict (the per-tick-mean `StepStats` summary) gets one
table: latency, energy, and traffic per tier, with each tier's share of
the summed latency.  Tick wall-clock percentiles (``tick_ms_p50/p95/p99``,
from the benchmark's streaming histograms) are appended when present.
"""

from __future__ import annotations

import argparse
import json
import sys

# tier -> (latency field, energy field, traffic field, traffic unit)
TIERS = (
    ("arbiter", "encode_latency", "encode_energy", "events", "events"),
    ("cam", "cam_time_ns", "cam_energy", "cam_searches", "searches"),
    ("noc", "noc_latency", "noc_energy", "noc_hops", "hops"),
    ("chip", "chip_latency", "chip_energy", "chip_hops", "hops"),
)


def load_records(path: str) -> list:
    """Records from a noc_bench --json payload or a JSONL stream."""
    with open(path) as f:
        text = f.read()
    try:
        payload = json.loads(text)
    except json.JSONDecodeError:
        payload = None
    if isinstance(payload, dict):
        records = payload.get("records", [])
        meta = {k: v for k, v in payload.items() if k != "records"}
        return [{**meta, **r} for r in records]
    if isinstance(payload, list):
        return payload
    records = []
    for i, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{i + 1}: neither a JSON payload nor JSONL ({e})")
    return records


def tier_rows(stats: dict) -> list:
    """(tier, latency, energy, traffic, unit, latency share) per tier."""
    total_latency = sum(float(stats.get(lat, 0.0)) for _, lat, _, _, _ in TIERS)
    rows = []
    for tier, lat, en, traffic, unit in TIERS:
        latency = float(stats.get(lat, 0.0))
        energy = float(stats.get(en, 0.0))
        volume = float(stats.get(traffic, 0.0))
        share = latency / total_latency if total_latency > 0 else 0.0
        rows.append((tier, latency, energy, volume, unit, share))
    return rows


def _record_title(rec: dict) -> str:
    bits = [str(rec.get("scenario") or rec.get("benchmark") or rec.get("tenant") or "record")]
    if "cores" in rec and "neurons_per_core" in rec:
        bits.append(f"{rec['cores']} cores x {rec['neurons_per_core']} n/core")
    if "cam_entries_per_core" in rec:
        bits.append(f"{rec['cam_entries_per_core']} CAM entries")
    if "ticks" in rec:
        bits.append(f"{rec['ticks']} ticks")
    return " - ".join(bits)


def format_record(rec: dict) -> str:
    lines = [_record_title(rec)]
    stats = rec.get("stats_per_tick")
    if stats:
        lines.append(
            f"  {'tier':>8} {'latency/tick':>14} {'energy/tick':>13} "
            f"{'traffic/tick':>20} {'lat share':>9}"
        )
        for tier, latency, energy, traffic, unit, share in tier_rows(stats):
            lines.append(
                f"  {tier:>8} {latency:>14.2f} {energy:>13.1f} "
                f"{traffic:>12.1f} {unit:>7} {share:>8.1%}"
            )
    else:
        lines.append("  (no stats_per_tick in this record - tier table skipped)")
    pcts = [(k, rec[k]) for k in ("tick_ms_p50", "tick_ms_p95", "tick_ms_p99") if k in rec]
    if pcts:
        wall = "  ".join(f"{k.split('_')[-1]} {v:.3f} ms" for k, v in pcts)
        if "new_tick_ms" in rec:
            wall += f"  (min {rec['new_tick_ms']:.3f} ms)"
        lines.append(f"  tick wall clock: {wall}")
    elif "new_tick_ms" in rec:
        lines.append(f"  tick wall clock: min {rec['new_tick_ms']:.3f} ms")
    faults = rec.get("faults")
    if faults:
        counts = ", ".join(f"{k} {int(v)}" for k, v in sorted(faults.items()))
        lines.append(f"  faults: {counts}")
        rec_pcts = [(k, rec[k]) for k in ("recovery_ms_p50", "recovery_ms_p99") if k in rec]
        if rec_pcts:
            rendered = "  ".join(f"{k.split('_')[-1]} {v:.3f} ms" for k, v in rec_pcts)
            lines.append(f"  fault recovery: {rendered}")
    if rec.get("health") and rec["health"] != "healthy":
        lines.append(f"  health: {rec['health']}")
    return "\n".join(lines)


def format_report(records: list, scenario: str | None = None) -> str:
    chosen = [r for r in records if scenario is None or r.get("scenario") == scenario]
    with_stats = [
        r
        for r in chosen
        if r.get("stats_per_tick") or "new_tick_ms" in r or r.get("faults")
    ]
    if not with_stats:
        return "no reportable records" + (f" for scenario {scenario!r}" if scenario else "")
    head = []
    meta = chosen[0]
    if meta.get("platform") or meta.get("git_sha"):
        head.append(
            f"platform {meta.get('platform', 'unknown')}"
            f" - jax {meta.get('jax_version', 'unknown')}"
            f" - sha {str(meta.get('git_sha', 'unknown'))[:12]}"
        )
    return "\n\n".join(["\n".join(head)] * bool(head) + [format_record(r) for r in with_stats])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__.splitlines()[0]
    )
    ap.add_argument("path", help="noc_bench --json payload or JSONL record stream")
    ap.add_argument("--scenario", default=None, help="only records with this scenario tag")
    args = ap.parse_args(argv)
    try:
        records = load_records(args.path)
    except (OSError, ValueError) as e:
        print(f"error: {e}")
        return 1
    print(format_report(records, scenario=args.scenario))
    return 0


if __name__ == "__main__":
    sys.exit(main())
