"""Render the §Roofline table from the port's dry-run sweep
(``python -m repro_torch.launch.dryrun --all``, reports in
``reports/dryrun_torch/*.json``), as ``benchmarks/roofline_table.py`` does
from the reference's. Single-pod cells only; the multi-pod passes prove
lowering and are summarized separately (``tools/dryrun_table.py``, which
reads the reports through :func:`load_reports`).

The port's dry run names its reports as the reference's does:
``{arch}__{shape}__sp__unroll`` is the 16x16 cost pass (trip-count-true
costs, extrapolated from a layer pair), ``{arch}__{shape}__sp`` the 16x16
scan pass (the production program's memory), ``{arch}__{shape}__mp`` the
2x16x16 scan pass. Memory fits against the H100's 80 GB (``fits_80gb``,
where the reference's TPU reports say ``fits_16gb``); a cell with no
memory record (a cost pass alone) shows ``nan`` GB and ``?``.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES

COLS = ("t_compute_ms", "t_memory_ms", "t_collective_ms")
REPORT_DIR = "reports/dryrun_torch"


def load_reports(report_dir: str = REPORT_DIR) -> dict:
    """Every pass's report in ``report_dir`` by its name (the file's stem),
    ``summary.json`` left out, unreadable files skipped. Raises
    ``FileNotFoundError`` if the directory does not exist."""
    root = Path(report_dir)
    if not root.is_dir():
        raise FileNotFoundError(f"no dry-run reports: {report_dir} is not a directory "
                                "(python -m repro_torch.launch.dryrun --all --out it)")
    out = {}
    for f in sorted(root.glob("*.json")):
        if f.name == "summary.json":
            continue
        try:
            out[f.stem] = json.loads(f.read_text())
        except (OSError, ValueError):
            pass
    return out


def cell_records(reports: dict, arch_id: str, shape: str):
    """(cost_record, memory_record): costs from the unrolled pass
    (trip-count-true), memory/fits from the scanned pass (the production
    program)."""
    unr = reports.get(f"{arch_id}__{shape}__sp__unroll")
    scan = reports.get(f"{arch_id}__{shape}__sp")
    cost = unr if (unr and unr.get("ok") and not unr.get("skipped")) else scan
    return cost, scan


def table(report_dir: str = REPORT_DIR) -> dict:
    reports = load_reports(report_dir)
    rows, skips, fails = [], [], []
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            cost, scan = cell_records(reports, arch, shape)
            rep = cost or scan
            if rep is None:
                fails.append((arch, shape, "missing"))
                continue
            if rep.get("skipped"):
                skips.append((arch, shape, rep.get("reason", "")))
                continue
            if not rep.get("ok"):
                fails.append((arch, shape, rep.get("error", "?")[:80]))
                continue
            r = rep["roofline"]
            mem = (scan or rep).get("memory", rep.get("memory", {}))
            rows.append({
                "arch": arch, "shape": shape, "mode": rep.get("mode", "?"),
                "t_compute_ms": round(r["t_compute_ms"], 3),
                "t_memory_ms": round(r["t_memory_ms"], 3),
                "t_collective_ms": round(r["t_collective_ms"], 3),
                "dominant": r["dominant"],
                "useful_pct": round(100 * r["useful_frac"], 1),
                "roofline_pct": round(100 * r["roofline_frac"], 2),
                "mem_gb": round(mem.get("per_chip_gb", float("nan")), 2),
                "fits": mem.get("fits_80gb"),
            })
    return {"rows": rows, "skips": skips, "fails": fails}


def markdown(report_dir: str = REPORT_DIR) -> str:
    t = table(report_dir)
    lines = ["| arch | shape | t_comp ms | t_mem ms | t_coll ms | bound | "
             "useful% | roofline% | GB/chip | fits 80 GB |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in t["rows"]:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_ms']} | "
            f"{r['t_memory_ms']} | {r['t_collective_ms']} | {r['dominant']} |"
            f" {r['useful_pct']} | {r['roofline_pct']} | {r['mem_gb']} | "
            f"{'?' if r['fits'] is None else 'y' if r['fits'] else 'N'} |")
    for a, s, reason in t["skips"]:
        lines.append(f"| {a} | {s} | — | — | — | skipped | — | — | — | — |")
    if t["fails"]:
        lines.append("")
        lines.append("Failures: " + "; ".join(
            f"{a}x{s}: {e}" for a, s, e in t["fails"]))
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown())
