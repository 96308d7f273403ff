"""Markdown table of a dry-run sweep (``repro_torch.launch.dryrun --all``):
one row a config, one column a shape, each cell its two scan passes'
per-rank memory (16x16 / 2x16x16) beside its cost pass's roofline terms
(compute / memory / collective, the dominant one, the useful share), and
the counts of ok, skipped and failed passes.

    PYTHONPATH=src python tools/dryrun_table.py reports/dryrun_torch

Reads the sweep's per-pass JSON reports from the directory (the
``summary.json`` of the last ``--all`` run is not needed). The terms are
a model on ``distributed/roofline.py``'s H100 SXM constants, not a
measurement.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def _mem(rep: dict | None) -> str:
    if rep is None or rep.get("skipped"):
        return "-"
    if not rep.get("ok"):
        return "**fail**"
    m = rep["memory"]
    return f"{m['per_chip_gb']:.2f}{'' if m['fits_80gb'] else ' (no fit)'}"


def _entry(passes: dict) -> str:
    """One cell: its scan passes' memory per rank (16x16 / 2x16x16), its
    cost pass's three terms, dominant term and useful share."""
    if all(r.get("skipped") for r in passes.values()):
        return "skip"
    cost = passes.get("cost")
    if cost is None or not cost.get("ok"):
        terms = "**fail**: " + cost["error"][:80] if cost else "-"
    else:
        r = cost["roofline"]
        terms = (f"{r['t_compute_ms']:.1f} / {r['t_memory_ms']:.1f} / "
                 f"{r['t_collective_ms']:.1f} ms, {r['dominant']}, {r['useful_frac']:.3f}")
    return f"{_mem(passes.get('sp'))} / {_mem(passes.get('mp'))} GB; {terms}"


def main(out_dir: str) -> None:
    reports = [json.loads(p.read_text()) for p in sorted(Path(out_dir).glob("*__*.json"))]
    cells: dict = {}
    for r in reports:
        kind = ("cost" if r.get("mode") == "unroll-extrap"
                else "mp" if r["mesh"] == "2x16x16" else "sp")
        cells.setdefault(r["arch"], {}).setdefault(r["shape"], {})[kind] = r
    ok = sum(1 for r in reports if r.get("ok") and not r.get("skipped"))
    skip = sum(1 for r in reports if r.get("skipped"))
    print(f"{len(reports)} passes: {ok} ok, {skip} skipped, {len(reports) - ok - skip} failed\n")
    shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    print("| arch | " + " | ".join(shapes) + " |")
    print("| --- |" + " --- |" * len(shapes))
    for arch, by_shape in sorted(cells.items()):
        print(f"| {arch} | " + " | ".join(_entry(by_shape[s]) if s in by_shape else "-"
                                          for s in shapes) + " |")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "reports/dryrun_torch")
