"""The paper's evaluation on the port: one function per paper table or
figure (``paper_figures``), then the roofline table of the dry run.

    PYTHONPATH=src python -m repro_torch.paper.run [--skip-slow] [--device cpu]
        [--json reports/paper_torch.json] [--reports reports/dryrun_torch]

Emits ``[ok] name (s)`` lines, the roofline markdown (or ``[skip] roofline
table: ...``), ``name,metric,value`` CSV lines and a JSON dump, as
``benchmarks/run.py`` does for the reference. Runs on the card unless
``--device cpu`` is given; with no GPU and no ``--device`` it raises.
Returns 1 if any figure failed.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
import traceback
from pathlib import Path

from repro_torch.device import resolve_device


def _flatten(prefix: str, obj, rows: list):
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, rows)
    elif isinstance(obj, (int, float, bool)):
        rows.append((prefix, obj))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-slow", action="store_true",
                    help="skip table1 (trains a small model)")
    ap.add_argument("--json", default="reports/paper_torch.json")
    ap.add_argument("--reports", default="reports/dryrun_torch",
                    help="dry-run report dir for the roofline table")
    ap.add_argument("--device", default=None,
                    help="the device of fig7b's wall clock and table1 (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from repro_torch.paper import paper_figures as pf

    on_device = lambda fn: functools.partial(fn, device=device)
    benches = [
        ("fig7a_context_sweep", pf.fig7a_context_sweep),
        ("fig7b_speedup", on_device(pf.fig7b_speedup)),
        ("lut_exp_error", pf.lut_exp_error),
        ("fxp_attention_precision", pf.fxp_attention_precision),
        ("fig8a_breakdown", pf.fig8a_breakdown),
        ("table3_tokens_per_s", pf.table3_tokens_per_s),
    ]
    if not args.skip_slow:
        benches.append(("table1_topk_agreement", on_device(pf.table1_topk_agreement)))

    results, failures = {}, []
    for name, fn in benches:
        t0 = time.perf_counter()
        try:
            results[name] = fn()
            results[name]["_wall_s"] = round(time.perf_counter() - t0, 2)
            status = "ok"
        except Exception as e:      # a figure that fails is reported; the rest still run
            traceback.print_exc()
            failures.append(name)
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            status = "FAIL"
        print(f"[{status}] {name} ({results[name].get('_wall_s', '-')}s)")

    # roofline table from the dry-run sweep, if reports exist
    try:
        from repro_torch.paper import roofline_table
        md = roofline_table.markdown(args.reports)
        results["roofline_table"] = {"markdown": md}
        print("\n=== Roofline (single-pod cells, the dry run's model on the H100) ===")
        print(md)
    except (OSError, KeyError, ValueError) as e:
        print(f"[skip] roofline table: {e}")

    print("\n=== CSV ===")
    print("name,metric,value")
    for name, res in results.items():
        rows: list = []
        _flatten("", res, rows)
        for metric, value in rows:
            if metric.startswith("_") or metric == "markdown":
                continue
            print(f"{name},{metric},{value}")

    out = Path(args.json)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))
    print(f"\nwrote {out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
