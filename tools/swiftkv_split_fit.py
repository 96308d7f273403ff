#!/usr/bin/env python3
"""Fits the constants of ``swiftkv_decode``'s split policy
(``ops.split_count``: ``SATURATION_BYTES``, ``MERGE_TILES``) to n_split
sweeps taken on the card by ``tools/swiftkv_split_sweep.py``.

    python3 tools/swiftkv_split_fit.py [SWEEP.json ...]

Runs on the CPU. With no argument it reads the two sweeps kept in
``tools/swiftkv_split_sweeps/`` (one H100 80GB HBM3 at 700 W; the second
holds twelve more shapes, held out of the fit). For every point of a grid
of the constants, it picks each fitted shape's n_split with ``ops.split_count`` (the card's cluster counts
as the sweep recorded them) and scores the pick by its time over the
sweep's best at that shape, in the same run. It keeps the point of least
summed log ratio over every fitted shape of every run (both kernel forms:
the one saturation constant is the card's, the merge constant each
form's), then prints, shape by shape, that pick beside the best, for the
shapes held out of the fit too (``held_out`` in the sweep). It also fits
each form alone, its own saturation constant beside its merge constant,
to show whether the two forms agree on the card's.
"""
from __future__ import annotations

import itertools
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.swiftkv_decode import ops  # noqa: E402

SATURATION_GRID = [x * 1e5 for x in range(10, 41)]          # 1.0 .. 4.0 MB
MERGE_GRID = [0.0, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0, 1.5, 2.0]


def load(paths: list[str]) -> list[dict]:
    cases = []
    for run, path in enumerate(paths):
        for case in json.loads(Path(path).read_text())["cases"]:
            b, hq, hkv, s, d, length, int8, window, ring = case["shape"]
            form = case["form"]
            case["run"] = run
            case["ms"] = {int(n): t for n, t in case["ms"].items()}
            case["tiles"] = ops.split_tiles(s, window, form)
            cases.append(case)
    return cases


def pick(case: dict) -> int:
    return ops.split_count(case["pairs"], case["tiles"], case["tile_bytes"], case["clusters"],
                           case["form"])


def regret(case: dict) -> float:
    return case["ms"][pick(case)] / min(case["ms"].values())


def fit(cases: list[dict]) -> tuple[float, dict]:
    """The grid point of least summed log ratio over the fitted shapes
    (``ops``' own constants are left as they were)."""
    fitted = [c for c in cases if not c.get("held_out")]
    forms = {c["form"] for c in fitted}
    kept = ops.SATURATION_BYTES, ops.MERGE_TILES
    best = None
    try:
        for sat, m_fold, m_mma in itertools.product(SATURATION_GRID, MERGE_GRID,
                                                    MERGE_GRID if "mma" in forms else [0.0]):
            ops.SATURATION_BYTES, ops.MERGE_TILES = sat, {"fold": m_fold, "mma": m_mma}
            score = sum(math.log(regret(c)) for c in fitted)
            if best is None or score < best[0] - 1e-12:
                best = (score, sat, m_fold, m_mma)
    finally:
        ops.SATURATION_BYTES, ops.MERGE_TILES = kept
    _, sat, m_fold, m_mma = best
    return sat, {"fold": m_fold, "mma": m_mma}


def kept_sweeps() -> list[str]:
    return sorted(str(p) for p in (ROOT / "tools" / "swiftkv_split_sweeps").glob("*.json"))


def main(argv: list[str]) -> int:
    argv = argv or kept_sweeps()
    cases = load(argv)
    fitted_forms = {c["form"] for c in cases if not c.get("held_out")}
    shapes = {(c["form"], c["name"]) for c in cases if not c.get("held_out")}
    for form in sorted(fitted_forms):
        n = len({name for f, name in shapes if f == form})
        print(f"[fit] {form} form: {n} fitted shapes x {len(argv)} runs")
    for form in sorted(fitted_forms):
        sat, merge = fit([c for c in cases if c["form"] == form])
        print(f"[fit] {form} form alone: SATURATION_BYTES = {sat:.3g}, MERGE_TILES "
              f"{merge[form]}")
    sat, merge = fit(cases)
    ops.SATURATION_BYTES, ops.MERGE_TILES = sat, merge
    print(f"[fit] both forms: SATURATION_BYTES = {sat:.3g}, MERGE_TILES = {merge}")
    for held in (False, True):
        group = [c for c in cases if bool(c.get("held_out")) == held]
        if not group:
            continue
        ratios = [regret(c) for c in group]
        print(f"[fit] {'held-out' if held else 'fitted'} shapes: {len(group)} sweeps, the "
              f"pick's time over the best: max {max(ratios):.3f}, geometric mean "
              f"{math.exp(sum(map(math.log, ratios)) / len(ratios)):.4f}")
        for c, r in zip(group, ratios):
            best = min(c["ms"], key=c["ms"].get)
            print(f"  run {c['run']} {c['name']} ({c['form']}): pick {pick(c)} "
                  f"{c['ms'][pick(c)]:.4f} ms, best {best} {c['ms'][best]:.4f} ms, {r:.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
