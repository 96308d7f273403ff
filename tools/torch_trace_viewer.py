"""Convert a telemetry JSONL event stream of the PyTorch port into a
Chrome/Perfetto trace, with the port's own modules (no JAX needed).

The port's continuous engine streams raw lifecycle events as JSONL while it
runs (``--events-out`` on ``repro_torch.launch.serve``, or
``Telemetry(jsonl_path=...)`` directly). This tool turns that stream into
the Chrome trace-event format that https://ui.perfetto.dev and
``chrome://tracing`` read: one timeline lane per KV slot, a scheduler lane
for queue events, and counter tracks for the engine gauges.

    PYTHONPATH=src python tools/torch_trace_viewer.py events.jsonl run.trace.json
    PYTHONPATH=src python tools/torch_trace_viewer.py events.jsonl   # -> stdout

(``repro_torch.launch.serve --trace-out`` writes the trace directly; this
tool is for streams captured as JSONL, e.g. from a run still going.)
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.serving.telemetry import load_events_jsonl  # noqa: E402
from repro_torch.serving.trace import chrome_trace  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("events", help="telemetry JSONL (one event per line)")
    ap.add_argument("out", nargs="?", default=None,
                    help="output .trace.json (default: stdout)")
    ap.add_argument("--name", default="serving-engine",
                    help="process name shown in the Perfetto UI")
    args = ap.parse_args(argv)

    events = load_events_jsonl(args.events)
    if not events:
        print(f"[torch_trace_viewer] no events in {args.events}", file=sys.stderr)
        return 1
    doc = chrome_trace(events, engine_name=args.name)
    text = json.dumps(doc)
    if args.out:
        Path(args.out).write_text(text)
        print(f"[torch_trace_viewer] {len(events)} events -> {args.out} "
              f"({len(doc['traceEvents'])} trace entries); open at "
              "https://ui.perfetto.dev")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
