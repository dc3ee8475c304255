"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout (``BENCHMARK.json`` beside ``portbench/``),
on a machine with at least the cards the cell asks for.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checked``: each number that decided ``correct``
beside its limit, which also end standard error.  The run fails, and
prints no result, without CUDA or the cards, or if the JAX stack or the JAX
package was loaded.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import guard, spec, trace  # noqa: E402


def judge(checked: dict, limits: dict) -> dict:
    """Each number beside its limit.  A number the limits file marks as not
    compared is shown with the limit null; any other number without a
    limit fails."""
    return {name: {"value": value, "limit": limits.get(name, {}).get("limit")}
            for name, value in checked.items()}


def passes(judged: dict, limits: dict) -> bool:
    def ok(name, v):
        if limits.get(name, {}).get("compared", True) is False:
            return True
        return v["limit"] is not None and v["value"] <= v["limit"]

    return all(ok(name, v) for name, v in judged.items())


def result(cell, out: dict, trace_on: bool, device, package=spec.PACKAGE) -> dict:
    """The result line from a runner's output."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace_on:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], package).read(out["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    judged = judge(out["checked"], cell.limits)
    line = {"correct": passes(judged, cell.limits) and out["failed"] == 0,
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if trace_on:
        stretch = out["stretch"]
        dev.update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        line["breakdown"] = trace.breakdown(stretch)
    line["checked"] = judged
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = cell.runner().run(cell, cell.family(), args.seed, args.seconds, bool(args.trace),
                            device, lambda: time.perf_counter() - _START)
    line = result(cell, out, bool(args.trace), device)
    bad = guard.loaded_forbidden()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, v in line["checked"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
