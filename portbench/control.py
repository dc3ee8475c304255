"""The control of a cell's correctness numbers, and the faults a training
cell is held against: readings on the card at the cell's own size.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--out FILE]

The control is the float32 reference put in the program's place and
computed one precision below the cell's bf16: every product's operands
rounded to fp8 (``reference.lowp``).  A transfer cell's control makes its
own trajectory of the rows a run checks (``checked_rows_per_batch`` rows
of each of the window's first two batches) and the float32 reference
follows it, as it follows the program's.  A training cell's control runs
the checked steps; the fault "half of the batch left out, the mean taken
over the rest" is the float32 reference trained on the first half of each
batch.  Each line printed is one seed's readings by number; the limits are
set above the program's readings and below these.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import spec  # noqa: E402
from portbench.reference.lowp import Fp8Arith  # noqa: E402
from portbench.reference.models import Arith  # noqa: E402


def transfer_control(cell, fam, seed, device, batches=2) -> dict:
    from portbench.runners import ddib as run

    cfg, traffic = cell.config, cell.traffic
    models = run.reference_models(fam, cfg, seed, device)
    images, src, tgt = [], [], []
    for b in range(batches):
        rows = run.checked_rows(traffic, seed, b, device)
        x, s, t = run.inputs(fam, cfg, traffic, seed, b, device)
        images.append(x[rows])
        src.append(s[rows])
        tgt.append(t[rows])
    images, src, tgt = torch.cat(images), torch.cat(src), torch.cat(tgt)
    steps = traffic["num_inference_steps"]
    with torch.no_grad():
        states, final, decoded = run.trajectory(fam, models, Fp8Arith(), cfg, steps, images,
                                                src, tgt)
        per_step = []
        numbers = run.follow(fam, models, Arith(), cfg, steps, images, src, tgt, states,
                             final, decoded, per_step)
    numbers["per_step_worst"] = [max(g) for g in per_step]
    return {"control": numbers}


def train_control(cell, fam, seed, device) -> dict:
    from portbench.runners import train as run

    cfg, traffic = cell.config, cell.traffic
    ref = run.reference_steps(fam, cfg, traffic, seed, Arith(), device)
    out = {}
    half = slice(0, traffic["batch"] // 2)
    for name, ar, rows in (("control", Fp8Arith(), None), ("half_batch", Arith(), half)):
        got = run.reference_steps(fam, cfg, traffic, seed, ar, device, rows=rows)
        out[name] = run.compare(got["names"], got["losses"], got["grad"], got["change"],
                                got["ema"], ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", help="append each seed's readings to this JSON-lines file")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    fam = cell.family()
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.traffic["runner"] == "ddib":
            got = transfer_control(cell, fam, seed, device)
        else:
            got = train_control(cell, fam, seed, device)
        line = {"workload": args.workload, "seed": seed, **got}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
