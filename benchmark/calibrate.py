"""Readings that limits are set from, for one cell, in one process.

    python3 -m benchmark.calibrate --workload walk-eval --seeds 11,12,13 \\
        --control 3 --faults unchanged,half_batch,altered --fault-seeds 3 --out readings.json

For each seed the program runs its set-up and ``--units`` units of a
window (training: the first iterations and the last unit are judged;
eval: the window's records), and the reference judges it; the first ``--control`` seeds also read the control (the
reference in the lower precision in the program's place), and each fault
of ``--faults`` is planted in the program and read on the first
``--fault-seeds`` seeds. Writes every reading, and per number the largest
sound reading and the least control and fault readings, to ``--out``.

A number that judges the window's last unit (training: ``window_delta_gap``)
is read at one unit a seed that way, and a run's window holds a hundred or
more, each with its own draws. ``--every-unit N`` reads such numbers after
each of N units of every seed instead (the program's, the control's, and
under each fault), and ``--witness`` adds the program's and the
reference's gaps to the reference in float64:

    python3 -m benchmark.calibrate --workload walk-ppo --seeds 11,12,13 \\
        --every-unit 170 --witness --faults half_batch --fault-seeds 3 --out units.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import faults, run


def numbers_of(prog, ref, seed, units):
    prog.start(seed)
    prog.warm()
    for _ in range(units):
        prog.unit()
    return prog.numbers(ref)


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--units", type=int, default=1, help="window units before the judge")
    p.add_argument("--envs", type=int, default=0, help="another batch than the cell's")
    p.add_argument("--every-unit", type=int, default=0,
                   help="read the last unit's numbers after each of this many units instead")
    p.add_argument("--witness", action="store_true", help="with --every-unit: float64 gaps too")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    manifest, cell, conf = run.load_cell(args.workload)
    if args.envs:
        cell = dict(cell, num_envs=args.envs,
                    train_set={**cell.get("train_set", {}), "num_envs": args.envs})
    torch.backends.cuda.matmul.allow_tf32 = conf["matmul_precision"] == "tf32"
    seeds = [int(s) for s in args.seeds.split(",")]
    prog = run.mode_of(cell).Program(cell, conf, args.device)
    ref = prog.reference(args.device)
    if args.every_unit:
        return every_unit(args, prog, ref, seeds)
    out = {"workload": args.workload, "program": {}, "control": {}, "faults": {}}
    scalar = lambda d: {k: v for k, v in d.items() if isinstance(v, float)}
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        out["program"][seed] = nums = numbers_of(prog, ref, seed, args.units)
        print(f"seed {seed} program {json.dumps(scalar(nums))} ({time.perf_counter() - t:.1f} s)",
              file=sys.stderr, flush=True)
        if i < args.control:
            out["control"][seed] = c = prog.numbers(ref, control=True)
            print(f"seed {seed} control {json.dumps(scalar(c))}", file=sys.stderr, flush=True)
    for name in [f for f in args.faults.split(",") if f]:
        out["faults"][name] = {}
        for seed in seeds[:args.fault_seeds]:
            undo = faults.plant(name, prog)
            try:
                out["faults"][name][seed] = f = numbers_of(prog, ref, seed, args.units)
            finally:
                undo()
            print(f"seed {seed} fault {name} {json.dumps(scalar(f))}", file=sys.stderr, flush=True)
    keys = [k for k, v in next(iter(out["program"].values())).items() if isinstance(v, float)]
    summary = {}
    for k in keys:
        row = {"lower": max(n[k] for n in out["program"].values())}
        if out["control"]:
            row["control"] = min(n[k] for n in out["control"].values())
        for name, per in out["faults"].items():
            row[name] = min(n[k] for n in per.values())
        summary[k] = row
    out["summary"] = summary
    for k, row in summary.items():
        print(f"{k}: {json.dumps(row)}", file=sys.stderr)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    return 0


def every_unit(args, prog, ref, seeds) -> int:
    """``--every-unit``: the last unit's numbers after each unit, by seed."""
    def units(seed):
        prog.start(seed)
        prog.warm()
        rows = []
        for _ in range(args.every_unit):
            prog.unit()
            rows.append(prog.unit_readings(ref, witness=args.witness))
        return rows

    out = {"workload": args.workload, "units": {}, "faults": {}}
    for seed in seeds:
        t = time.perf_counter()
        out["units"][seed] = rows = units(seed)
        top = {k: max(r[k] for r in rows) for k in rows[0]}
        print(f"seed {seed} every unit, largest {json.dumps(top)} "
              f"({time.perf_counter() - t:.1f} s)", file=sys.stderr, flush=True)
    for name in [f for f in args.faults.split(",") if f]:
        out["faults"][name] = {}
        for seed in seeds[:args.fault_seeds]:
            undo = faults.plant(name, prog)
            try:
                out["faults"][name][seed] = units(seed)
            finally:
                undo()
    rows = [r for per in out["units"].values() for r in per]
    summary = {}
    for k in rows[0]:
        if k.startswith("control_"):
            continue
        row = {"lower": max(r[k] for r in rows), "units": len(rows)}
        if f"control_{k}" in rows[0]:
            row["control"] = min(r[f"control_{k}"] for r in rows)
        for name, per in out["faults"].items():
            row[name] = min(r[k] for rs in per.values() for r in rs)
        summary[k] = row
    out["summary"] = summary
    for k, row in summary.items():
        print(f"{k}: {json.dumps(row)}", file=sys.stderr)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
