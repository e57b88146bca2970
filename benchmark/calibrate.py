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
    import importlib

    import torch

    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--units", type=int, default=1, help="window units before the judge")
    p.add_argument("--envs", type=int, default=0, help="another batch than the cell's")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    manifest, cell, conf = run.load_cell(args.workload)
    if args.envs:
        cell = dict(cell, num_envs=args.envs,
                    train_set={**cell.get("train_set", {}), "num_envs": args.envs})
    torch.backends.cuda.matmul.allow_tf32 = conf["matmul_precision"] == "tf32"
    seeds = [int(s) for s in args.seeds.split(",")]
    mode = importlib.import_module(f"benchmark.modes.{cell['mode']}")
    prog = mode.Program(cell, conf, args.device)
    ref = prog.reference(args.device)
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


if __name__ == "__main__":
    sys.exit(main())
