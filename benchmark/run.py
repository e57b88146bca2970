"""Run one cell of the benchmark of ``pbrl_tpu_torch`` on the card.

    python3 -m benchmark.run --workload walk-ppo --seed 1234 --seconds 30 --trace 0

Everything a cell needs is found by name: the cell in
``benchmark/workloads/<name>.json``, its configuration in
``benchmark/configs/<config>.json``, its mode (train, eval, ...) in
``benchmark/modes/<mode>.py`` and each metric's reader in
``benchmark/metrics/<metric>.py``; ``BENCHMARK.json`` says which metrics a
cell reports. Set-up (imports, the env and its clip, the weights, the
kernel's build or load, the first iterations or a few eval steps) runs
first; then units (training iterations, or eval episodes) run back to back
until ``--seconds`` have passed. ``--trace 0`` reports the end-to-end
metrics, ``--trace 1`` the per-layer metrics, read from the benchmark's
own spans and from ``torch.profiler`` over one unit of the window. After
the window the program's state is freed and the plain reference judges
what the program produced; the numbers compared, each with its limit, are
the last lines on standard error and the last key of the result, which is
the last line on standard output.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pbrl_tpu")


def process_start_s() -> float:
    """Seconds since this process started, by the kernel's record of it."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str):
    """(the manifest, the cell, its configuration) by the cell's name."""
    manifest = load_json(ROOT, "BENCHMARK.json")
    cell = load_json(HERE, "workloads", f"{name}.json")
    conf = load_json(HERE, "configs", f"{cell['config']}.json")
    return manifest, cell, conf


def cell_metrics(manifest: dict, name: str, trace: bool):
    """The metrics the cell reports in this kind of run, in manifest order."""
    if not trace:
        return [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    e2e = {m["name"] for m in manifest["end_to_end"] if name in m.get("workloads", [name])}
    return [m for m in manifest["per_layer"]
            if name in m.get("workloads", [name]) and m["moves"] in e2e]


def mode_of(cell: dict):
    """The module ``benchmark/modes/<mode>.py`` that drives a cell."""
    return importlib.import_module(f"benchmark.modes.{cell['mode']}")


def reader(metric: str):
    """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        os.path.join(HERE, "metrics", f"{metric}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info():
    import torch

    info = {"kind": torch.cuda.get_device_name(0), "power_limit": "not read"}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        if out.returncode == 0:
            info["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return info


def synchronize(device):
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(prog, cell, seconds: float, trace: bool, log, device):
    """Units back to back until ``seconds`` have passed (a unit that would
    end past them is not started; the first always runs, and a traced run
    runs at least two, tracing the second). Returns the window's record."""

    from benchmark.trace import Trace

    proxy = prog.proxy
    proxy.mark = trace
    prof, traced = None, None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        lo, hi = cell.get("trace_steps", (None, None))

        def on_step(i):
            if len(proxy.segments) != 2 or lo is None:
                return
            if i == lo:
                prof.start()
            elif i == hi:
                synchronize(device)
                prof.stop()

        proxy.on_step = on_step
    spans = {}
    units = steps = 0
    longest = 0.0
    untraced = [0, 0.0]  # units and seconds outside the traced unit
    synchronize(device)
    t0 = time.perf_counter()
    while True:
        tu = time.perf_counter()
        whole = trace and units == 1 and cell.get("trace_steps") is None
        if whole:
            prof.start()
        n, unit_spans = prog.unit(split=trace)
        if whole:
            synchronize(device)
            prof.stop()
        if not (trace and units == 1):  # the traced unit's host spans carry the profiler
            for k, v in unit_spans.items():
                spans.setdefault(k, []).append(v)
        units += 1
        steps += n
        now = time.perf_counter()
        if not (trace and units == 2):
            untraced[0] += 1
            untraced[1] += now - tu
            longest = max(longest, now - tu)
        if (now - t0 + longest > seconds) and not (trace and units < 2):
            break
    synchronize(device)
    window_s = time.perf_counter() - t0
    proxy.on_step = None
    proxy.mark = False
    if trace:
        traced = Trace.from_profiler(prof)
    log(f"window: {units} units, {steps} env-steps in {window_s:.4f} s")
    return {"units": units, "env_steps": steps, "seconds": window_s, "spans": spans,
            "trace": traced, "untraced_units": untraced[0], "untraced_s": untraced[1]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    manifest, cell, conf = load_cell(args.workload)
    if not os.path.isdir(os.path.join(ROOT, "pbrl_tpu_torch")):
        log(f"no result: the checkout at {ROOT} holds no pbrl_tpu_torch to measure")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.get("chips", 1):
        log(f"no result: cell {args.workload} needs {cell.get('chips', 1)} CUDA device(s), "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = conf["matmul_precision"] == "tf32"
    torch.backends.cudnn.allow_tf32 = conf["matmul_precision"] == "tf32"
    result = run_cell(args, manifest, cell, conf, "cuda", log)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


def run_cell(args, manifest, cell, conf, device, log, break_program=None):
    """Set-up, window, metrics and the judgement of one run; the result
    line's object, or None when the run may print none. ``break_program``
    (tests) plants a fault in the program after its set-up objects exist."""
    import torch

    from benchmark import flops, judge

    on_card = torch.device(device).type == "cuda"
    prog = mode_of(cell).Program(cell, conf, device)
    kernel = prog.launches_kernel  # whether the mode steps through mimic_step_kernel
    if break_program is not None:
        break_program(prog)
    prog.start(args.seed)
    prog.warm()
    synchronize(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_start_s()
    log(f"set-up: {setup_s:.4f} s")
    if on_card and kernel:
        from pbrl_tpu_torch.ops import mimic_kernel

        log(f"kernel occupancy: {json.dumps(mimic_kernel.occupancy())}")
    launches0 = prog.launches() if kernel else 0
    win = run_window(prog, cell, args.seconds, bool(args.trace), log, device)
    intervals = prog.proxy.step_intervals_ms()
    launches = prog.launches() - launches0 if kernel else 0
    rollout_steps = win["units"] * prog.steps_per_unit // max(1, cell["num_envs"])
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"kernel launches in the window: {launches} for {rollout_steps} policy steps; "
        f"step intervals timed: {len(intervals)}")
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process holds {', '.join(bad)} after the window")
        return None
    prog.free()

    t_judge = time.perf_counter()
    ref = prog.reference(device)
    ctx = types.SimpleNamespace(
        setup_s=setup_s, seconds=win["seconds"], units=win["units"], env_steps=win["env_steps"],
        untraced_units=win["untraced_units"], untraced_s=win["untraced_s"],
        intervals_ms=intervals, spans=win["spans"], trace=win["trace"], program=prog,
        policy_steps_per_unit=prog.steps_per_unit // cell["num_envs"], num_envs=cell["num_envs"],
        flops=flops, log=log, card=card_info() if on_card else {}, kernel=None)
    if args.trace and kernel:
        spec = ref["env"].spec
        q, v, u = prog.kernel_inputs(ref["env"])
        prog.kernel_flop_per_env = flops.kernel_flop_per_env(spec, q, v, u)
        ctx.kernel = {"spec": spec, "flop_per_env": prog.kernel_flop_per_env,
                      "batch": cell["num_envs"]}
    metrics = {}
    for m in cell_metrics(manifest, args.workload, bool(args.trace)):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    numbers = prog.numbers(ref)
    log(f"the reference took {time.perf_counter() - t_judge:.2f} s")
    limits = cell["limits"]
    for k, v in numbers.items():
        if k not in limits:
            log(f"reading {k}: {v}")
    correct = judge.verdict(numbers, limits)
    checks = judge.report(numbers, limits)
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    log(f"correct: {correct}")
    out = {"correct": correct, "attempted": win["units"], "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": ctx.card.get("kind", "cpu"), "count": 1,
                      "memory_peak_bytes": peak}}
    if args.trace and win["trace"] is not None:
        tr = win["trace"]
        out["device"].update({"busy_s": tr.busy_ns() / 1e9, "window_s": tr.window_ns() / 1e9})
        out["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out


if __name__ == "__main__":
    sys.exit(main())
