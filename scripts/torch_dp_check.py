#!/usr/bin/env python3
"""Data-parallel PPO of the port on several cards against one process.

    python scripts/torch_dp_check.py --nproc 4 [--iters 2] [--num-envs 2048]

Runs ``python -m pbrl_tpu_torch.cli train --clip walk`` with the walk run's
config (``--num-envs`` in all x 16 steps, lr 1e-4, entropy_cost 0, seed 0) for
``--iters`` iterations as one process on card 0, then the same command
with ``--distributed`` under ``torchrun --nproc-per-node N`` (one process
per card, so NCCL), each with a timeout. Checks that the ranks name the
backend and the world, print the same final line, that rank 0's
checkpoint counts the whole batch's env steps, and that the first
iteration's ``reward_mean`` and ``episode_done_frac`` are within 1e-3 of
the one process's and its loss terms within 1% relative. Prints both
runs' last-iteration rollout and learn seconds and env-steps/s (the first
iteration holds the kernel's build and the warm-up) and the card's
``nvidia-smi`` line; exits non-zero on a failed check. Imports torch and
the port only.
"""

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TIMEOUT_S = 600
LOSSES = ("loss_policy", "loss_value", "entropy", "kl_approx")


def run(cmd, env=None):
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    if proc.returncode != 0:
        sys.exit(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return proc.stdout.splitlines()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--num-envs", type=int, default=2048, help="the whole batch (walk's: 2048)")
    args = ap.parse_args()

    import torch

    from pbrl_tpu_torch.train import checkpoint

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(f"cards: {torch.cuda.device_count()} | {smi[0] if smi else 'no nvidia-smi'}",
          flush=True)
    if torch.cuda.device_count() < args.nproc:
        sys.exit(f"needs {args.nproc} cards, found {torch.cuda.device_count()}")
    steps = args.iters * args.num_envs * 16
    base = ["-m", "pbrl_tpu_torch.cli", "train", "--clip", "walk", "--num-envs", str(args.num_envs),
            "--total-steps", str(steps), "--lr", "1e-4", "--train-set", "entropy_cost=0",
            "--seed", "0"]
    dirs = {k: os.path.join(ROOT, "build", f"dp_check_{k}") for k in ("one", "dp", "logs")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)

    one = [json.loads(ln) for ln in run([sys.executable, *base, "--checkpoint-dir", dirs["one"]],
                                        dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
           if ln.startswith("{")]
    # each rank's output in its own file (.../<local rank>/stdout.log): the
    # ranks' lines would interleave in torchrun's own output
    run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(args.nproc),
         "--master-port", "29517", "--log-dir", dirs["logs"], "--redirects", "3", *base,
         "--distributed", "--checkpoint-dir", dirs["dp"]])
    ranks = {}
    for path in glob.glob(os.path.join(dirs["logs"], "**", "stdout.log"), recursive=True):
        with open(path) as f:
            ranks[int(os.path.basename(os.path.dirname(path)))] = f.read().splitlines()
    heads = [json.loads(ranks[r][0]) for r in sorted(ranks)]
    finals = [ranks[r][-1] for r in sorted(ranks)]
    lines = [json.loads(ln) for ln in ranks[0] if ln.startswith("{")]
    progress = [ln for ln in lines if "iteration" in ln]
    ck = checkpoint.restore(dirs["dp"])
    first, first_one = progress[0], [ln for ln in one if "iteration" in ln][0]
    diffs = {k: abs(first[k] - first_one[k]) for k in ("reward_mean", "episode_done_frac")}
    rel = {k: abs(first[k] - first_one[k]) / max(abs(first_one[k]), 1e-12) for k in LOSSES}
    report = {"backend": heads[0]["distributed"]["backend"], "ranks": len(heads),
              "final_lines_identical": len(set(finals)) == 1,
              "checkpoint_env_steps": ck["env_steps"], "first_iteration_abs": diffs,
              "first_iteration_loss_rel": rel}
    # the last iteration's times (the first holds the kernel's build and warm-up)
    for name, last in (("dp", progress[-1]), ("one", one[-2])):
        report[f"{name}_last_rollout_s"], report[f"{name}_last_learn_s"] = (
            last["rollout_s"], last["learn_s"])
        report[f"{name}_last_env_steps_per_s"] = steps / args.iters / (last["rollout_s"]
                                                                       + last["learn_s"])
    print(json.dumps(report), flush=True)
    ok = (len(heads) == args.nproc and report["final_lines_identical"]
          and all(h == {"distributed": {"backend": report["backend"], "world": args.nproc}}
                  for h in heads) and ck["env_steps"] == steps
          and len(progress) == args.iters and all(v < 1e-3 for v in diffs.values())
          and all(v < 0.01 for v in rel.values()))
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
