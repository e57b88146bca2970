"""Benchmark of the port: humanoid mimic env throughput (counterpart of the
repo root's ``bench.py``).

    python -m pbrl_tpu_torch.cli bench --num-envs 4096
    python -m pbrl_tpu_torch.bench

Reads ``BENCH_NUM_ENVS`` (4096; ``--num-envs`` sets it), ``BENCH_ITERS``
(100), ``BENCH_SKIP_PARITY`` (``1`` skips the checks) and
``BENCH_SELF_MASS`` (the self-contact mass model, ``step`` by default), as
bench.py does. On the card it first holds the policy-step kernel against
the einsum engine (:func:`kernel_vs_engine_parity`: bench.py's absolute,
torque and airborne checks, with its bounds), then times ``BENCH_ITERS``
policy steps of the walk env (every step one kernel launch) with a fixed
zero action after a few warm-up steps, under CUDA events, and prints one
JSON line with bench.py's ``metric``, ``value`` (env-steps/s on this one
card), ``unit``, ``substeps_per_sec_per_chip``, ``flops_per_substep`` and
``achieved_gflops_per_chip``, plus the card and the kernel launches timed.
bench.py's ``vs_baseline`` (a fraction of a TPU rate) and its TPU runtime
waits are left out. On the CPU (``device="cpu"``: the kernel's plain
version) the checks are skipped, as bench.py skips them off the chip, and
the steps are timed by the host clock.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

WARMUP = 3


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def backends_agree(model, clip, cfg, action, lift=0.0, seed=7, num_envs=256):
    """The engine backend against the kernel backend from the same reset
    states (``num_envs`` envs from a generator seeded with ``seed``,
    lifted by ``lift`` m), 2 policy steps: max |dqpos|, the per-env qvel
    error distribution, max |dreward|, finiteness and the kernel's
    launches."""
    from pbrl_tpu_torch.envs import MimicVecEnv

    dev = clip.qpos.device
    kenv = MimicVecEnv(model, clip, cfg, backend="kernel", device=dev)
    xenv = MimicVecEnv(model, clip, cfg, backend="xla", device=dev)
    if hasattr(xenv, "_kstep"):
        raise AssertionError("the engine backend built a kernel")
    s = kenv.reset(num_envs, torch.Generator(device=dev).manual_seed(seed))
    if lift:
        s = s.replace(qpos=torch.cat([s.qpos[:, :2], s.qpos[:, 2:3] + lift, s.qpos[:, 3:]],
                                     1).contiguous())
    ks = xs = s
    kenv._kstep.launches = 0
    with torch.no_grad():
        for _ in range(2):
            ks = kenv.step(ks, action)
            xs = xenv.step(xs, action)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dv_env = (ks.qvel - xs.qvel).abs().amax(dim=1).cpu().numpy()
    return {"dq": float((ks.qpos - xs.qpos).abs().max()),
            "dv_med": float(np.median(dv_env)), "dv_p90": float(np.percentile(dv_env, 90)),
            "dv_max": float(dv_env.max()), "dr": float((ks.reward - xs.reward).abs().max()),
            "finite": bool(torch.isfinite(xs.qpos).all() and torch.isfinite(xs.qvel).all()),
            "kernel_launches": kenv._kstep.launches}


def kernel_vs_engine_parity(model, clip, num_envs=256) -> dict:
    """bench.py's parity checks: 2 policy steps from the same RSI-noised
    reset states (0.05 / 0.5) through the kernel and through the engine, in
    ``absolute`` mode (zero action) and ``torque`` mode (20 sin actions),
    bounded on qpos (5e-3), the per-env qvel error (median 1e-2, p90 0.15,
    max 1.0) and the reward (5e-2); then airborne (+1 m, no early
    termination), bounded on qpos (5e-4) and qvel (1.5e-2). Raises on a
    miss; returns each case's numbers."""
    from pbrl_tpu_torch.envs import EnvConfig

    dev = clip.qpos.device
    nu = model.nu
    noisy = dict(reference_state_init=True, rsi_noise_qpos=0.05, rsi_noise_qvel=0.5)
    zero = torch.zeros(num_envs, nu, device=dev)
    sin = (20.0 * torch.sin(torch.arange(num_envs * nu, device=dev, dtype=torch.float32))
           ).reshape(num_envs, nu)
    out = {}
    for name, cfg, act, seed in (("absolute", EnvConfig(**noisy), zero, 7),
                                 ("torque", EnvConfig(action_mode="torque", **noisy), sin, 7)):
        r = backends_agree(model, clip, cfg, act, seed=seed, num_envs=num_envs)
        log(f"kernel-vs-engine parity ({name}): |dq|={r['dq']:.2e} |dv| med={r['dv_med']:.2e} "
            f"p90={r['dv_p90']:.2e} max={r['dv_max']:.2e} |dreward|={r['dr']:.2e}")
        assert np.isfinite(r["dq"]) and r["dq"] < 5e-3, f"kernel qpos diverged: {r['dq']}"
        assert r["dv_med"] < 1e-2, f"kernel qvel median diverged: {r['dv_med']}"
        assert r["dv_p90"] < 0.15, f"kernel qvel p90 diverged: {r['dv_p90']}"
        assert np.isfinite(r["dv_max"]) and r["dv_max"] < 1.0, f"kernel qvel: {r['dv_max']}"
        assert np.isfinite(r["dr"]) and r["dr"] < 5e-2, f"kernel reward diverged: {r['dr']}"
        out[name] = r
    r = backends_agree(model, clip, EnvConfig(early_termination=False, **noisy), zero,
                       lift=1.0, seed=11, num_envs=num_envs)
    log(f"kernel-vs-engine parity (airborne): |dq|={r['dq']:.2e} |dv|={r['dv_max']:.2e}")
    assert np.isfinite(r["dq"]) and r["dq"] < 5e-4, f"airborne qpos diverged: {r['dq']}"
    assert np.isfinite(r["dv_max"]) and r["dv_max"] < 1.5e-2, \
        f"airborne qvel diverged: {r['dv_max']}"
    out["airborne"] = r
    return out


def main(num_envs=None, iters=None, skip_parity=None, device="cuda") -> dict:
    """Run the benchmark; prints and returns its JSON record."""
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model
    from pbrl_tpu_torch.ops.field_physics import count_policy_step_flops

    num_envs = int(os.environ.get("BENCH_NUM_ENVS", 4096)) if num_envs is None else num_envs
    iters = int(os.environ.get("BENCH_ITERS", 100)) if iters is None else iters
    if skip_parity is None:
        skip_parity = os.environ.get("BENCH_SKIP_PARITY", "") == "1"
    dev = torch.device(device)
    model = humanoid_model()
    clip = load_clip("walk", device=dev)
    if dev.type == "cuda" and not skip_parity:
        kernel_vs_engine_parity(model, clip)
    cfg = EnvConfig(self_contact_mass=os.environ.get("BENCH_SELF_MASS", "step"))
    env = MimicVecEnv(model, clip, cfg, device=dev)
    state = env.reset(num_envs, torch.Generator(device=dev).manual_seed(0))
    # a fixed action (PD target: the zero pose) keeps the bench deterministic;
    # the kernel's work does not depend on the action
    actions = torch.zeros(num_envs, env.action_size, device=dev)
    with torch.no_grad():
        for _ in range(WARMUP):
            state = env.step(state, actions)
        env._kstep.launches = 0
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                state = env.step(state, actions)
            end.record()
            torch.cuda.synchronize(dev)
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                state = env.step(state, actions)
            seconds = time.perf_counter() - t0
    if not torch.isfinite(state.qpos).all():
        raise AssertionError("the benched env states are not finite")
    n_sub = env.config.n_substeps
    per_sec = num_envs * iters / seconds
    flops_sub = count_policy_step_flops(env._kspec) / n_sub
    record = {
        "metric": "humanoid_mimic_env_steps_per_sec_per_chip_4096envs",
        "value": round(per_sec, 1),
        "unit": "env-steps/s/chip",
        "substeps_per_sec_per_chip": round(per_sec * n_sub, 1),
        "flops_per_substep": round(flops_sub, 1),
        "achieved_gflops_per_chip": round(per_sec * n_sub * flops_sub / 1e9, 1),
        "num_envs": num_envs, "iters": iters, "launches": env._kstep.launches,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the benchmark runs on the card "
                 "(python -m pbrl_tpu_torch.cli bench --device cpu runs it on the CPU)")
    main()
