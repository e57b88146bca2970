#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout with no ``build/``; needs one CUDA card
(Hopper, the kernel is built for sm_90a), ``nvcc`` and the repo's
``pbrl_tpu_torch`` package. Imports numpy, torch, the standard library and
``pbrl_tpu_torch`` only. Phases, each announced by one ``[smoke]`` line
with the seconds elapsed:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: nvcc of ``pbrl_tpu_torch/csrc/mimic_step.cu``, its ptxas report
   (registers, stack frame, spills), and its launch shape and occupancy
   (shared memory per block, blocks, warps and envs per SM);
3. kernel against its plain version on the card, from the same inputs
   (the checks of bench.py's kernel-vs-XLA parity on qpos and qvel, plus
   xpos/xquat to 1e-4 and the fall flag exact): 256 humanoid envs at
   numpy-seeded reference phases with RSI noise 0.05/0.5 over 2 policy
   steps in ``pd`` mode (zero action) and ``torque`` mode (20 sin actions),
   an airborne run (+1 m), the ``substep`` and ``static`` self-contact
   masses (one policy step, 256 envs), ragged batches of 4097 envs and of
   1 env (one policy step), and the sphere scene's free fall (5 envs,
   3 substeps); then the same checks on one policy step at the eval's
   shape (4096 envs, the policy's actions), and two launches on those
   inputs that must agree bit for bit (a race between lanes would not), as
   must 7 of those envs launched alone;
4. eval: the exported walk policy, deterministic evaluation at 4096 envs
   for 300 policy steps through the kernel, with the kernel launch count
   of that run (300), its results against the recorded JAX eval
   (``eval_reward`` >= 0.80, ``eval_episode_length`` >= 295; and the
   port's own earlier result, WALK_EVAL, unchanged), its wall
   time, the kernel's time per launch (CUDA events) at 1024, 4096 and
   16384 envs beside the plain version's, its bound at 4096 envs (the FLOPs
   these inputs need: a contact's Delassus mass only where it touches,
   from the plain program's contact activity), and a ``torch.profiler`` trace
   of 5 eval steps: the top 10 device operations, the device-busy share
   of the window and the kernel launches per env step; then the envs that
   ended before the last step in that eval (start time, step, and what
   ended them: a fall, the NaN quarantine, the clip's end or another
   termination), recorded during it;
5. train: PPO through ``ppo.train`` with the walk run's ``TrainConfig``
   (2048 envs x unroll 16, 1024-512 MLPs) from a seeded fresh init for
   TRAIN_ITERS iterations, with every metric finite in every iteration and
   TRAIN_ITERS x 16 kernel launches; env-steps/s with the learner
   included, the rollout/learn split. Then the kernel against its plain
   version (phase 3's bounds, 2 policy steps) on FALL_ENVS states of that
   policy's rollout taken as each env falls and on the rollout's final
   states at the training launches' shape (2048 envs), its time on both at
   2048 envs, their touching contacts and the bound those states need. Then a
   fine-tune: the walk run's exported learner state
   (``assets/walk_train_state.npz``) imported as a checkpoint and resumed
   for FINETUNE_ITERS iterations through ``cli train`` on its default
   device, whose run config must be the walk run's, whose checkpoints must
   continue at 15258 + FINETUNE_ITERS with Adam's count, and whose policy
   must pass phase 4's eval bounds at 4096 envs x 300 steps;
6. recipes: the six other shipped clips (getup_facedown, getup_faceup,
   kick, punch, jump, backflip), each its bundled policy at its
   eval-stripped run config, RECIPE_ENVS envs x RECIPE_STEPS steps with
   RECIPE_STEPS kernel launches, against the evals pbrl_tpu recorded
   (``eval_reward`` >= recorded - 0.05, ``eval_episode_length`` >= 0.9 x
   recorded), with its wall time and the envs that end early. On the
   getup_facedown, getup_faceup and backflip evals, the kernel against its
   plain version (phase 3's bounds, one policy step at the clip's own spec)
   on the 256 first envs' inputs at the step where the most self contacts
   touch, their touching contacts, the kernel's time on them at 4096 envs
   and their bound. Then a fine-tune: backflip's exported learner state
   (``assets/backflip_train_state.npz``) resumed for FINETUNE_ITERS
   iterations through ``cli train`` with backflip's whole EnvConfig and
   TrainConfig on the command line (curriculum, aerial window, drift, root
   offset, residual targets, no joint limits, torque scale 2.5), whose run
   config must be backflip's, whose checkpoints must continue at 201410 +
   FINETUNE_ITERS with Adam's count, whose metrics must be finite with
   FINETUNE_ITERS x 16 kernel launches, and whose policy must pass
   backflip's eval bound; the rollout's ms per step;
7. engine: the einsum engine in plain PyTorch (``backend="xla"``) against
   the kernel from the same reset states (256 envs, 2 policy steps, RSI
   noise 0.05/0.5) in ``absolute`` mode (zero action), ``torque`` mode (20
   sin actions) and with held-torque PD (``pd_per_substep=False``: one
   Stable-PD torque per env from the pre-step state, the kernel in
   ``torque`` mode), at pbrl_tpu's kernel-vs-engine bounds (qpos 5e-3;
   qvel per env median 1e-2, p90 0.15, max 1.0; reward 5e-2), and airborne
   (+1 m: qpos 5e-4, qvel 1.5e-2); a from-scratch ``cli train --clip walk
   --env-set pd_per_substep=false`` with walk's TrainConfig for
   HELD_ITERS iterations (finite metrics, HELD_ITERS x 16 kernel launches,
   ``pd_per_substep: false`` in the run config), the kernel against its
   plain version in ``torque`` mode on that policy's rollout states and its
   time there at 2048 and 4096 envs beside its bound; one ``cli train
   --backend xla`` iteration each with ``standard_pd`` and
   ``inverse_dynamics_pd`` (finite metrics, no kernel built or launched);
   the walk policy evaluated on the engine at 4096 envs x ENGINE_EVAL_STEPS
   from phase 4's start states beside the kernel over the same steps
   (rewards within 0.005), with its early endings, its ms per policy step
   (CUDA events) and its device launches per step (``torch.profiler``);
   ``cli replay --clip walk`` against the clip's reference states;
8. one JSON line describing the kernel, the card's ``nvidia-smi`` line, and
   last ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero without the last line.
"""

import contextlib
import json
import subprocess
import sys
import time

T0 = time.time()
H100_F32_FLOPS = 67e12  # H100 SXM, f32 without tensor cores
H100_BYTES = 3.35e12    # H100 SXM HBM3
EVAL_ENVS = 4096
EVAL_STEPS = 300
FK_TOL = 1e-4  # xpos/xquat, kernel against plain: float32 rounding
MIN_EVAL_REWARD = 0.80  # the walk policy on pbrl_tpu: 0.833 over 300/300 steps
MIN_EVAL_LENGTH = 295.0
JAX_EVAL = {"eval_reward": 0.833315908908844, "eval_episode_length": 300.0,
            "eval_pose_error": 0.028788337484002113}  # logs/eval_walk_r4head.json
THREAD_PER_ENV_EVAL_S = "10.30-13.34 s"  # the earlier one-thread-per-env kernel (PERF.md)
TIME_ENVS = (1024, 4096, 16384)
PROFILE_STEPS = 5
TRAIN_ITERS = 40     # from-scratch PPO iterations (each 2048 envs x 16 steps)
FALL_ENVS = 256      # training-rollout states taken as envs fall
FALL_STEPS = 240     # the most policy steps to wait for FALL_ENVS falls
FINETUNE_ITERS = 4   # iterations resumed from an exported learner state
WALK_EVAL = (0.83425, 299.70)  # the port's walk eval on the H100 so far (PERF.md)
RECIPE_ENVS = 4096
RECIPE_STEPS = 256   # pbrl_tpu's eval default
# pbrl_tpu's recorded evals (128 envs x 256 steps): eval_reward, eval_episode_length, log
RECIPES = {
    "getup_facedown": (0.8998450636863708, 104.765625, "logs/eval_getup_r4head.json"),
    "getup_faceup": (0.8922470808029175, 130.1953125, "logs/eval_getup_faceup_r4head.json"),
    "kick": (0.7362321019172668, 52.734375, "logs/eval_kick_r4tr.json"),
    "punch": (0.7847458124160767, 73.484375, "logs/eval_punch_r4tr.json"),
    "jump": (0.6566115617752075, 254.7109375, "logs/eval_jump_je.json"),
    "backflip": (0.4796271026134491, 240.2578125, "logs/eval_bf_ak.json"),
}
SELF_CONTACT_CLIPS = ("getup_facedown", "getup_faceup", "backflip")
SELF_STATES = 256    # eval inputs kept per step for the self-contact check
BACKFLIP_STEP = 201410
ENGINE_ENVS = 256        # engine-vs-kernel checks
HELD_ITERS = 4           # held-torque PD training iterations through cli train
HELD_TIME_ENVS = (2048, 4096)
ENGINE_EVAL_STEPS = 100  # the walk eval on the engine (the kernel's eval takes EVAL_STEPS)
ENGINE_REWARD_TOL = 0.005
ENGINE_TIME_STEPS = 3    # engine steps timed with CUDA events


def log(phase, msg=""):
    print(f"[smoke] {phase} t={time.time() - T0:.1f}s {msg}".rstrip(), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def reference_batch(clip, B, rng, noise_q=0.05, noise_v=0.5):
    """qpos/qvel at numpy-seeded reference phases plus numpy RSI noise."""
    import numpy as np
    import torch

    from pbrl_tpu_torch.mocap import reference_state

    t0 = torch.as_tensor(rng.uniform(0.0, float(clip.cycle_time), B), dtype=torch.float32,
                         device=clip.qpos.device)
    q, v = reference_state(clip, t0)
    nq = torch.as_tensor(rng.standard_normal((B, q.shape[1] - 7)), dtype=torch.float32,
                         device=q.device)
    nv = torch.as_tensor(rng.standard_normal(v.shape), dtype=torch.float32, device=q.device)
    q = torch.cat([q[:, :7], q[:, 7:] + noise_q * nq], 1).contiguous()
    v = (v + noise_v * nv).contiguous()
    return q, v


def errors(k, p):
    """Per-output max |kernel - plain| of one policy step's outputs
    (qpos, qvel, xpos, xquat, fall) and the per-env qvel error distribution."""
    import numpy as np

    dv_env = (k[1] - p[1]).abs().amax(dim=1).cpu().numpy()
    return {
        "dq": float((k[0] - p[0]).abs().max()),
        "dv_med": float(np.median(dv_env)), "dv_p90": float(np.percentile(dv_env, 90)),
        "dv_max": float(dv_env.max()),
        "dxpos": float((k[2] - p[2]).abs().max()),
        "dxquat": float((k[3] - p[3]).abs().max()),
        "dfall": float((k[4] - p[4]).abs().max()),
        "finite": all(bool(t.isfinite().all()) for t in k),
    }


def compare(kstep, plain, q, v, u, steps):
    """Chain ``steps`` policy steps through the kernel and the plain
    version from the same inputs: the errors of the last step's outputs,
    with ``dfall`` the largest fall-flag difference over all steps."""
    import torch

    k = p = (q, v)
    dfall = 0.0
    for _ in range(steps):
        k = kstep(k[0], k[1], u)
        p = plain(p[0], p[1], u)
        dfall = max(dfall, float((k[4] - p[4]).abs().max()))
    torch.cuda.synchronize()
    return {**errors(k, p), "dfall": dfall}


def check_errors(name, r, dq=5e-3, dv_max=1.0):
    """The kernel-vs-plain bounds: qpos ``dq``; qvel per env median 1e-2,
    p90 0.15, max ``dv_max``; FK to float32 rounding; fall flag exact."""
    check(r["finite"], f"{name}: kernel output not finite")
    check(r["dq"] < dq, f"{name}: kernel qpos diverged {r['dq']}")
    check(r["dv_med"] < 1e-2, f"{name}: kernel qvel median diverged {r['dv_med']}")
    check(r["dv_p90"] < 0.15, f"{name}: kernel qvel p90 diverged {r['dv_p90']}")
    check(r["dv_max"] < dv_max, f"{name}: kernel qvel max diverged {r['dv_max']}")
    check(r["dxpos"] < FK_TOL, f"{name}: kernel xpos diverged {r['dxpos']}")
    check(r["dxquat"] < FK_TOL, f"{name}: kernel xquat diverged {r['dxquat']}")
    check(r["dfall"] == 0.0, f"{name}: kernel fall flag differs")


def time_launch(kstep, q, v, u, n=20):
    """ms per launch of ``kstep`` on these inputs: CUDA events around ``n``
    launches after 3 warm-up launches."""
    import torch

    for _ in range(3):
        kstep(q, v, u)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        kstep(q, v, u)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def profile_eval(env, policy, stats, gen, steps=PROFILE_STEPS, warmup=3):
    """``torch.profiler`` over ``steps`` steps of the eval loop (the body
    of ``train.evaluate``) after ``warmup`` steps: the top 10 device
    operations by time, the device-busy share of the window (union of the
    device intervals over the span of all traced events) and the device
    kernels per env step. None when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbrl_tpu_torch.train import running_stats

    @torch.no_grad()
    def run(state, n):
        for _ in range(n):
            mean, _ = policy(running_stats.normalize(stats, state.obs))
            state = env.step(state, mean)
        return state

    state = run(env.reset(EVAL_ENVS, gen), warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(state, steps)
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev or sum(e.time_range.elapsed_us() for e in dev) <= 0:
        return None
    per_name = {}
    for e in dev:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    kernels = [e for e in dev if not e.name.lower().startswith(("memcpy", "memset"))]
    return {"window_ms": (t1 - t0) / 1e3, "busy_share": busy / (t1 - t0),
            "device_ms_per_step": sum(per_name.values()) / 1e3 / steps,
            "kernels_per_step": len(kernels) / steps,
            "copies_per_step": (len(dev) - len(kernels)) / steps,
            "top": [(name, us / 1e3 / steps) for name, us in top]}


def needed(sp, q, v, u):
    """What one policy step from these inputs needs: FLOP per env (a
    contact's Delassus mass only where it touches, from the plain program's
    contact activity) and the ground and self contacts touching per env and
    substep."""
    import torch

    from pbrl_tpu_torch.ops import field_physics as fp

    active = fp.contact_activity(sp, q, v, u)
    ground = torch.tensor([s.body1 < 0 for s in sp.slots], device=active.device)
    per_sub = active.shape[0] * q.shape[0]
    return {"flop_per_env": fp.count_policy_step_flops(sp, active) / q.shape[0],
            "ground": float((active & ground).sum()) / per_sub,
            "self": float((active & ~ground).sum()) / per_sub}


def bound(sp, flop_per_env, B):
    """The least time (ms) the card could take for one launch at B envs,
    and what bounds it: FLOPs over the f32 peak, or each input read and
    each output written once over the memory rate."""
    nbytes = 4 * B * (2 * (sp.nq + sp.nv) + sp.nu + 7 * sp.nbody + 1)
    t_ops, t_bytes = flop_per_env * B / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


@contextlib.contextmanager
def watch_endings(env, keep=0):
    """Within the block, record what each ``env.step`` ends: the start
    times, each step's done and fall flags and end time, and whether the
    physics' raw outputs were finite (the env's NaN quarantine turns a
    non-finite state into a fall); with ``keep``, also the physics' inputs
    (the kernel's, with the kernel backend) of the first ``keep`` envs at
    every step. A few small device operations per step; no copy to the
    host."""
    physics, step = env._physics, env.step
    rec = {"env": env, "t0": None, "done": [], "fall": [], "bad": [], "time": [], "inputs": []}

    def spy(q, v, u):
        if keep:
            rec["inputs"].append(tuple(x[:keep].clone() for x in (q, v, u)))
        out = physics(q, v, u)
        rec["bad"].append(~(out[0].isfinite().all(1) & out[1].isfinite().all(1)))
        return out

    def watched(state, action):
        if rec["t0"] is None:
            rec["t0"] = state.episode_start
        out = step(state, action)
        rec["done"].append(out.done > 0)
        rec["fall"].append(out.metrics["fall"] > 0)
        rec["time"].append(out.time)
        return out

    env._physics, env.step = spy, watched
    try:
        yield rec
    finally:
        del env._physics, env.step


ENDING_CAUSES = ("fall", "nonfinite", "clip_end", "other")


def endings(rec):
    """From ``watch_endings``' record: each env that ended before the last
    step, with its start time, its live steps (the step it ended at, as
    the eval counts them) and what ended it: ``nonfinite``, a ``fall``
    (where falls end episodes), the ``clip_end`` of a clip that does not
    loop, else ``other`` (the pose termination or the episode time limit)."""
    import torch

    env = rec["env"]
    done, fall, bad, time_ = (torch.stack(rec[k]).cpu()
                              for k in ("done", "fall", "bad", "time"))
    fall &= env.config.early_termination
    clip_end = ((time_ >= env.clip.cycle_time.cpu()) if not env.clip.loop
                else torch.zeros_like(done))
    first = torch.argmax(done.to(torch.int8), dim=0)
    t0s = rec["t0"].cpu()
    out = []
    for j in torch.nonzero(done.any(dim=0)).flatten().tolist():
        i = int(first[j])
        cause = ("nonfinite" if bool(bad[i, j]) else "fall" if bool(fall[i, j])
                 else "clip_end" if bool(clip_end[i, j]) else "other")
        t0 = float(t0s[j])
        out.append({"env": j, "t0": t0, "t0_hex": t0.hex(), "live_steps": i, "cause": cause})
    return out


def train_phase(dev, smi, model, clip):
    """Phase 5: from-scratch PPO, the kernel on training states, and a
    fine-tune of the walk run's exported learner state (module docstring).
    Returns the numbers the report line needs."""
    import dataclasses
    import os
    import shutil

    import numpy as np
    import torch

    from pbrl_tpu_torch import cli
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.ops import mimic_kernel
    from pbrl_tpu_torch.train import (checkpoint, evaluate, networks, optim, ppo,
                                      running_stats)
    from pbrl_tpu_torch.utils.configio import dict_to_config

    _, _, run = checkpoint.load_policy(checkpoint.bundled_policy("walk"), device=dev)
    walk_cfg = dict_to_config(ppo.TrainConfig, run["train_config"])
    env = MimicVecEnv(model, clip, dict_to_config(EnvConfig, run["env_config"]), device=dev)
    cfg = dataclasses.replace(walk_cfg, total_env_steps=TRAIN_ITERS * walk_cfg.steps_per_iteration)
    check(cfg.num_envs == 2048 and cfg.unroll_length == 16 and cfg.hidden == (1024, 512)
          and cfg.num_iterations == TRAIN_ITERS, f"not the walk run's config: {cfg}")
    log("train", f"from scratch: {TRAIN_ITERS} iterations of {cfg.num_envs} envs x "
        f"{cfg.unroll_length} steps, {cfg.update_epochs} epochs x {cfg.num_minibatches} "
        f"minibatches, hidden {cfg.hidden}, lr {cfg.learning_rate} decayed over "
        f"{cfg.total_updates} updates | {smi}")
    keys = ("reward_mean", "episode_done_frac", "loss_policy", "loss_value", "entropy",
            "kl_approx", "rollout_s", "learn_s")

    def progress(it, e):
        print(f"[smoke]   it {it:3d} " + " ".join(f"{k}={e[k]:.5g}" for k in keys), flush=True)

    ks = env._kstep
    torch.cuda.synchronize()
    ks.launches = 0
    t = time.perf_counter()
    ts, history = ppo.train(env, cfg, progress_fn=progress, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = ks.launches
    bad = [(i, k) for i, h in enumerate(history) for k, v in h.items() if not np.isfinite(v)]
    check(not bad, f"non-finite training metrics (iteration, key): {bad[:10]}")
    check(launches == TRAIN_ITERS * cfg.unroll_length,
          f"training kernel launches {launches} != {TRAIN_ITERS * cfg.unroll_length}")
    later = history[1:]
    roll = float(np.median([h["rollout_s"] for h in later]))
    learn = float(np.median([h["learn_s"] for h in later]))
    steady = cfg.steps_per_iteration * len(later) / sum(h["rollout_s"] + h["learn_s"]
                                                       for h in later)
    log("train", f"{train_s:.2f}s, kernel launches {launches}; env-steps/s with the learner: "
        f"{history[-1]['sps']:.1f} over the run, {steady:.1f} after the first iteration; per "
        f"iteration (median of iterations 2..{TRAIN_ITERS}): rollout {roll:.4f}s "
        f"({roll / cfg.unroll_length * 1e3:.3f} ms/step), learn {learn:.4f}s | {smi}")
    low = min(range(len(history)), key=lambda i: history[i]["reward_mean"])
    log("train", "reward_mean " + " -> ".join(
        f"{history[i]['reward_mean']:.4f} (it {i})" for i in (0, low, len(history) - 1))
        + f"; episode_done_frac {history[0]['episode_done_frac']:.4f} -> "
        f"{history[-1]['episode_done_frac']:.4f}")

    # the kernel on this policy's rollout states, taken as each env falls
    gen = torch.Generator(device=dev).manual_seed(2)
    state = ts.env_state
    taken = torch.zeros(cfg.num_envs, dtype=torch.bool, device=dev)
    falls = ([], [], [], [])  # qpos, qvel, time, obs
    with torch.no_grad():
        for i in range(FALL_STEPS):
            mean, log_std = ts.policy(running_stats.normalize(ts.obs_stats, state.obs))
            state = env.step(state, networks.sample_action(mean, log_std, gen))
            new = (state.metrics["fall"] > 0) & ~taken
            taken |= new
            for got, x in zip(falls, (state.qpos, state.qvel, state.time, state.obs)):
                got.append(x[new])
            if int(taken.sum()) >= FALL_ENVS:
                break
        q, v, tf, obs = (torch.cat(x)[:FALL_ENVS].contiguous() for x in falls)
        mean, _ = ts.policy(running_stats.normalize(ts.obs_stats, obs))
        u = env._target(q, tf, mean).contiguous()
    check(q.shape[0] == FALL_ENVS, f"only {q.shape[0]} envs fell in {FALL_STEPS} steps")
    sp = env._kspec
    plain = lambda a, b, c: mimic_kernel.mimic_step_plain(sp, a, b, c)
    r = compare(ks, plain, q, v, u, steps=2)
    log("check fallen", f"{q.shape[0]} training states taken as envs fell (within {i + 1} "
        f"steps): {fmt(r)}")
    check_errors("fallen", r)
    fall_need = needed(sp, q, v, u)
    st = ts.env_state
    with torch.no_grad():
        mean, _ = ts.policy(running_stats.normalize(ts.obs_stats, st.obs))
        u_run = env._target(st.qpos, st.time, mean).contiguous()
    r_run = compare(ks, plain, st.qpos, st.qvel, u_run, steps=2)
    log("check train-shape", f"{cfg.num_envs} envs, the rollout's final states (the training "
        f"launches' shape), 2 steps: {fmt(r_run)}")
    check_errors("train-shape", r_run)
    run_need = needed(sp, *(x[:FALL_ENVS] for x in (st.qpos, st.qvel, u_run)))
    kernel_ms = time_launch(ks, st.qpos, st.qvel, u_run)
    rep = -(-cfg.num_envs // FALL_ENVS)
    fq, fv, fu = (x.repeat(rep, 1)[:cfg.num_envs].contiguous() for x in (q, v, u))
    fall_ms = time_launch(ks, fq, fv, fu)
    bound_ms, bound_by = bound(sp, run_need["flop_per_env"], cfg.num_envs)
    fall_bound, fall_by = bound(sp, fall_need["flop_per_env"], cfg.num_envs)
    for name, need, ms, (b_ms, b_by) in (("rollout", run_need, kernel_ms, (bound_ms, bound_by)),
                                         ("fallen", fall_need, fall_ms, (fall_bound, fall_by))):
        log("train kernel", f"{name} states at B={cfg.num_envs}: {ms:.4f} ms/launch; over "
            f"{FALL_ENVS} of them, touching per env and substep {need['ground']:.3f} ground, "
            f"{need['self']:.3f} self "
            f"contacts; {need['flop_per_env']:.1f} FLOP/env/step -> bound {b_ms:.5f} ms "
            f"({b_by}; at B={EVAL_ENVS}: {bound(sp, need['flop_per_env'], EVAL_ENVS)[0]:.5f} "
            f"ms) | {smi}")

    # fine-tune from the walk run's learner state, through the command line
    ft_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_finetune")
    shutil.rmtree(ft_dir, ignore_errors=True)
    step0 = checkpoint.import_train_state(ft_dir, checkpoint.bundled_train_state("walk"),
                                          checkpoint.bundled_policy("walk"))
    count0 = checkpoint.restore(ft_dir)["opt"]["count"]
    ft_steps = FINETUNE_ITERS * walk_cfg.steps_per_iteration
    ft_cfg = dataclasses.replace(walk_cfg, total_env_steps=ft_steps)
    log("finetune", f"imported step {step0}, Adam count {count0} past this run's "
        f"{ft_cfg.total_updates} updates: lr {ft_cfg.learning_rate} -> "
        f"{optim.Adam(ft_cfg.learning_rate, 0.0, ft_cfg.total_updates).lr(count0):.3g} "
        f"(the 1% floor)")
    t = time.perf_counter()
    cli.main(["train", "--clip", "walk", "--checkpoint-dir", ft_dir,
              "--total-steps", str(ft_steps), "--lr", str(walk_cfg.learning_rate),
              "--train-set", f"entropy_cost={walk_cfg.entropy_cost}"])
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t
    ft_run = checkpoint.load_run_config(ft_dir)
    check(dict_to_config(ppo.TrainConfig, ft_run["train_config"]) == ft_cfg
          and dict_to_config(EnvConfig, ft_run["env_config"]) == env.config,
          f"the command line did not run the walk run's config: {ft_run}")
    last = checkpoint.latest_step(ft_dir)
    check(last == step0 + FINETUNE_ITERS, f"fine-tune checkpoint {last} != {step0} + "
          f"{FINETUNE_ITERS}")
    payload = checkpoint.restore(ft_dir)
    check(payload["opt"]["count"] == count0 + FINETUNE_ITERS * ft_cfg.update_epochs
          * ft_cfg.num_minibatches, "the fine-tune did not continue Adam's count")
    check(all(bool(v.isfinite().all()) for net in ("policy", "value")
              for v in payload[net].values()), "non-finite fine-tuned params")
    policy, stats = checkpoint.load_policy_from_dir(ft_dir, device=dev)
    eval_env = MimicVecEnv(model, clip, cli._env_config(ft_run), device=dev)
    t = time.perf_counter()
    metrics = {k: float(v) for k, v in evaluate(
        eval_env, policy, stats, num_envs=EVAL_ENVS, num_steps=EVAL_STEPS,
        generator=torch.Generator(device=dev).manual_seed(0)).items()}
    eval_s = time.perf_counter() - t
    log("finetune", f"{FINETUNE_ITERS} iterations in {ft_s:.2f}s, checkpoints "
        f"{checkpoint._steps(ft_dir)}; eval {EVAL_ENVS} x {EVAL_STEPS} in {eval_s:.2f}s: "
        + json.dumps(metrics))
    check(metrics["eval_reward"] >= MIN_EVAL_REWARD,
          f"fine-tuned eval_reward {metrics['eval_reward']} < {MIN_EVAL_REWARD}")
    check(metrics["eval_episode_length"] >= MIN_EVAL_LENGTH,
          f"fine-tuned eval_episode_length {metrics['eval_episode_length']} < {MIN_EVAL_LENGTH}")
    shutil.rmtree(ft_dir, ignore_errors=True)
    return {"launches": launches, "kernel_ms": kernel_ms, "bound_ms": bound_ms,
            "max_abs_err": max(r_run[k] for k in ("dq", "dv_max", "dxpos", "dxquat", "dfall"))}


@contextlib.contextmanager
def track_steps():
    """Within the block, every policy-step wrapper an env builds (also one
    built inside ``cli.main``) is appended to the yielded list."""
    from pbrl_tpu_torch.envs import vec

    build, built = vec.build_mimic_step, []

    def tracked(*a, **kw):
        out = build(*a, **kw)
        built.append(out[0])
        return out

    vec.build_mimic_step = tracked
    try:
        yield built
    finally:
        vec.build_mimic_step = build


def self_contact_states(sp, inputs):
    """From the kept kernel inputs of an eval: the step whose inputs have
    the most self contacts touching at the policy step's entry, those
    inputs, and the mean self contacts touching per env there."""
    import torch

    from pbrl_tpu_torch.ops import field_physics as fp

    q = torch.stack([x[0] for x in inputs])  # (steps, envs, nq)
    ground = torch.tensor([s.body1 < 0 for s in sp.slots], device=q.device)
    touch = fp.contacts_touching(sp, q.reshape(-1, q.shape[-1])).reshape(
        q.shape[0], q.shape[1], -1)
    per_step = (touch & ~ground).sum(dim=(1, 2)).to(torch.float32) / q.shape[1]
    i = int(torch.argmax(per_step))
    return i, inputs[i], float(per_step[i])


def recipes_phase(dev, smi, model):
    """Phase 6: the six other shipped clips' evals, the kernel on their
    self-contact states, and a fine-tune of backflip's learner state
    through the command line (module docstring). Returns the numbers the
    report line needs."""
    import dataclasses
    import os
    import shutil

    import numpy as np
    import torch

    from pbrl_tpu_torch import cli
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.ops import mimic_kernel
    from pbrl_tpu_torch.train import checkpoint, evaluate, ppo
    from pbrl_tpu_torch.utils.configio import dict_to_config

    def run_eval(clip, env, policy, stats, normalize, keep=0):
        ks = env._kstep
        torch.cuda.synchronize()
        ks.launches = 0
        t = time.perf_counter()
        with watch_endings(env, keep) as rec:
            metrics = evaluate(env, policy, stats, num_envs=RECIPE_ENVS, num_steps=RECIPE_STEPS,
                               generator=torch.Generator(device=dev).manual_seed(0),
                               normalize_obs=normalize)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        want_r, want_len, src = RECIPES[clip]
        ended = endings(rec)
        lost = sum(RECIPE_STEPS - e["live_steps"] for e in ended)
        log(f"recipe {clip}", f"{RECIPE_ENVS} envs x {RECIPE_STEPS} steps in {wall:.2f}s, kernel "
            f"launches {ks.launches}: " + json.dumps(metrics) + f"; recorded on a TPU ({src}, 128 "
            f"envs): {want_r:.5f} / {want_len:.3f}; {len(ended)} envs end before step "
            f"{RECIPE_STEPS}, by cause " + json.dumps({c: sum(e["cause"] == c for e in ended)
                                                      for c in ENDING_CAUSES}) + f" | {smi}")
        print("[smoke]   early, not at the clip's end: "
              + json.dumps([e for e in ended if e["cause"] != "clip_end"][:20]), flush=True)
        check(abs((RECIPE_STEPS - lost / RECIPE_ENVS) - metrics["eval_episode_length"]) < 1e-3,
              f"{clip}: the recorded endings do not give the eval's mean length")
        check(ks.launches == RECIPE_STEPS, f"{clip}: kernel launches {ks.launches} != "
              f"{RECIPE_STEPS}")
        check(all(np.isfinite(v) for v in metrics.values()), f"{clip}: non-finite eval {metrics}")
        check(metrics["eval_reward"] >= want_r - 0.05,
              f"{clip}: eval_reward {metrics['eval_reward']} < {want_r} - 0.05")
        check(metrics["eval_episode_length"] >= 0.9 * want_len,
              f"{clip}: eval_episode_length {metrics['eval_episode_length']} < 0.9 x {want_len}")
        return rec

    out = {"launches": {}, "self_ms": {}, "self_bound_ms": {}, "self_err": {}}
    for clip in RECIPES:
        policy, stats, run = checkpoint.load_policy(checkpoint.bundled_policy(clip), device=dev)
        check(run["clip"] == clip, f"the bundled {clip} policy was trained on {run['clip']}")
        env = MimicVecEnv(model, load_clip(clip, device=dev), cli._env_config(run), device=dev)
        keep = SELF_STATES if clip in SELF_CONTACT_CLIPS else 0
        normalize = run["train_config"].get("normalize_obs", True)
        rec = run_eval(clip, env, policy, stats, normalize, keep)
        out["launches"][clip] = env._kstep.launches
        if not keep:
            continue
        # the kernel on this eval's most self-contact-rich states
        ks, sp = env._kstep, env._kspec
        i, (q, v, u), n_self = self_contact_states(sp, rec["inputs"])
        del rec
        plain = lambda a, b, c, sp=sp: mimic_kernel.mimic_step_plain(sp, a, b, c)
        r = compare(ks, plain, q, v, u, steps=1)
        log(f"check {clip}", f"{q.shape[0]} eval states at step {i} ({n_self:.3f} self contacts "
            f"touching per env at its entry), spec: {len(sp.limits)} joint limits, torque "
            f"limit {sp.tau_hi[0]:.1f} Nm on the first actuator: {fmt(r)}")
        check_errors(clip, r)
        need = needed(sp, q, v, u)
        rep = -(-RECIPE_ENVS // q.shape[0])
        ms = time_launch(ks, *(x.repeat(rep, 1)[:RECIPE_ENVS].contiguous() for x in (q, v, u)))
        b_ms, b_by = bound(sp, need["flop_per_env"], RECIPE_ENVS)
        log(f"kernel {clip}", f"those states at B={RECIPE_ENVS}: {ms:.4f} ms/launch; touching per "
            f"env and substep {need['ground']:.3f} ground, {need['self']:.3f} self contacts; "
            f"{need['flop_per_env']:.1f} FLOP/env/step -> bound {b_ms:.5f} ms ({b_by}) | {smi}")
        out["self_ms"][clip], out["self_bound_ms"][clip] = ms, b_ms
        out["self_err"][clip] = max(r[k] for k in ("dq", "dv_max", "dxpos", "dxquat", "dfall"))

    # fine-tune backflip's learner state through the command line
    _, _, run = checkpoint.load_policy(checkpoint.bundled_policy("backflip"), device=dev)
    bf_cfg = dict_to_config(ppo.TrainConfig, run["train_config"])
    ft_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_backflip")
    shutil.rmtree(ft_dir, ignore_errors=True)
    step0 = checkpoint.import_train_state(ft_dir, checkpoint.bundled_train_state("backflip"),
                                          checkpoint.bundled_policy("backflip"))
    check(step0 == BACKFLIP_STEP, f"imported step {step0} != {BACKFLIP_STEP}")
    count0 = checkpoint.restore(ft_dir)["opt"]["count"]
    ft_steps = FINETUNE_ITERS * bf_cfg.steps_per_iteration
    argv = ["train", "--clip", "backflip", "--checkpoint-dir", ft_dir,
            "--total-steps", str(ft_steps),
            "--env-set", "action_mode=residual", "--env-set", "enforce_joint_limits=false",
            "--env-set", "torque_limit_scale=2.5", "--env-set", "include_ref_root_offset=true",
            "--env-set", "rsi_noise_root_xy=0.25", "--env-set", "pose_termination=1.57",
            "--env-set", "pose_termination_after_cycle=2.4",
            "--env-set", "aerial_window=0.27,0.5", "--env-set", "drift_w=0.35",
            "--env-set", "curriculum_reset_prob=0.15",
            "--env-set", "curriculum_phase_window=0.5,0.95",
            "--train-set", "learning_rate=5e-05", "--train-set", "gamma=0.98",
            "--train-set", "entropy_cost=0.0", "--train-set", "init_log_std=-1.5",
            "--train-set", "reset_log_std=true"]
    log("finetune backflip", f"imported step {step0}, Adam count {count0}, env_steps "
        f"{checkpoint.restore(ft_dir)['env_steps']}; python -m pbrl_tpu_torch.cli "
        + " ".join(argv))
    torch.cuda.synchronize()
    t = time.perf_counter()
    lines, built = run_cli(argv)
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t
    history = [ln for ln in lines if "iteration" in ln]
    ft_launches = sum(k.launches for k in built)
    ft_run = checkpoint.load_run_config(ft_dir)
    check(ft_run["clip"] == "backflip"
          and dict_to_config(EnvConfig, ft_run["env_config"])
          == dict_to_config(EnvConfig, run["env_config"])
          and dict_to_config(ppo.TrainConfig, ft_run["train_config"])
          == dataclasses.replace(bf_cfg, total_env_steps=ft_steps),
          f"the command line did not run backflip's config: {ft_run}")
    check(len(history) == FINETUNE_ITERS and all(
        np.isfinite(v) for h in history for v in h.values() if isinstance(v, (int, float))),
        f"non-finite or missing fine-tune metrics: {history}")
    check(ft_launches == FINETUNE_ITERS * bf_cfg.unroll_length,
          f"fine-tune kernel launches {ft_launches} != {FINETUNE_ITERS * bf_cfg.unroll_length}")
    last = checkpoint.latest_step(ft_dir)
    check(last == step0 + FINETUNE_ITERS, f"backflip checkpoint {last} != {step0} + "
          f"{FINETUNE_ITERS}")
    payload = checkpoint.restore(ft_dir)
    check(payload["opt"]["count"] == count0 + FINETUNE_ITERS * bf_cfg.update_epochs
          * bf_cfg.num_minibatches, "the backflip fine-tune did not continue Adam's count")
    check(all(bool(v.isfinite().all()) for net in ("policy", "value")
              for v in payload[net].values()), "non-finite fine-tuned backflip params")
    roll_ms = [h["rollout_s"] / bf_cfg.unroll_length * 1e3 for h in history]
    log("finetune backflip", f"{FINETUNE_ITERS} iterations in {ft_s:.2f}s, {ft_launches} kernel "
        f"launches, checkpoints {checkpoint._steps(ft_dir)}, Adam count {payload['opt']['count']}; "
        f"rollout ms per step at {bf_cfg.num_envs} envs: "
        + ", ".join(f"{x:.3f}" for x in roll_ms)
        + f"; learn s: " + ", ".join(f"{h['learn_s']:.4f}" for h in history) + f" | {smi}")
    policy, stats = checkpoint.load_policy_from_dir(ft_dir, device=dev)
    env = MimicVecEnv(model, load_clip("backflip", device=dev), cli._env_config(ft_run),
                      device=dev)
    run_eval("backflip", env, policy, stats, bf_cfg.normalize_obs)
    shutil.rmtree(ft_dir, ignore_errors=True)
    out["ft_launches"] = ft_launches
    return out


def run_cli(argv):
    """``cli.main(argv)`` with its standard output captured: the JSON lines
    it printed, and the policy-step wrappers the envs it built own."""
    import io

    from pbrl_tpu_torch import cli

    text = io.StringIO()
    with track_steps() as built, contextlib.redirect_stdout(text):
        cli.main(argv)
    lines = [json.loads(ln) for ln in text.getvalue().splitlines() if ln.startswith("{")]
    for ln in lines:
        print("[smoke]   " + json.dumps(ln), flush=True)
    return lines, built


def backends_agree(model, clip, cfg, action, lift=0.0, seed=7):
    """The engine backend against the kernel backend from the same reset
    states (ENGINE_ENVS envs), 2 policy steps: max |dqpos|, the per-env
    qvel error distribution, max |dreward|, and the kernel's launches."""
    import numpy as np
    import torch

    from pbrl_tpu_torch.envs import MimicVecEnv

    dev = clip.qpos.device
    kenv = MimicVecEnv(model, clip, cfg, backend="kernel", device=dev)
    xenv = MimicVecEnv(model, clip, cfg, backend="xla", device=dev)
    check(not hasattr(xenv, "_kstep"), "the engine backend built a kernel")
    s = kenv.reset(ENGINE_ENVS, torch.Generator(device=dev).manual_seed(seed))
    if lift:
        s = s.replace(qpos=torch.cat([s.qpos[:, :2], s.qpos[:, 2:3] + lift, s.qpos[:, 3:]],
                                     1).contiguous())
    ks = xs = s
    kenv._kstep.launches = 0
    with torch.no_grad():
        for _ in range(2):
            ks = kenv.step(ks, action)
            xs = xenv.step(xs, action)
    torch.cuda.synchronize()
    dv_env = (ks.qvel - xs.qvel).abs().amax(dim=1).cpu().numpy()
    return {"dq": float((ks.qpos - xs.qpos).abs().max()),
            "dv_med": float(np.median(dv_env)), "dv_p90": float(np.percentile(dv_env, 90)),
            "dv_max": float(dv_env.max()), "dr": float((ks.reward - xs.reward).abs().max()),
            "finite": bool(torch.isfinite(xs.qpos).all() and torch.isfinite(xs.qvel).all()),
            "kernel_launches": kenv._kstep.launches}


def engine_phase(dev, smi, model, clip, walk_metrics):
    """Phase 7: the engine backend, held-torque PD, the controllers, the
    walk eval on the engine and cli replay (module docstring). Returns the
    numbers the report line needs."""
    import dataclasses
    import os
    import shutil

    import numpy as np
    import torch

    from pbrl_tpu_torch.cli import _env_config
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import reference_state
    from pbrl_tpu_torch.ops import mimic_kernel
    from pbrl_tpu_torch.train import checkpoint, evaluate, ppo, running_stats
    from pbrl_tpu_torch.utils.configio import dict_to_config
    from pbrl_tpu_torch.viz import load_trajectory

    t_phase = time.time()
    # 1. the engine against the kernel, same reset states
    B = ENGINE_ENVS
    u_tq = (20.0 * torch.sin(torch.arange(B * model.nu, device=dev, dtype=torch.float32))
            ).reshape(B, model.nu)
    zero = torch.zeros(B, model.nu, device=dev)
    noisy = dict(reference_state_init=True, rsi_noise_qpos=0.05, rsi_noise_qvel=0.5)
    cases = (("absolute", EnvConfig(**noisy), zero, 0.0),
             ("torque", EnvConfig(action_mode="torque", **noisy), u_tq, 0.0),
             ("held-pd", EnvConfig(pd_per_substep=False, **noisy), zero, 0.0),
             ("airborne", EnvConfig(early_termination=False, **noisy), zero, 1.0),
             ("held-pd airborne", EnvConfig(early_termination=False, pd_per_substep=False,
                                            **noisy), zero, 1.0))
    agree = {}
    for name, cfg, act, lift in cases:
        r = backends_agree(model, clip, cfg, act, lift=lift)
        log(f"engine vs kernel {name}", fmt(r))
        check(r["finite"], f"{name}: engine output not finite")
        check(r["kernel_launches"] == 2, f"{name}: kernel launches {r['kernel_launches']} != 2")
        if lift:
            check(r["dq"] < 5e-4, f"{name}: engine qpos diverged {r['dq']}")
            check(r["dv_max"] < 1.5e-2, f"{name}: engine qvel diverged {r['dv_max']}")
        else:
            check(r["dq"] < 5e-3, f"{name}: engine qpos diverged {r['dq']}")
            check(r["dv_med"] < 1e-2, f"{name}: engine qvel median diverged {r['dv_med']}")
            check(r["dv_p90"] < 0.15, f"{name}: engine qvel p90 diverged {r['dv_p90']}")
            check(r["dv_max"] < 1.0, f"{name}: engine qvel max diverged {r['dv_max']}")
            check(r["dr"] < 5e-2, f"{name}: engine reward diverged {r['dr']}")
        agree[name] = r

    # 2. held-torque PD: training through the command line, the kernel in torque mode
    _, _, run = checkpoint.load_policy(checkpoint.bundled_policy("walk"), device=dev)
    walk_cfg = dict_to_config(ppo.TrainConfig, run["train_config"])
    held_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_held")
    shutil.rmtree(held_dir, ignore_errors=True)
    steps = HELD_ITERS * walk_cfg.steps_per_iteration
    argv = ["train", "--clip", "walk", "--checkpoint-dir", held_dir, "--total-steps",
            str(steps), "--lr", str(walk_cfg.learning_rate), "--train-set",
            f"entropy_cost={walk_cfg.entropy_cost}", "--env-set", "pd_per_substep=false"]
    log("held-pd train", "python -m pbrl_tpu_torch.cli " + " ".join(argv) + f" | {smi}")
    t = time.perf_counter()
    lines, built = run_cli(argv)
    torch.cuda.synchronize()
    held_s = time.perf_counter() - t
    history = [ln for ln in lines if "iteration" in ln]
    held_launches = sum(k.launches for k in built)
    held_run = checkpoint.load_run_config(held_dir)
    check(held_run["env_config"]["pd_per_substep"] is False,
          f"the run config does not carry pd_per_substep: false: {held_run['env_config']}")
    check(dict_to_config(ppo.TrainConfig, held_run["train_config"])
          == dataclasses.replace(walk_cfg, total_env_steps=steps),
          f"not the walk run's TrainConfig: {held_run['train_config']}")
    check(len(history) == HELD_ITERS and all(
        np.isfinite(v) for h in history for v in h.values() if isinstance(v, (int, float))),
        f"non-finite or missing held-pd metrics: {history}")
    check(held_launches == HELD_ITERS * walk_cfg.unroll_length,
          f"held-pd kernel launches {held_launches} != {HELD_ITERS * walk_cfg.unroll_length}")
    roll_ms = [h["rollout_s"] / walk_cfg.unroll_length * 1e3 for h in history]
    log("held-pd train", f"{HELD_ITERS} iterations in {held_s:.2f}s, {held_launches} kernel "
        "launches; rollout ms per step at 2048 envs: " + ", ".join(f"{x:.3f}" for x in roll_ms)
        + " | " + smi)

    policy, stats = checkpoint.load_policy_from_dir(held_dir, device=dev)
    henv = MimicVecEnv(model, clip, dict_to_config(EnvConfig, held_run["env_config"]),
                       device=dev)
    n_time = max(HELD_TIME_ENVS)
    with torch.no_grad():
        st = henv.reset(n_time, torch.Generator(device=dev).manual_seed(3))
        for _ in range(walk_cfg.unroll_length):  # rollout states of the trained policy
            mean, _ = policy(running_stats.normalize(stats, st.obs))
            st = henv.step(st, mean)
        mean, _ = policy(running_stats.normalize(stats, st.obs))
        tau = henv._held_tau(st.qpos, st.qvel, henv._target(st.qpos, st.time, mean))
    q, v, tau = (x.contiguous() for x in (st.qpos, st.qvel, tau))
    ks, sp = henv._kstep, henv._kspec
    check(sp.mode == "torque", f"the held-pd kernel spec is in mode {sp.mode}")
    plain = lambda a, b, c: mimic_kernel.mimic_step_plain(sp, a, b, c)
    r_held = compare(ks, plain, *(x[:B].contiguous() for x in (q, v, tau)), steps=1)
    log("check held-pd torque", f"{B} rollout states, the held torques, 1 step: {fmt(r_held)}")
    check_errors("held-pd torque", r_held)
    need = needed(sp, *(x[:B] for x in (q, v, tau)))
    torque_ms, torque_bound = {}, {}
    for n in HELD_TIME_ENVS:
        torque_ms[n] = time_launch(ks, q[:n].contiguous(), v[:n].contiguous(),
                                   tau[:n].contiguous())
        torque_bound[n], by = bound(sp, need["flop_per_env"], n)
        log("held-pd kernel", f"torque mode, rollout states, B={n}: {torque_ms[n]:.4f} "
            f"ms/launch; touching per env and substep {need['ground']:.3f} ground, "
            f"{need['self']:.3f} self contacts; {need['flop_per_env']:.1f} FLOP/env/step -> "
            f"bound {torque_bound[n]:.5f} ms ({by}) | {smi}")
    t = time.perf_counter()
    for _ in range(5):
        henv._held_tau(st.qpos, st.qvel, mean)
    torch.cuda.synchronize()
    log("held-pd tau", f"_held_tau at B={n_time}: {(time.perf_counter() - t) / 5 * 1e3:.2f} ms "
        f"(host clock) | {smi}")
    shutil.rmtree(held_dir, ignore_errors=True)

    # 3. the other controllers on the engine, through the command line
    for controller in ("standard_pd", "inverse_dynamics_pd"):
        argv = ["train", "--clip", "walk", "--backend", "xla", "--controller", controller,
                "--total-steps", str(walk_cfg.steps_per_iteration), "--lr",
                str(walk_cfg.learning_rate)]
        t = time.perf_counter()
        lines, built = run_cli(argv)
        torch.cuda.synchronize()
        hist = [ln for ln in lines if "iteration" in ln]
        check(len(hist) == 1 and all(np.isfinite(v) for v in hist[0].values()
                                     if isinstance(v, (int, float))),
              f"{controller}: non-finite or missing metrics {hist}")
        check(not built, f"{controller}: the engine backend built a kernel")
        log(f"engine train {controller}", f"1 iteration of {walk_cfg.num_envs} x "
            f"{walk_cfg.unroll_length} in {time.perf_counter() - t:.2f}s, 0 kernel launches, "
            f"rollout {hist[0]['rollout_s'] / walk_cfg.unroll_length * 1e3:.1f} ms/step | {smi}")

    # 4. the walk policy evaluated on the engine
    policy, stats, run = checkpoint.load_policy(checkpoint.bundled_policy("walk"), device=dev)

    xenv = MimicVecEnv(model, clip, _env_config(run), backend="xla", device=dev)
    t = time.perf_counter()
    with watch_endings(xenv) as rec:
        m_x = {k: float(v) for k, v in evaluate(
            xenv, policy, stats, num_envs=EVAL_ENVS, num_steps=ENGINE_EVAL_STEPS,
            generator=torch.Generator(device=dev).manual_seed(0)).items()}
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    if ENGINE_EVAL_STEPS == EVAL_STEPS:
        m_k = walk_metrics
    else:
        kenv = MimicVecEnv(model, clip, _env_config(run), device=dev)
        m_k = {k: float(v) for k, v in evaluate(
            kenv, policy, stats, num_envs=EVAL_ENVS, num_steps=ENGINE_EVAL_STEPS,
            generator=torch.Generator(device=dev).manual_seed(0)).items()}
    ended = endings(rec)
    log("engine eval", f"{EVAL_ENVS} envs x {ENGINE_EVAL_STEPS} steps in {eval_s:.2f}s "
        f"({eval_s / ENGINE_EVAL_STEPS * 1e3:.1f} ms/step, host clock): engine "
        + json.dumps(m_x) + "; kernel " + json.dumps(m_k) + f"; {len(ended)} envs end early, "
        "by cause " + json.dumps({c: sum(e["cause"] == c for e in ended) for c in ENDING_CAUSES})
        + f" | {smi}")
    print("[smoke]   early: " + json.dumps(ended[:20]), flush=True)
    check(all(np.isfinite(v) for v in m_x.values()), f"non-finite engine eval {m_x}")
    check(abs(m_x["eval_reward"] - m_k["eval_reward"]) < ENGINE_REWARD_TOL,
          f"engine eval_reward {m_x['eval_reward']} vs kernel {m_k['eval_reward']}")
    with torch.no_grad():
        st = xenv.reset(EVAL_ENVS, torch.Generator(device=dev).manual_seed(1))
        mean, _ = policy(running_stats.normalize(stats, st.obs))
        st = xenv.step(st, mean)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(ENGINE_TIME_STEPS):
            mean, _ = policy(running_stats.normalize(stats, st.obs))
            st = xenv.step(st, mean)
        e1.record()
        torch.cuda.synchronize()
    engine_ms = e0.elapsed_time(e1) / ENGINE_TIME_STEPS
    # one profiled step: 17k device launches take the profiler a while to collect
    prof = profile_eval(xenv, policy, stats, torch.Generator(device=dev).manual_seed(1),
                        steps=1, warmup=1)
    if prof is None:
        log("engine profile", f"{engine_ms:.2f} ms per policy step at {EVAL_ENVS} envs (CUDA "
            "events); torch.profiler recorded no device time")
    else:
        log("engine profile", f"{engine_ms:.2f} ms per policy step at {EVAL_ENVS} envs (CUDA "
            f"events); 1 step: window {prof['window_ms']:.3f} ms, device busy "
            f"{prof['busy_share']:.4f}, device {prof['device_ms_per_step']:.4f} ms/step, "
            f"{prof['kernels_per_step']:.1f} kernels and {prof['copies_per_step']:.1f} copies "
            f"per step | {smi}")
        for name, ms in prof["top"]:
            print(f"[smoke]   {ms:9.4f} ms/step  {name[:110]}", flush=True)

    # 5. cli replay on the card
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_replay.npz")
    lines, built = run_cli(["replay", "--clip", "walk", "--out", out])
    traj = load_trajectory(out)
    pdt = EnvConfig().policy_dt
    frames = int(float(clip.cycle_time) / pdt) + 1
    t_f = torch.zeros(1, device=dev)
    want = []
    for _ in range(frames):  # the env's own clock: policy_dt added per step in float32
        t_f = t_f + pdt
        want.append(reference_state(clip, t_f)[0][0])
    want = torch.stack(want).cpu().numpy()
    err = float(np.abs(traj["qpos"] - want).max()) if traj["qpos"].shape == want.shape else None
    log("replay", f"cli replay --clip walk: {traj['qpos'].shape[0]} frames (want {frames}), "
        f"max |qpos - reference| {err}")
    check(traj["qpos"].shape == (frames, model.nq) and err < 1e-6 and not built,
          "cli replay did not play the clip's reference")
    os.remove(out)
    phase_s = time.time() - t_phase
    log("engine phase", f"{phase_s:.1f}s")
    return {"held_launches": held_launches, "torque_ms": torque_ms, "torque_bound": torque_bound,
            "held_err": max(r_held[k] for k in ("dq", "dv_max", "dxpos", "dxquat", "dfall")),
            "engine_ms": engine_ms}


def fmt(d):
    return " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}" for k, v in d.items())


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this smoke test runs on a GPU", file=sys.stderr)
        return 1

    from pbrl_tpu_torch.cli import _env_config
    from pbrl_tpu_torch.envs import MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.mocap.skeleton import generate_kp_kd_gains
    from pbrl_tpu_torch.model import humanoid_model, sphere_model
    from pbrl_tpu_torch.ops import field_physics as fp
    from pbrl_tpu_torch.ops import mimic_kernel
    from pbrl_tpu_torch.train import checkpoint, evaluate, running_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", f"nvidia-smi: {smi} | torch: {kind} | count={torch.cuda.device_count()} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    _, rec = mimic_kernel.build_library()
    ptx = [ln.strip() for ln in rec["ptxas"].splitlines()
           if "registers" in ln or "spill" in ln or "stack frame" in ln][:5]
    log("build", f"nvcc {rec['seconds']:.1f}s -> {rec['path']}")
    for ln in ptx:
        print(f"[smoke]   ptxas: {ln}", flush=True)
    occ = mimic_kernel.occupancy()
    log("occupancy", " ".join(f"{k}={v}" for k, v in occ.items()))
    check(occ["blocks_per_sm"] >= 1, "the kernel's launch shape does not fit an SM")

    # 3. kernel against its plain version, same inputs
    model = humanoid_model()
    clip = load_clip("walk", device=dev)
    kp, kd = generate_kp_kd_gains()
    allowed = ("right_ankle", "left_ankle")
    B = 256
    jrange = torch.as_tensor(model.jnt_range[list(model.actuator_jntid())], device=dev)
    u_pd = torch.clamp(torch.zeros(B, model.nu, device=dev), jrange[:, 0], jrange[:, 1])
    u_tq = (20.0 * torch.sin(torch.arange(B * model.nu, device=dev, dtype=torch.float32))
            ).reshape(B, model.nu).contiguous()
    for mode, u, seed in (("pd", u_pd, 7), ("torque", u_tq, 8)):
        kstep, spec = mimic_kernel.build_mimic_step(
            model, kp=kp, kd=kd, n_substeps=8, mode=mode, fall_allowed_bodies=allowed,
            torque_scale=2.0)
        plain = lambda a, b, c, spec=spec: mimic_kernel.mimic_step_plain(spec, a, b, c)
        q, v = reference_batch(clip, B, np.random.default_rng(seed))
        r = compare(kstep, plain, q, v, u, steps=2)
        log(f"check {mode}", fmt(r))
        check_errors(mode, r)
    kstep, spec = mimic_kernel.build_mimic_step(
        model, kp=kp, kd=kd, n_substeps=8, mode="pd", fall_allowed_bodies=allowed,
        torque_scale=2.0)
    q, v = reference_batch(clip, B, np.random.default_rng(11))
    q[:, 2] += 1.0
    r = compare(kstep, lambda a, b, c: mimic_kernel.mimic_step_plain(spec, a, b, c),
                q, v, u_pd, steps=2)
    log("check airborne", fmt(r))
    check_errors("airborne", r, dq=5e-4, dv_max=1.5e-2)
    for smass, seed in (("substep", 12), ("static", 13)):
        m_s = model.replace(option=model.option.replace(self_contact_mass=smass))
        kstep, spec = mimic_kernel.build_mimic_step(
            m_s, kp=kp, kd=kd, n_substeps=8, mode="pd", fall_allowed_bodies=allowed,
            torque_scale=2.0)
        check(spec.self_contact_mass == smass, f"spec did not take {smass}")
        q, v = reference_batch(clip, B, np.random.default_rng(seed))
        r = compare(kstep, lambda a, b, c, spec=spec: mimic_kernel.mimic_step_plain(
            spec, a, b, c), q, v, u_pd, steps=1)
        log(f"check self-mass {smass}", fmt(r))
        check_errors(f"self-mass {smass}", r)
    kstep, spec = mimic_kernel.build_mimic_step(
        model, kp=kp, kd=kd, n_substeps=8, mode="pd", fall_allowed_bodies=allowed,
        torque_scale=2.0)
    for n_env, seed in ((EVAL_ENVS + 1, 14), (1, 15)):  # a ragged tail; a lone env
        q, v = reference_batch(clip, n_env, np.random.default_rng(seed))
        u = torch.clamp(torch.zeros(n_env, model.nu, device=dev), jrange[:, 0], jrange[:, 1])
        r = compare(kstep, lambda a, b, c: mimic_kernel.mimic_step_plain(spec, a, b, c),
                    q, v, u, steps=1)
        log(f"check B={n_env}", fmt(r))
        check_errors(f"B={n_env}", r)
    sm = sphere_model()
    sstep, sspec = mimic_kernel.build_mimic_step(sm, n_substeps=3)
    sq = torch.as_tensor(np.tile(sm.qpos0, (5, 1)), device=dev).contiguous()
    sv = torch.zeros(5, sm.nv, device=dev)
    k = sstep(sq, sv, torch.zeros(5, 1, device=dev))
    p = mimic_kernel.mimic_step_plain(sspec, sq, sv, torch.zeros(5, 1, device=dev))
    vz = k[1][:, 2].cpu().numpy()
    want = -9.81 * float(sm.option.timestep) * 3
    err_sphere = max(float((a - b).abs().max()) for a, b in zip(k, p))
    log("check sphere", f"vz={vz[0]:.7e} want={want:.7e} |kernel-plain|={err_sphere:.3e}")
    np.testing.assert_allclose(vz, want, rtol=1e-5)
    check(float(k[4].abs().max()) == 0.0 and err_sphere < 1e-5, "sphere: fall or plain mismatch")

    # 4. eval at the main path's shape
    policy, stats, run = checkpoint.load_policy(checkpoint.bundled_policy("walk"), device=dev)
    env = MimicVecEnv(model, clip, _env_config(run), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    st = env.reset(EVAL_ENVS, gen)
    with torch.no_grad():
        act, _ = policy(running_stats.normalize(stats, st.obs))
    u = env._target(st.qpos, st.time, act).contiguous()
    ks, sp = env._kstep, env._kspec
    out_k = ks(st.qpos, st.qvel, u)
    again = ks(st.qpos, st.qvel, u)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(out_k, again))
    log("determinism", f"two launches at B={EVAL_ENVS} bit-equal: {same}")
    check(same, "two launches on the same inputs differ: a race between lanes")
    part = ks(*(x[1000:1007].contiguous() for x in (st.qpos, st.qvel, u)))
    alone = all(torch.equal(a, b[1000:1007]) for a, b in zip(part, out_k))
    log("determinism", f"7 of those envs launched alone give the same bits: {alone}")
    check(alone, "an env's result depends on the batch it is launched in")
    with torch.no_grad():
        m_all, _ = policy(running_stats.normalize(stats, st.obs))
        m_part, _ = policy(running_stats.normalize(stats, st.obs[1000:1007]))
    log("determinism", "their policy means alone and in the batch differ by "
        f"{float((m_part - m_all[1000:1007]).abs().max()):.3e} (the GEMMs' rounding)")
    times = {}
    for n in TIME_ENVS:
        rep = -(-n // EVAL_ENVS)
        q_n, v_n, u_n = (x.repeat(rep, 1)[:n].contiguous() for x in (st.qpos, st.qvel, u))
        times[n] = time_launch(ks, q_n, v_n, u_n)
    kernel_ms = times[EVAL_ENVS]
    log("kernel time", " | ".join(f"B={n} {ms:.4f} ms/launch" for n, ms in times.items())
        + f" | {smi}")
    t = time.perf_counter()
    out_p = mimic_kernel.mimic_step_plain(sp, st.qpos, st.qvel, u)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    max_err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
    r = errors(out_k, out_p)
    log("main-shape", f"B={EVAL_ENVS} kernel {kernel_ms:.4f} ms/launch | plain {plain_ms:.1f} ms "
        f"| max|kernel-plain|={max_err:.3e} {fmt(r)} | {smi}")
    check_errors("main-shape", r)
    # the bound counts the Delassus masses only where these inputs' contacts touch
    need = needed(sp, st.qpos, st.qvel, u)
    straight = fp.count_policy_step_flops(sp)
    bound_ms, bound_by = bound(sp, need["flop_per_env"], EVAL_ENVS)
    log("bound", f"{need['flop_per_env']:.1f} FLOP/env/step for these inputs (straight-line "
        f"{straight}; touching per env and substep: {need['ground']:.3f} ground, "
        f"{need['self']:.3f} self contacts) -> {bound_ms:.5f} ms at B={EVAL_ENVS} "
        f"({bound_by}; straight-line {bound(sp, straight, EVAL_ENVS)[0]:.5f} ms)")

    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    ks.launches = 0
    t = time.perf_counter()
    with watch_endings(env) as rec:
        metrics = evaluate(env, policy, stats, num_envs=EVAL_ENVS, num_steps=EVAL_STEPS,
                           generator=gen)
    metrics = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    launches = ks.launches
    log("eval", f"{EVAL_ENVS} envs x {EVAL_STEPS} steps in {eval_s:.2f}s (the one-thread-per-"
        f"env kernel: {THREAD_PER_ENV_EVAL_S}), kernel launches {launches} | {smi}")
    log("eval", "port: " + json.dumps(metrics))
    log("eval", "jax (recorded on a TPU, other start phases): " + json.dumps(JAX_EVAL))
    check(launches == EVAL_STEPS, f"kernel launches {launches} != {EVAL_STEPS}")
    check(all(np.isfinite(v) for v in metrics.values()), f"non-finite eval {metrics}")
    check(metrics["eval_reward"] >= MIN_EVAL_REWARD,
          f"eval_reward {metrics['eval_reward']} < {MIN_EVAL_REWARD}")
    check(metrics["eval_episode_length"] >= MIN_EVAL_LENGTH,
          f"eval_episode_length {metrics['eval_episode_length']} < {MIN_EVAL_LENGTH}")
    check(abs(metrics["eval_reward"] - WALK_EVAL[0]) < 1e-5
          and abs(metrics["eval_episode_length"] - WALK_EVAL[1]) < 5e-3,
          f"the walk eval moved from {WALK_EVAL}: {metrics}")

    prof = profile_eval(env, policy, stats, torch.Generator(device=dev).manual_seed(1))
    if prof is None:
        log("profile", "torch.profiler recorded no device time on this machine")
    else:
        log("profile", f"{PROFILE_STEPS} eval steps at {EVAL_ENVS} envs: window "
            f"{prof['window_ms']:.3f} ms, device busy {prof['busy_share']:.4f}, device "
            f"{prof['device_ms_per_step']:.4f} ms/step, {prof['kernels_per_step']:.1f} "
            f"kernels and {prof['copies_per_step']:.1f} copies per step")
        for name, ms in prof["top"]:
            print(f"[smoke]   {ms:9.4f} ms/step  {name[:110]}", flush=True)
    ended = endings(rec)
    lost = sum(EVAL_STEPS - e["live_steps"] for e in ended)
    log("eval ends", f"{len(ended)} of {EVAL_ENVS} envs end before step {EVAL_STEPS}, "
        f"{lost} env-steps lost (mean length {EVAL_STEPS - lost / EVAL_ENVS:.4f}); by cause: "
        + json.dumps({c: sum(e["cause"] == c for e in ended) for c in ENDING_CAUSES}))
    print("[smoke]   early: " + json.dumps(ended), flush=True)
    check(abs((EVAL_STEPS - lost / EVAL_ENVS) - metrics["eval_episode_length"]) < 1e-3,
          "the recorded endings do not give the eval's mean length")

    # 5. train
    tr = train_phase(dev, smi, model, clip)

    # 6. the other shipped recipes
    rc = recipes_phase(dev, smi, model)

    # 7. the engine, held-torque PD, the controllers, replay
    en = engine_phase(dev, smi, model, clip, metrics)

    # 8. report
    print(json.dumps({"kernels": [{
        "name": "mimic_step", "route": "cuda",
        "source": "pbrl_tpu_torch/csrc/mimic_step.cu",
        "replaces": "pbrl_tpu/ops/mimic_kernel.py:144",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "train_launches": tr["launches"], "train_ms": tr["kernel_ms"],
        "train_bound_ms": tr["bound_ms"], "train_max_abs_err": tr["max_abs_err"],
        "recipe_launches": rc["launches"], "self_contact_ms": rc["self_ms"],
        "self_contact_bound_ms": rc["self_bound_ms"],
        "self_contact_max_abs_err": rc["self_err"], "backflip_finetune_launches":
        rc["ft_launches"], "held_launches": en["held_launches"],
        "torque_mode_ms": en["torque_ms"], "torque_mode_bound_ms": en["torque_bound"],
        "torque_mode_max_abs_err": en["held_err"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
