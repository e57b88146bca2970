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
   termination), recorded during it; and the kernel's time (CUDA events) at
   4096 envs on that eval's states at step MID_EVAL_STEP, kept during it,
   with their bound counted as for the start states;
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
8. APG (analytic policy gradients through the engine, ``train/apg.py``):
   the window's policy gradient (walk's run config and learner state,
   APG_GRAD_ENVS reset states, horizon APG_GRAD_HORIZON, the same noise) on
   the card with TF32 allowed process-wide against the CPU's, airborne
   (+1 m: relative difference <= 1e-4) and on the ground (cosine >= 0.99,
   relative difference <= 5e-2); the fine-tune users ran
   (``scripts/campaigns/campaign35.sh``'s probe: backflip's learner state
   through ``cli train-apg`` at 2048 envs x horizon 8, lr 1e-4, reset every
   iteration, action noise 0.1), cut to APG_ITERS iterations: finite loss
   and ``grad_norm``, the critic bit-equal to the source's, the policy
   moved, no kernel built or launched, backflip's env config in
   ``run_config.json``, ``apg_config.json``, the checkpoint at step
   APG_ITERS with ``env_steps`` continued, ``reward_mean`` within
   APG_REWARD_TOL of pbrl_tpu's logged value, ``grad_norm`` beside the
   log's, ms per iteration (forward, backward), env-steps/s and peak
   memory; ``cli eval --checkpoint-dir`` of its output through the kernel
   at RECIPE_ENVS x RECIPE_STEPS within backflip's bound; a
   ``torch.profiler`` trace of one iteration at that config with its
   window cut to APG_PROFILE_HORIZON step (device launches per window step
   in the forward, the backward and the update, and the device-busy
   share); ``cli replay`` of the DiffMimic clip against its reference;
9. the last modules: (a) data-parallel training, two processes of the
   command line (``pbrl_tpu_torch.cli.main``, what ``python -m
   pbrl_tpu_torch.cli`` runs) ``train --clip walk --distributed`` on the one
   card (gloo: the processes share it), walk's TrainConfig at 2048 envs in
   all (1024 per rank) x 16 steps for DP_ITERS iterations from seed 0,
   beside one process of the same command without ``--distributed``:
   both ranks' lines bit-identical, DP_ITERS x 16 kernel launches in each
   rank, finite metrics, the checkpoint written by rank 0 only with
   ``env_steps`` DP_ITERS x 32,768, the first iteration's ``reward_mean``
   and ``episode_done_frac`` within DP_TOL of the one process's and its
   loss terms within DP_LOSS_RTOL relative, and both runs' env-steps/s
   (not a scaling number: the ranks share one card); (b) the kernel's
   slide-joint path (``J_SLIDE``) against its plain version on
   tests/test_field_physics.py's slide scene, loaded by ``model.mjcf``:
   SLIDE_ENVS perturbed copies, ``torque`` mode, 2 policy steps, phase 3's
   bounds, the fall flag exact; (c) ``cli rollout --clip walk --steps
   300``: 300 kernel launches, 300 steps alive, mean reward >=
   MIN_EVAL_REWARD, a finite (300, 35) trajectory with its rewards and
   dones; (d) ``cli bench --num-envs 4096``: its kernel-against-engine
   parity asserts (``pbrl_tpu_torch/bench.py``) and its JSON line;
10. the training API and the per-env envs (within PHASE10_BUDGET_S): (a)
   ``make_train_functions`` on walk's ``MimicVecEnv`` (walk's run config,
   2048 envs x 16) for API_ITERS iterations from seed 0 beside
   ``ppo.init`` and ``ppo.train_step`` from seed 0: every metric and
   parameter bit-equal, API_ITERS x 16 kernel launches on each side, and
   the triple's ``evaluate`` equal to ``ppo.evaluate`` from the same
   policy and start states; (b) PPO through ``make_train_functions`` on
   the per-env ``MimicEnv`` (walk's EnvConfig, the engine on the card;
   PER_ENV_ENVS envs x 16, PER_ENV_ITERS iterations): finite metrics, no
   kernel launched, and on one rollout step (a quarter of the envs put
   down on the floor, so that they fall) every env that ended holds the
   fresh reset's qpos and time to the bit and the others the step's; (c) one APG iteration through
   ``make_apg_functions`` on ``MimicEnv`` (APG_PER_ENV_ENVS envs x horizon
   APG_PER_ENV_HORIZON, a quarter of them put down): finite loss and
   ``grad_norm``, the critic bit-frozen, the policy moved, no kernel
   launched, the ended envs restarted from a reset and the others carried
   on; (d) the tour, ``examples/quickstart_torch.py --train-steps
   QUICKSTART_STEPS`` on the card, as two processes (sections 1-3 and
   sections 4-5, so that section 3's engine substeps at one env do not
   hold the phase past its budget) started first and run beside (a)-(c):
   each exits 0 with its printed numbers finite, every section ran, and the
   kernel launches are counted (none in sections 1-3; 1 in section 4, 8
   per PPO iteration and 4 in the closing eval in section 5); then (b)'s
   ms per rollout step, timed alone;
11. the backflip investigation's tools, each through its ``main(argv)`` in
   this process with the launches of the wrappers it built counted (within
   PHASE11_BUDGET_S): (a) ``scripts/torch_backflip_ceiling.py --steps 256``
   on backflip's bundled policy: every envelope row's reward and terms
   within CEILING_TOL of CEILING_LOG, and part (c)'s rollout with 256
   launches and finite numbers, printed beside the log's (no bound: the log
   was taken on an earlier checkpoint of a chaotic clip); (b)
   ``scripts/torch_measure_lag.py`` on ``artifacts/backflip.npz`` with the
   clip on the card: LAG_LOG's best lag (-2.75 steps) and every SSE within
   LAG_TOL of the log's; then ``cli rollout --clip backflip --steps 240`` (240
   launches) and the lag of that rollout, reported; (c)
   ``scripts/torch_diag_rollout.py``: walk for 300 steps (300 launches,
   alive 300, ``mean_reward`` >= MIN_EVAL_REWARD) and backflip for 256 (256
   launches, finite, the same numbers as the ceiling's part (c)); (d)
   campaign 33's stiffness sweep, ``cli eval --clip backflip --env-set
   kp_scale=K --env-set kd_scale=D`` for each of SWEEP's pairs at
   RECIPE_ENVS x RECIPE_STEPS with RECIPE_STEPS launches, the kernel's kp
   and kd tables the defaults times K and D to GAIN_RTOL, each eval within
   SWEEP_REWARD_TOL of the reward pbrl_tpu logged and SWEEP_LENGTH_TOL of
   its episode length, both ways, and kp 2.0 below phase 6's unscaled
   backflip eval (pbrl_tpu's logs are read from the checkout at run time);
12. one JSON line describing the kernel, the card's ``nvidia-smi`` line, and
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
APG_GRAD_ENVS, APG_GRAD_HORIZON = 16, 2  # the card-vs-CPU gradient check
APG_ENVS, APG_HORIZON = 2048, 8  # scripts/campaigns/campaign35.sh:79-84's probe
APG_ITERS = 4            # its depth, cut from about 100 iterations
APG_PROFILE_HORIZON = 1  # the profiled iteration's window
# pbrl_tpu at that config after 5 iterations: reward_mean, grad_norm, log
APG_PROBE = (0.69366, 93.75713, "logs/apg_probe_h8n10.log")
APG_REWARD_TOL = 0.05
BACKFLIP_ENV_STEPS = 6_597_509_120  # backflip's learner state, unwrapped
DIFFMIMIC_CLIP = "walk_fps_30_20s.npy"
DP_RANKS = 2             # data-parallel ranks, sharing the one card
DP_ITERS = 4             # their iterations (each 2048 envs x 16 steps in all)
DP_TOL = 1e-3            # first iteration's reward_mean / episode_done_frac against 1 process
DP_LOSS_RTOL = 0.01      # its loss terms, relative
DP_TIMEOUT_S = 300
SLIDE_ENVS = 256
ROLLOUT_STEPS = 300
BENCH_ENVS = 4096
# tests/test_field_physics.py's slide scene: a slider on the floor with a swinging hinge arm
SLIDE_XML = """
<mujoco>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="carriage" pos="0 0 0.6">
      <joint name="lift" type="slide" axis="0 0 1" damping="0.5"/>
      <geom name="ball" type="sphere" size="0.12" mass="2"/>
      <body name="arm" pos="0.2 0 0">
        <joint name="swing" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom name="tip" type="sphere" size="0.06" pos="0.25 0 0" mass="0.5"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""
API_ITERS = 2            # phase 10a: the triple against ppo.init/train_step (2048 x 16 each)
API_EVAL_STEPS = 16
PER_ENV_ENVS, PER_ENV_ITERS = 256, 2          # phase 10b: PPO on MimicEnv (x 16)
APG_PER_ENV_ENVS, APG_PER_ENV_HORIZON = 64, 4  # phase 10c
QUICKSTART_STEPS = 32768  # phase 10d: 16 PPO iterations of 256 envs x 8
QUICKSTART_TIMEOUT_S = 300
TOUR_SECTIONS = ("1,2,3", "4,5")  # two processes side by side: phase 10's budget
PHASE10_BUDGET_S = 90
MID_EVAL_STEP = 150      # phase 4: the walk eval's states timed mid-eval
PHASE11_BUDGET_S = 120
# pbrl_tpu's logs under the checkout, read at run time: the ceiling's envelope
# rows and part (c) (scripts/backflip_ceiling.py), and the SSE at each lag from
# -3 to 6 steps in steps of 0.25 with the best lag (scripts/measure_lag.py on
# artifacts/backflip.npz)
CEILING_LOG = "logs/backflip_ceiling.json"
CEILING_TOL = 2e-4
TOOL_STEPS = 256         # the ceiling's reference times and rollout, backflip's diag
LAG_LOG = "logs/backflip_lag_r5.json"
LAG_TOL = 1e-4
LAG_ROLLOUT_STEPS = 240  # the artifact's length (scripts/render_all_skills.sh)
DIAG_WALK_STEPS = 300
# campaign 33's zero-training stiffness sweep (scripts/campaigns/campaign33.sh:83-91):
# kp_scale, kd_scale and the log of pbrl_tpu's eval at that pair (128 envs x 256)
SWEEP = ((1.25, 1.118, "logs/eval_bf_kp125.json"),
         (1.5, 1.225, "logs/eval_bf_kp15.json"),
         (2.0, 1.414, "logs/eval_bf_kp20.json"))
SWEEP_REWARD_TOL = 0.03  # |port - log|: about 3 standard errors of a 128-env mean
SWEEP_LENGTH_TOL = 0.1   # |port / log - 1| of the episode length
GAIN_RTOL = 1e-6         # the kernel's kp/kd tables against the scaled defaults
# phase 10d: the tour in a subprocess, then the launches of the kernel wrappers it built
QUICKSTART = """
import json, runpy, sys
from chip_smoke import track_steps
sys.argv = ["examples/quickstart_torch.py", *sys.argv[1:]]
rc = 0
with track_steps() as built:
    try:
        runpy.run_path("examples/quickstart_torch.py", run_name="__main__")
    except SystemExit as e:
        rc = e.code or 0
print(json.dumps({"kernel_launches": sum(k.launches for k in built)}), flush=True)
sys.exit(rc)
"""
# one rank of phase 9's data-parallel run: the command line in this process, then its launches
DP_RANK = """
import json, sys
from chip_smoke import track_steps
from pbrl_tpu_torch import cli
with track_steps() as built:
    rc = cli.main(sys.argv[1:])
print(json.dumps({"kernel_launches": sum(k.launches for k in built)}), flush=True)
sys.exit(rc)
"""


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
def watch_endings(env, keep=0, keep_at=None):
    """Within the block, record what each ``env.step`` ends: the start
    times, each step's done and fall flags and end time, and whether the
    physics' raw outputs were finite (the env's NaN quarantine turns a
    non-finite state into a fall); with ``keep``, also the physics' inputs
    (the kernel's, with the kernel backend) of the first ``keep`` envs at
    every step; with ``keep_at``, those of every env at that step (0-based)
    as ``kept_at``. A few small device operations per step; no copy to the
    host. The spy on the physics writes what it sees into buffers that each
    step reads after the call, so a replayed CUDA graph of the step, which
    holds the spy's device operations but does not call it, fills them too."""
    import torch

    physics, step = env._physics, env.step
    rec = {"env": env, "t0": None, "done": [], "fall": [], "bad": [], "time": [], "inputs": []}
    seen = {}  # the last physics call's inputs and raw-output finiteness

    def spy(q, v, u):
        out = physics(q, v, u)
        bad = ~(out[0].isfinite().all(1) & out[1].isfinite().all(1))
        for k, x in zip("qvub", (q, v, u, bad)):
            if k not in seen or seen[k].shape != x.shape:
                seen[k] = torch.empty_like(x)
            seen[k].copy_(x)
        return out

    def watched(state, action):
        if rec["t0"] is None:
            rec["t0"] = state.episode_start
        out = step(state, action)
        if keep:
            rec["inputs"].append(tuple(seen[k][:keep].clone() for k in "qvu"))
        if len(rec["bad"]) == keep_at:
            rec["kept_at"] = tuple(seen[k].clone() for k in "qvu")
        rec["bad"].append(seen["b"].clone())
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
    from pbrl_tpu_torch.envs import humanoid_task as task
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
        u = task.pd_target(env.clip, env.config, tf, mean, env.tables).contiguous()
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
        u_run = task.pd_target(env.clip, env.config, st.time, mean, env.tables).contiguous()
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
        return rec, metrics

    out = {"launches": {}, "self_ms": {}, "self_bound_ms": {}, "self_err": {}, "evals": {}}
    for clip in RECIPES:
        policy, stats, run = checkpoint.load_policy(checkpoint.bundled_policy(clip), device=dev)
        check(run["clip"] == clip, f"the bundled {clip} policy was trained on {run['clip']}")
        env = MimicVecEnv(model, load_clip(clip, device=dev), cli._env_config(run), device=dev)
        keep = SELF_STATES if clip in SELF_CONTACT_CLIPS else 0
        normalize = run["train_config"].get("normalize_obs", True)
        rec, out["evals"][clip] = run_eval(clip, env, policy, stats, normalize, keep)
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


def run_cli(argv, text=None):
    """``cli.main(argv)`` with its standard output captured: the JSON lines
    it printed, and the policy-step wrappers the envs it built own (the
    whole output goes to ``text`` when given)."""
    import io

    from pbrl_tpu_torch import cli

    text = io.StringIO() if text is None else text
    with track_steps() as built, contextlib.redirect_stdout(text):
        cli.main(argv)
    lines = [json.loads(ln) for ln in text.getvalue().splitlines() if ln.startswith("{")]
    for ln in lines:
        print("[smoke]   " + json.dumps(ln), flush=True)
    return lines, built


def engine_phase(dev, smi, model, clip, walk_metrics):
    """Phase 7: the engine backend, held-torque PD, the controllers, the
    walk eval on the engine and cli replay (module docstring). Returns the
    numbers the report line needs."""
    import dataclasses
    import os
    import shutil

    import numpy as np
    import torch

    from pbrl_tpu_torch.bench import backends_agree
    from pbrl_tpu_torch.cli import _env_config
    from pbrl_tpu_torch.engine.data import make_data
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.envs import humanoid_task as task
    from pbrl_tpu_torch.ops import mimic_kernel
    from pbrl_tpu_torch.train import checkpoint, evaluate, ppo, running_stats
    from pbrl_tpu_torch.utils.configio import dict_to_config

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
        r = backends_agree(model, clip, cfg, act, lift=lift, num_envs=ENGINE_ENVS)
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
        held_tau = lambda target: task.held_torque(  # noqa: E731
            henv.model, henv.config, make_data(henv.model, qpos=st.qpos, qvel=st.qvel),
            target, henv.tables)
        tau = held_tau(task.pd_target(henv.clip, henv.config, st.time, mean, henv.tables))
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
        held_tau(mean)
    torch.cuda.synchronize()
    log("held-pd tau", f"held_torque at B={n_time}: {(time.perf_counter() - t) / 5 * 1e3:.2f} ms "
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
    check_replay(model, clip, "walk")
    phase_s = time.time() - t_phase
    log("engine phase", f"{phase_s:.1f}s")
    return {"held_launches": held_launches, "torque_ms": torque_ms, "torque_bound": torque_bound,
            "held_err": max(r_held[k] for k in ("dq", "dv_max", "dxpos", "dxquat", "dfall")),
            "engine_ms": engine_ms}


def apg_grad(env, cfg, ts, state, noise):
    """The APG window's loss and the policy's gradient (one f64 vector on
    the host) from ``state`` with this ``noise``."""
    import torch

    from pbrl_tpu_torch.train import apg

    ts.env_state = state
    loss, _ = apg.loss_and_grad(env, cfg, ts, noise)
    g = torch.cat([p.grad.reshape(-1) for p in ts.policy.parameters() if p.grad is not None])
    return float(loss), g.double().cpu()


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")
APG_RANGES = ("apg/forward", "apg/backward", "apg/update")


def profile_apg(env, cfg, ts):
    """``torch.profiler`` over one ``apg.train_step``: the device kernels
    launched inside each of its ranges (``utils.profiling`` scopes
    ``apg/forward``, ``apg/backward``, ``apg/update``; a launch belongs to
    the range its host-side launch call starts in), the device kernels and
    device time of the iteration, and the device-busy share of its window.
    Read from the profiler's raw events, which are much faster to walk than
    ``prof.events()`` at this count. None when no device time is recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbrl_tpu_torch.train import apg

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        apg.train_step(env, cfg, ts)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t
    ranges, launches, dev = {}, [], []
    t_lo, t_hi = None, None
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        t_lo = a if t_lo is None else min(t_lo, a)
        t_hi = b if t_hi is None else max(t_hi, b)
        if e.device_type() == DeviceType.CUDA:
            if not name.lower().startswith(("memcpy", "memset")) and e.duration_ns() >= 0:
                dev.append((a, b))
        elif name in APG_RANGES:
            ranges[name] = (a, b)
        elif name in LAUNCH_CALLS:
            launches.append(a)
    if not dev:
        return None
    per_range = {k: sum(lo <= x < hi for x in launches) for k, (lo, hi) in ranges.items()}
    spans = sorted(dev)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    return {"launches": per_range, "host_launch_calls": len(launches), "kernels": len(dev),
            "device_ms": sum(b - a for a, b in dev) / 1e6, "window_ms": (t_hi - t_lo) / 1e6,
            "busy_share": busy / (t_hi - t_lo), "traced_s": traced_s}


def apg_phase(dev, smi, model):
    """Phase 8: APG (module docstring). Returns the numbers the report line
    needs."""
    import dataclasses
    import os
    import shutil

    import numpy as np
    import torch

    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv, map_states
    from pbrl_tpu_torch.envs import humanoid_task as task
    from pbrl_tpu_torch.mocap import load_clip, reference_state
    from pbrl_tpu_torch.train import apg, checkpoint
    from pbrl_tpu_torch.utils.configio import dict_to_config, load_json_config

    t_phase = time.time()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

    # 1. the window's policy gradient on the card against the CPU's
    walk_dir = os.path.join(build, "smoke_apg_walk")
    shutil.rmtree(walk_dir, ignore_errors=True)
    checkpoint.import_train_state(walk_dir, checkpoint.bundled_train_state("walk"),
                                  checkpoint.bundled_policy("walk"))
    run = checkpoint.load_run_config(walk_dir)
    payload = checkpoint.restore(walk_dir)
    env_cfg = dict_to_config(EnvConfig, run["env_config"])
    cfg = apg.APGConfig(num_envs=APG_GRAD_ENVS, horizon=APG_GRAD_HORIZON, action_noise=0.1,
                        hidden=tuple(run["train_config"]["hidden"]))
    sides = {}
    for d in ("cpu", dev):
        env = MimicVecEnv(model, load_clip("walk", device=d), env_cfg, backend="xla", device=d)
        ts = apg.init(env, cfg, d)
        checkpoint.restore_params_into(ts, payload)
        sides[str(d)] = (env, ts)
    cpu_env = sides["cpu"][0]
    s = cpu_env.reset(APG_GRAD_ENVS, torch.Generator().manual_seed(5))
    q_air = torch.cat([s.qpos[:, :2], s.qpos[:, 2:3] + 1.0, s.qpos[:, 3:]], 1)
    airborne = s.replace(qpos=q_air, obs=task.observation(
        cpu_env.model, cpu_env.clip, cpu_env.config, q_air, s.qvel, s.time,
        reference_state(cpu_env.clip, s.time)[0]))
    noise = torch.randn((APG_GRAD_HORIZON, APG_GRAD_ENVS, model.nu),
                        generator=torch.Generator().manual_seed(6))
    grad_check = {}
    for name, state in (("airborne", airborne), ("ground", s)):
        t = time.perf_counter()
        l_cpu, g_cpu = apg_grad(sides["cpu"][0], cfg, sides["cpu"][1], state, noise)
        cpu_s = time.perf_counter() - t
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")  # TF32 allowed process-wide
        try:
            t = time.perf_counter()
            env, ts = sides[str(dev)]
            on_card = map_states(lambda x: x.to(dev), state)
            l_gpu, g_gpu = apg_grad(env, cfg, ts, on_card, noise.to(dev))
            torch.cuda.synchronize()
            gpu_s = time.perf_counter() - t
        finally:
            torch.set_float32_matmul_precision(prev)
        rel = float((g_gpu - g_cpu).norm() / g_cpu.norm())
        cos = float(torch.dot(g_gpu, g_cpu) / (g_gpu.norm() * g_cpu.norm()))
        grad_check[name] = {"rel": rel, "cos": cos}
        log(f"apg grad {name}", f"{APG_GRAD_ENVS} envs x horizon {APG_GRAD_HORIZON}, walk's run "
            f"config and learner state, TF32 allowed process-wide: loss card {l_gpu:.7g} cpu "
            f"{l_cpu:.7g}; |grad| card {float(g_gpu.norm()):.6g} cpu {float(g_cpu.norm()):.6g}; "
            f"relative difference {rel:.3e}, cosine {cos:.7f} (card {gpu_s:.2f}s, cpu "
            f"{cpu_s:.2f}s)")
        check(bool(torch.isfinite(g_gpu).all() and torch.isfinite(g_cpu).all()),
              f"apg grad {name}: not finite")
        if name == "airborne":
            check(rel <= 1e-4, f"apg grad airborne: card vs cpu {rel} > 1e-4")
        else:
            check(cos >= 0.99 and rel <= 5e-2, f"apg grad ground: card vs cpu cos {cos}, rel {rel}")
    del sides
    shutil.rmtree(walk_dir, ignore_errors=True)

    # 2. the fine-tune users ran: backflip's learner state through cli train-apg
    src, dst = os.path.join(build, "smoke_apg_src"), os.path.join(build, "smoke_apg")
    for d in (src, dst):
        shutil.rmtree(d, ignore_errors=True)
    step0 = checkpoint.import_train_state(src, checkpoint.bundled_train_state("backflip"),
                                          checkpoint.bundled_policy("backflip"))
    source = checkpoint.restore(src)
    bf_run = checkpoint.load_run_config(src)
    per_iter = APG_ENVS * APG_HORIZON
    argv = ["train-apg", "--from-checkpoint", src, "--checkpoint-dir", dst,
            "--num-envs", str(APG_ENVS), "--horizon", str(APG_HORIZON), "--lr", "1e-4",
            "--total-steps", str(APG_ITERS * per_iter), "--steps-per-call", "1",
            "--apg-set", "reset_every=1", "--apg-set", "action_noise=0.1"]
    log("apg finetune", f"imported backflip step {step0}, env_steps {source['env_steps']}; "
        "python -m pbrl_tpu_torch.cli " + " ".join(argv) + f" | {smi}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    lines, built = run_cli(argv)
    torch.cuda.synchronize()
    apg_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    history = [ln for ln in lines if "iteration" in ln]
    apg_launches = sum(k.launches for k in built)
    check(len(history) == APG_ITERS and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history),
        f"non-finite or missing APG loss or grad_norm: {history}")
    check(not built and apg_launches == 0, f"APG built {len(built)} kernels, launched "
          f"{apg_launches} times: it must run on the engine")
    payload = checkpoint.restore(dst)
    check(all(torch.equal(payload["value"][k], v) for k, v in source["value"].items()),
          "the critic moved during APG")
    check(any(not torch.equal(payload["policy"][k], v) for k, v in source["policy"].items()),
          "APG did not move the policy")
    ft_run = checkpoint.load_run_config(dst)
    check(ft_run["clip"] == "backflip" and dict_to_config(EnvConfig, ft_run["env_config"])
          == dict_to_config(EnvConfig, bf_run["env_config"]),
          f"the APG run did not inherit backflip's env config: {ft_run}")
    want_cfg = apg.APGConfig(num_envs=APG_ENVS, horizon=APG_HORIZON, learning_rate=1e-4,
                             total_env_steps=APG_ITERS * per_iter, reset_every=1,
                             action_noise=0.1, hidden=tuple(bf_run["train_config"]["hidden"]),
                             init_log_std=bf_run["train_config"]["init_log_std"])
    got_cfg = load_json_config(os.path.join(dst, "apg_config.json"), apg.APGConfig)
    check(got_cfg == want_cfg, f"apg_config.json {got_cfg} != {want_cfg}")
    last = checkpoint.latest_step(dst)
    check(last == APG_ITERS, f"APG checkpoint {last} != {APG_ITERS}")
    check(payload["env_steps"] == BACKFLIP_ENV_STEPS + APG_ITERS * per_iter,
          f"APG env_steps {payload['env_steps']} != {BACKFLIP_ENV_STEPS} + {APG_ITERS * per_iter}")
    want_r, want_g, src_log = APG_PROBE
    got_r = history[-1]["reward_mean"]
    fwd = [h["forward_s"] for h in history]
    bwd = [h["backward_s"] for h in history]
    log("apg finetune", f"{APG_ITERS} iterations in {apg_s:.2f}s, 0 kernel launches, "
        f"checkpoints {checkpoint._steps(dst)}, env_steps {payload['env_steps']}; reward_mean "
        + " -> ".join(f"{h['reward_mean']:.5f}" for h in history) + f" (pbrl_tpu's log "
        f"{src_log} after 5 iterations: {want_r}); grad_norm "
        + ", ".join(f"{h['grad_norm']:.4g}" for h in history) + f" (log: {want_g}); per "
        "iteration forward " + ", ".join(f"{x * 1e3:.0f}" for x in fwd) + " ms, backward "
        + ", ".join(f"{x * 1e3:.0f}" for x in bwd) + f" ms; env-steps/s {history[-1]['sps']:.1f}; "
        f"peak memory {peak / 2**30:.2f} GiB | {smi}")
    check(abs(got_r - want_r) <= APG_REWARD_TOL,
          f"APG reward_mean {got_r} not within {APG_REWARD_TOL} of pbrl_tpu's {want_r}")

    # 3. its checkpoint's eval through the kernel, with backflip's bound
    lines, built = run_cli(["eval", "--checkpoint-dir", dst, "--num-envs", str(RECIPE_ENVS),
                            "--steps", str(RECIPE_STEPS)])
    m = lines[-1]
    eval_launches = sum(k.launches for k in built)
    bf_r, bf_len, _ = RECIPES["backflip"]
    log("apg eval", f"{RECIPE_ENVS} x {RECIPE_STEPS} through the kernel ({eval_launches} "
        "launches): " + json.dumps(m) + f"; bound {bf_r - 0.05:.5f} / {0.9 * bf_len:.2f}")
    check(eval_launches == RECIPE_STEPS, f"APG eval launches {eval_launches} != {RECIPE_STEPS}")
    check(m["eval_reward"] >= bf_r - 0.05 and m["eval_episode_length"] >= 0.9 * bf_len,
          f"APG checkpoint's eval {m} below backflip's bound")

    # 4. a profile of one APG iteration at that config (depth cut to APG_PROFILE_HORIZON)
    env = MimicVecEnv(model, load_clip("backflip", device=dev),
                      dict_to_config(EnvConfig, bf_run["env_config"]), backend="xla", device=dev)
    pcfg = dataclasses.replace(want_cfg, horizon=APG_PROFILE_HORIZON)
    ts = apg.init(env, pcfg, dev)
    checkpoint.restore_params_into(ts, payload)
    apg.train_step(env, pcfg, ts)  # warm-up
    prof = profile_apg(env, pcfg, ts)
    if prof is None:
        log("apg profile", "torch.profiler recorded no device time")
    else:
        per = {k: v / APG_PROFILE_HORIZON for k, v in prof["launches"].items()}
        log("apg profile", f"one iteration at {APG_ENVS} envs x horizon {APG_PROFILE_HORIZON}: "
            f"device launches per window step forward {per.get('apg/forward', 0):.0f}, backward "
            f"(recompute included) {per.get('apg/backward', 0):.0f}, update "
            f"{per.get('apg/update', 0):.0f}; {prof['kernels']} device kernels, "
            f"{prof['host_launch_calls']} host launch calls; window {prof['window_ms']:.1f} ms, "
            f"device {prof['device_ms']:.1f} ms, busy {prof['busy_share']:.4f} (traced "
            f"{prof['traced_s']:.1f}s) | {smi}")
    del ts, env
    for d in (src, dst):
        shutil.rmtree(d, ignore_errors=True)

    # 5. a DiffMimic clip played back on the card
    check_replay(model, load_clip(DIFFMIMIC_CLIP, device=dev), DIFFMIMIC_CLIP)
    phase_s = time.time() - t_phase
    log("apg phase", f"{phase_s:.1f}s")
    return {"apg_launches": apg_launches, "apg_eval_launches": eval_launches,
            "grad": grad_check, "peak_gib": peak / 2**30}


def check_replay(model, clip, name):
    """``cli replay --clip name`` on the card against the clip's reference
    states at the env's own clock (policy_dt added per step in float32)."""
    import os

    import numpy as np
    import torch

    from pbrl_tpu_torch.envs import EnvConfig
    from pbrl_tpu_torch.mocap import reference_state
    from pbrl_tpu_torch.viz import load_trajectory

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_replay.npz")
    lines, built = run_cli(["replay", "--clip", name, "--out", out])
    traj = load_trajectory(out)
    pdt = EnvConfig().policy_dt
    frames = int(float(clip.cycle_time) / pdt) + 1
    t_f = torch.zeros(1, device=clip.qpos.device)
    want = []
    for _ in range(frames):
        t_f = t_f + pdt
        want.append(reference_state(clip, t_f)[0][0])
    want = torch.stack(want).cpu().numpy()
    err = float(np.abs(traj["qpos"] - want).max()) if traj["qpos"].shape == want.shape else None
    log("replay", f"cli replay --clip {name}: {traj['qpos'].shape[0]} frames (want {frames}), "
        f"max |qpos - reference| {err}")
    check(traj["qpos"].shape == (frames, model.nq) and err < 1e-6 and not built,
          f"cli replay --clip {name} did not play the clip's reference")
    os.remove(out)


def dp_train(dev, smi, walk_cfg):
    """Phase 9a: DP_RANKS processes of ``cli train --distributed`` on the
    one card beside one process of the same command (module docstring)."""
    import os
    import shutil
    import socket

    import numpy as np

    from pbrl_tpu_torch.train import checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    steps = DP_ITERS * walk_cfg.steps_per_iteration
    base = ["train", "--clip", "walk", "--num-envs", str(walk_cfg.num_envs), "--unroll-length",
            str(walk_cfg.unroll_length), "--total-steps", str(steps), "--lr",
            str(walk_cfg.learning_rate), "--train-set", f"entropy_cost={walk_cfg.entropy_cost}",
            "--seed", "0"]
    dirs = [os.path.join(root, "build", f"smoke_dp{r}") for r in range(DP_RANKS)]
    one_dir = os.path.join(root, "build", "smoke_dp_one")
    for d in (*dirs, one_dir):
        shutil.rmtree(d, ignore_errors=True)
    # one process of the whole batch, in this process
    log("dp train", f"one process: python -m pbrl_tpu_torch.cli {' '.join(base)} | {smi}")
    one, built = run_cli([*base, "--checkpoint-dir", one_dir])
    one_launches = sum(k.launches for k in built)
    # DP_RANKS processes on the one card
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    argvs = [[*base, "--distributed", "--coordinator", f"localhost:{port}", "--num-processes",
              str(DP_RANKS), "--process-id", str(r), "--checkpoint-dir", dirs[r]]
             for r in range(DP_RANKS)]
    log("dp train", f"{DP_RANKS} ranks: python -m pbrl_tpu_torch.cli {' '.join(argvs[0])} "
        "(process ids 0..1)")
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", DP_RANK, *a], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    dp_s = time.perf_counter() - t
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"rank {r} failed ({p.returncode}):\n{err[-3000:]}")
    texts = [out.splitlines() for out, _ in outs]
    ranks = [[json.loads(ln) for ln in lines if ln.startswith("{")] for lines in texts]
    for ln in ranks[0]:
        print("[smoke]   rank 0: " + json.dumps(ln), flush=True)
    print("[smoke]   rank 1: " + json.dumps(ranks[1][0]), flush=True)
    launches = [r[-1]["kernel_launches"] for r in ranks]
    finals = [lines[-2] for lines in texts]  # the line before each rank's launch count
    check(finals[0] == finals[1], "the ranks' final lines differ")
    check(ranks[0][0] == ranks[1][0] == {"distributed": {"backend": "gloo", "world": DP_RANKS}},
          f"not a gloo run of {DP_RANKS} ranks: {ranks[0][0]} {ranks[1][0]}")
    check(len(ranks[1]) == 3, "rank 1 printed progress")
    progress = [ln for ln in ranks[0] if "iteration" in ln]
    final = ranks[0][-2]["final"]
    want_launches = DP_ITERS * walk_cfg.unroll_length
    check(launches == [want_launches] * DP_RANKS and one_launches == want_launches,
          f"kernel launches per rank {launches}, one process {one_launches} != {want_launches}")
    check(len(progress) == DP_ITERS and all(np.isfinite(v) for ln in progress
                                            for v in ln.values()), "non-finite dp metrics")
    check(all(np.isfinite(v) for v in final.values()), f"non-finite final line {final}")
    check(not os.path.exists(dirs[1]), "rank 1 wrote into its checkpoint directory")
    ck = checkpoint.restore(dirs[0])
    check(checkpoint.latest_step(dirs[0]) == DP_ITERS and ck["env_steps"] == steps
          and final["env_steps"] == steps,
          f"rank 0's checkpoint: step {checkpoint.latest_step(dirs[0])}, env_steps "
          f"{ck['env_steps']} (want {steps})")
    first, first_one = progress[0], [ln for ln in one if "iteration" in ln][0]
    diffs = {k: abs(first[k] - first_one[k]) for k in ("reward_mean", "episode_done_frac")}
    rel = {k: abs(first[k] - first_one[k]) / max(abs(first_one[k]), 1e-12)
           for k in ("loss_policy", "loss_value", "entropy", "kl_approx")}
    log("dp train", f"first iteration, {DP_RANKS} ranks against one process: |d| "
        + fmt(diffs) + " | relative " + fmt(rel))
    check(all(v < DP_TOL for v in diffs.values()), f"dp first iteration moved: {diffs}")
    check(all(v < DP_LOSS_RTOL for v in rel.values()), f"dp loss terms moved: {rel}")
    one_final = one[-1]["final"]
    log("dp train", f"{DP_RANKS} ranks on one card: {dp_s:.1f}s wall (process start included), "
        f"env-steps/s {final['sps']:.1f} (rollout {final['rollout_s']:.3f}s, learn "
        f"{final['learn_s']:.3f}s in the last iteration, the slower rank's); one process: "
        f"env-steps/s {one_final['sps']:.1f} (rollout {one_final['rollout_s']:.3f}s, learn "
        f"{one_final['learn_s']:.3f}s); launches per rank {launches} | {smi}")
    for d in (*dirs, one_dir):
        shutil.rmtree(d, ignore_errors=True)
    return {"launches_per_rank": launches[0], "sps": final["sps"], "one_sps": one_final["sps"]}


def slide_check(dev, smi):
    """Phase 9b: the kernel's slide-joint path against its plain version
    (module docstring)."""
    import numpy as np
    import torch

    from pbrl_tpu_torch.model import load_model
    from pbrl_tpu_torch.ops import field_physics as fp
    from pbrl_tpu_torch.ops import mimic_kernel

    m = load_model(SLIDE_XML)
    check(list(m.jnt_type) == [2, 1], f"the slide scene's joints {list(m.jnt_type)}")
    kstep, spec = mimic_kernel.build_mimic_step(m, n_substeps=8, mode="torque")
    rng = np.random.default_rng(21)
    q = np.tile(np.asarray(m.qpos0, np.float32), (SLIDE_ENVS, 1))
    # the ball about 1 cm above the floor or just touching it; the arm tip up
    q[:, 0] += -0.47 + 0.02 * rng.standard_normal(SLIDE_ENVS)
    q[:, 1] += -0.5 + 0.3 * rng.standard_normal(SLIDE_ENVS)
    v = np.stack([-0.5 + 0.5 * rng.standard_normal(SLIDE_ENVS),
                  1.0 + 0.5 * rng.standard_normal(SLIDE_ENVS)], 1).astype(np.float32)
    q, v = (torch.as_tensor(x, device=dev).contiguous() for x in (q, v))
    u = torch.zeros(SLIDE_ENVS, 1, device=dev)
    touching = float(fp.contacts_touching(spec, q).any(dim=1).float().mean())
    kstep.launches = 0
    r = compare(kstep, lambda a, b, c: mimic_kernel.mimic_step_plain(spec, a, b, c), q, v, u,
                steps=2)
    log("check slide", f"{SLIDE_ENVS} envs of the slide scene, torque mode, 2 policy steps, "
        f"{touching:.3f} of them touching at the start: " + fmt(r)
        + f" | kernel launches {kstep.launches} | {smi}")
    check_errors("slide", r)
    check(kstep.launches == 2, f"slide kernel launches {kstep.launches} != 2")
    return max(r[k] for k in ("dq", "dv_max", "dxpos", "dxquat", "dfall"))


def rollout_check(smi):
    """Phase 9c: ``cli rollout --clip walk --steps ROLLOUT_STEPS`` on the
    card (module docstring)."""
    import io
    import os
    import re

    import numpy as np

    from pbrl_tpu_torch.viz import load_trajectory

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_rollout.npz")
    text = io.StringIO()
    t = time.perf_counter()
    _, built = run_cli(["rollout", "--clip", "walk", "--steps", str(ROLLOUT_STEPS), "--out", out],
                       text)
    rollout_s = time.perf_counter() - t
    line = text.getvalue().strip().splitlines()[-1]
    print("[smoke]   " + line, flush=True)
    m = re.fullmatch(r"rollout: (\d+) steps, mean reward (\S+), alive (\d+) steps -> .*", line)
    launches = sum(k.launches for k in built)
    traj = load_trajectory(out)
    ok = (m is not None and int(m.group(1)) == int(m.group(3)) == ROLLOUT_STEPS
          and float(m.group(2)) >= MIN_EVAL_REWARD)
    log("rollout", f"{rollout_s:.2f}s, kernel launches {launches}, trajectory "
        f"{traj['qpos'].shape}, keys {sorted(traj)} | {smi}")
    check(ok, f"cli rollout: {line}")
    check(launches == ROLLOUT_STEPS, f"rollout kernel launches {launches} != {ROLLOUT_STEPS}")
    check(traj["qpos"].shape == (ROLLOUT_STEPS, 35) and np.isfinite(traj["qpos"]).all()
          and traj["metric_reward"].shape == traj["metric_done"].shape == (ROLLOUT_STEPS,),
          "cli rollout's trajectory")
    os.remove(out)
    return launches


def bench_check(smi):
    """Phase 9d: ``cli bench --num-envs BENCH_ENVS`` (module docstring)."""
    t = time.perf_counter()
    lines, built = run_cli(["bench", "--num-envs", str(BENCH_ENVS)])
    rec = lines[-1]
    log("bench", f"{time.perf_counter() - t:.1f}s (parity included): {rec['value']:.1f} "
        f"env-steps/s at {rec['num_envs']} envs, {rec['achieved_gflops_per_chip']} GFLOP/s, "
        f"timed launches {rec['launches']} of {sum(k.launches for k in built)} | {smi}")
    check(rec["num_envs"] == BENCH_ENVS and rec["value"] > 0 and rec["launches"] == rec["iters"],
          f"cli bench: {rec}")
    return rec["value"]


def last_modules_phase(dev, smi):
    """Phase 9: data-parallel training, the slide joint, cli rollout, cli
    bench (module docstring). Returns the numbers the report line needs."""
    from pbrl_tpu_torch.train import checkpoint, ppo
    from pbrl_tpu_torch.utils.configio import dict_to_config

    t_phase = time.time()
    _, _, run = checkpoint.load_policy(checkpoint.bundled_policy("walk"), device=dev)
    walk_cfg = dict_to_config(ppo.TrainConfig, run["train_config"])
    out = {"dp": dp_train(dev, smi, walk_cfg), "slide_err": slide_check(dev, smi),
           "rollout_launches": rollout_check(smi), "bench_sps": bench_check(smi)}
    log("last modules phase", f"{time.time() - t_phase:.1f}s")
    return out


@contextlib.contextmanager
def count_launches():
    """Within the block, every launch of the policy-step kernel by any
    wrapper is counted in the yielded dict's ``n``."""
    from pbrl_tpu_torch.ops import mimic_kernel

    launch, seen = mimic_kernel.MimicStep._launch, {"n": 0}

    def counted(self, *a):
        seen["n"] += 1
        return launch(self, *a)

    mimic_kernel.MimicStep._launch = counted
    try:
        yield seen
    finally:
        mimic_kernel.MimicStep._launch = launch


def put_down(state, every=4, drop=0.3):
    """A per-env state with every ``every``-th env's root lowered by
    ``drop`` m, so that its next step touches the floor with more than the
    feet (a fall)."""
    import torch

    d = state.pipeline
    low = (torch.arange(d.qpos.shape[0], device=d.qpos.device) % every == 0)
    qpos = d.qpos.clone()
    qpos[:, 2] = torch.where(low, qpos[:, 2] - drop, qpos[:, 2])
    return state.replace(pipeline=d.replace(qpos=qpos)), low


def api_triple(dev, smi, model, clip, walk_run):
    """Phase 10a: ``make_train_functions`` against ``ppo.init`` and
    ``ppo.train_step`` on the kernel (module docstring)."""
    import dataclasses

    import torch

    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.train import make_train_functions, ppo
    from pbrl_tpu_torch.utils.configio import dict_to_config

    walk_cfg = dict_to_config(ppo.TrainConfig, walk_run["train_config"])
    cfg = dataclasses.replace(walk_cfg, total_env_steps=API_ITERS * walk_cfg.steps_per_iteration,
                              seed=0)
    env = MimicVecEnv(model, clip, dict_to_config(EnvConfig, walk_run["env_config"]), device=dev)
    ks = env._kstep
    init, step, evaluate = make_train_functions(env, cfg)
    t = time.perf_counter()
    sides = {}
    for side in ("api", "ppo"):
        ks.launches = 0
        ts = init(dev) if side == "api" else ppo.init(env, cfg, dev)
        hist = []
        for _ in range(API_ITERS):
            ts, m = step(ts) if side == "api" else ppo.train_step(env, cfg, ts)
            hist.append(m)
        torch.cuda.synchronize()
        sides[side] = (ts, hist, ks.launches)
    train_s = time.perf_counter() - t
    (a, ha, la), (b, hb, lb) = sides["api"], sides["ppo"]
    same = all(list(x) == list(y) and all(torch.equal(x[k], y[k]) for k in x)
               for x, y in zip(ha, hb))
    params = all(torch.equal(x, y) for x, y in zip(a.params().values(), b.params().values()))
    kw = dict(num_envs=cfg.num_envs, num_steps=API_EVAL_STEPS)
    ks.launches = 0
    ea = evaluate(a.policy, a.obs_stats, generator=torch.Generator(device=dev).manual_seed(3),
                  **kw)
    eb = ppo.evaluate(env, b.policy, b.obs_stats, normalize_obs=cfg.normalize_obs,
                      generator=torch.Generator(device=dev).manual_seed(3), **kw)
    eval_same = all(torch.equal(ea[k], eb[k]) for k in ea) and list(ea) == list(eb)
    log("api triple", f"make_train_functions against ppo.init/train_step: {API_ITERS} iterations "
        f"of {cfg.num_envs} x {cfg.unroll_length} in {train_s:.2f}s for both; metrics bit-equal "
        f"{same}, params bit-equal {params}, launches {la} / {lb}; evaluate equal {eval_same} "
        f"({ks.launches} launches for both); reward_mean "
        + " ".join(f"{float(m['reward_mean']):.6f}" for m in ha) + f" | {smi}")
    want = API_ITERS * cfg.unroll_length
    check(same and params, "make_train_functions does not train as ppo.init + ppo.train_step")
    check(la == lb == want, f"api triple launches {la} / {lb} != {want}")
    check(eval_same and ks.launches == 2 * API_EVAL_STEPS,
          f"the triple's evaluate differs from ppo.evaluate: {ea} {eb}")
    check(all(bool(torch.isfinite(v)) for m in ha for v in m.values()), "non-finite metrics")
    return la


def per_env_ppo(dev, smi, model, walk_run):
    """Phase 10b: PPO on the per-env ``MimicEnv`` (module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from pbrl_tpu_torch.envs import EnvConfig, MimicEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.train import make_train_functions, networks, ppo, running_stats
    from pbrl_tpu_torch.utils.configio import dict_to_config

    walk_cfg = dict_to_config(ppo.TrainConfig, walk_run["train_config"])
    cfg = dataclasses.replace(walk_cfg, num_envs=PER_ENV_ENVS, seed=0,
                              total_env_steps=PER_ENV_ITERS * PER_ENV_ENVS
                              * walk_cfg.unroll_length)
    env = MimicEnv(model, load_clip("walk", device=dev),
                   dict_to_config(EnvConfig, walk_run["env_config"]))
    init, step, _ = make_train_functions(env, cfg)
    hist = []
    t = time.perf_counter()
    with track_steps() as built, count_launches() as launched:
        ts = init(dev)
        for _ in range(PER_ENV_ITERS):
            ts, m = step(ts)
            hist.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        # one rollout step with a quarter of the envs put down: the ended ones
        # take the fresh reset's state, the others the step's
        one = dataclasses.replace(cfg, unroll_length=1)
        start, low = put_down(ts.env_state)
        ts.env_state = start
        gen = torch.Generator(device=dev).manual_seed(5)
        eps = torch.randn((1, cfg.num_envs, env.action_size), generator=gen, device=dev)
        # given the noise, the rollout draws only its fresh batch, from
        # ts.generator: a twin of that generator draws the same batch here
        ts.generator = torch.Generator(device=dev).manual_seed(6)
        fresh = env.reset(cfg.num_envs, torch.Generator(device=dev).manual_seed(6))
        with torch.no_grad():
            mean, log_std = ts.policy(running_stats.normalize(ts.obs_stats, start.obs))
            stepped = env.step(start, networks.sample_action(mean, log_std, noise=eps[0]))
        final, _ = ppo.rollout(env, one, ts, noise=eps)
        d = stepped.done > 0
        exact = all(torch.equal(x[d], f[d]) and torch.equal(x[~d], y[~d]) for x, f, y in (
            (final.pipeline.qpos, fresh.pipeline.qpos, stepped.pipeline.qpos),
            (final.pipeline.time, fresh.pipeline.time, stepped.pipeline.time),
            (final.info["episode_start"], fresh.info["episode_start"],
             stepped.info["episode_start"])))
        kept = (torch.equal(final.reward, stepped.reward) and torch.equal(final.done, stepped.done)
                and all(torch.equal(final.metrics[k], stepped.metrics[k]) for k in final.metrics))
    for i, h in enumerate(hist):
        print(f"[smoke]   it {i} " + " ".join(f"{k}={h[k]:.5g}" for k in (
            "reward_mean", "episode_done_frac", "loss_policy", "loss_value", "kl_approx")),
            flush=True)
    n_done = int(d.sum())
    log("per-env ppo", f"MimicEnv (engine), {PER_ENV_ITERS} iterations of {cfg.num_envs} x "
        f"{cfg.unroll_length} in {train_s:.2f}s; one step with {int(low.sum())} envs put down: "
        f"{n_done} ended (of them put down {int((d & low).sum())}), restarts exact {exact}, "
        f"reward/done/metrics kept {kept}; wrappers built {len(built)}, kernel launches "
        f"{launched['n']} | {smi}")
    check(all(np.isfinite(v) for h in hist for v in h.values()), f"non-finite metrics {hist}")
    check(0 < n_done < cfg.num_envs, f"{n_done} of {cfg.num_envs} envs ended: no mixed step")
    check(exact and kept, "the per-env auto-reset is not the done-selection")
    check(not built and launched["n"] == 0, "the per-env env launched the kernel")
    return {"launches": launched["n"], "train_s": train_s, "env": env, "ts": ts, "one": one}


def per_env_rollout_ms(smi, env, one, ts, n=3):
    """Phase 10b's ms per rollout step of ``MimicEnv`` (CUDA events, the
    median of ``n`` one-step rollouts), with no other process on the card."""
    import numpy as np
    import torch

    from pbrl_tpu_torch.train import ppo

    ms = []
    with count_launches() as launched:
        for _ in range(n):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            ts.env_state, _ = ppo.rollout(env, one, ts)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
    log("per-env ppo", f"rollout step at {one.num_envs} envs: {float(np.median(ms)):.3f} ms "
        f"(CUDA events, median of {' '.join(f'{x:.3f}' for x in ms)}) | {smi}")
    check(launched["n"] == 0, "the per-env env launched the kernel")
    return float(np.median(ms))


def per_env_apg(dev, smi, model, walk_run):
    """Phase 10c: one APG iteration on the per-env ``MimicEnv`` (module
    docstring)."""
    import math

    import torch

    from pbrl_tpu_torch.envs import EnvConfig, MimicEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.train import apg
    from pbrl_tpu_torch.utils.configio import dict_to_config

    env = MimicEnv(model, load_clip("walk", device=dev),
                   dict_to_config(EnvConfig, walk_run["env_config"]))
    cfg = apg.APGConfig(num_envs=APG_PER_ENV_ENVS, horizon=APG_PER_ENV_HORIZON, action_noise=0.1,
                        hidden=tuple(walk_run["train_config"]["hidden"]),
                        total_env_steps=APG_PER_ENV_ENVS * APG_PER_ENV_HORIZON)
    init, step, _ = apg.make_apg_functions(env, cfg)
    t = time.perf_counter()
    with track_steps() as built, count_launches() as launched:
        ts = init(dev)
        ts.env_state, low = put_down(ts.env_state)
        t0 = ts.env_state.pipeline.time.clone()
        value = {k: v.clone() for k, v in ts.value.state_dict().items()}
        policy = {k: v.clone() for k, v in ts.policy.state_dict().items()}
        ts, m = step(ts)
        torch.cuda.synchronize()
    apg_s = time.perf_counter() - t
    m = {k: float(v) for k, v in m.items()}
    st = ts.env_state
    carried = torch.isclose(st.pipeline.time, t0 + cfg.horizon * env.config.effective_policy_dt,
                            atol=1e-5)
    ended = ~carried
    frozen = all(torch.equal(v, value[k]) for k, v in ts.value.state_dict().items())
    moved = any(not torch.equal(v, policy[k]) for k, v in ts.policy.state_dict().items())
    log("per-env apg", f"MimicEnv (engine), {cfg.num_envs} envs x horizon {cfg.horizon} "
        f"({int(low.sum())} put down): {apg_s:.2f}s; loss {m['loss']:.6g}, grad_norm "
        f"{m['grad_norm']:.6g}, window_alive_frac {m['window_alive_frac']:.4f}; restarted "
        f"{int(ended.sum())} (of them put down {int((ended & low).sum())}), carried on "
        f"{int(carried.sum())}; critic frozen {frozen}, policy moved {moved}; wrappers built "
        f"{len(built)}, kernel launches {launched['n']} | {smi}")
    check(all(math.isfinite(v) for v in m.values()), f"non-finite APG metrics {m}")
    check(frozen and moved, "APG on MimicEnv: the critic moved or the policy did not")
    check(bool((ended >= low).all()) and 0 < int(ended.sum()) < cfg.num_envs
          and bool(torch.equal(st.pipeline.time[ended], st.info["episode_start"][ended])),
          "APG on MimicEnv did not restart the ended envs from a reset")
    check(not built and launched["n"] == 0, "APG on the per-env env launched the kernel")
    return {"launches": launched["n"], "apg_s": apg_s, "grad_norm": m["grad_norm"]}


def start_tour():
    """Phase 10d's subprocesses: ``examples/quickstart_torch.py
    --train-steps QUICKSTART_STEPS`` on the card as two processes side by
    side, sections 1-3 and sections 4-5, started first so that they run
    beside phase 10's other parts."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    args = [["--sections", sec, "--train-steps", str(QUICKSTART_STEPS)]
            for sec in TOUR_SECTIONS]
    return [subprocess.Popen([sys.executable, "-c", QUICKSTART, *a], cwd=root,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for a in args], time.perf_counter()


def stop_tour(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate()


def quickstart_tour(smi, procs, t):
    """Phase 10d: the tour's result (module docstring)."""
    import math
    import re

    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=QUICKSTART_TIMEOUT_S))
    finally:
        stop_tour(procs)
    tour_s = time.perf_counter() - t
    launches = []
    for sec, p, (out, err) in zip(TOUR_SECTIONS, procs, outs):
        check(p.returncode == 0, f"the tour's sections {sec} failed ({p.returncode}):\n"
              f"{err[-3000:]}")
        lines = out.splitlines()
        for ln in lines:
            if ln.strip() and not ln.startswith("{"):
                print("[smoke]   " + ln, flush=True)
        launches.append(json.loads(lines[-1])["kernel_launches"])
        nums = [float(x) for ln in lines if not ln.startswith(("{", "===")) for x in
                re.findall(r"-?\d+\.\d+(?:e-?\d+)?", ln)]
        check(nums and all(math.isfinite(v) for v in nums),
              f"non-finite numbers in the tour's sections {sec}")
    text = "".join(out for out, _ in outs)
    iters = max(1, QUICKSTART_STEPS // (256 * 8))  # the burst's TrainConfig.num_iterations
    want = [0, 1 + iters * 8 + 4]
    log("tour", f"examples/quickstart_torch.py --train-steps {QUICKSTART_STEPS}, sections "
        f"{' and '.join(TOUR_SECTIONS)} side by side: {tour_s:.1f}s (process start included; "
        f"beside phase 10a-c), kernel launches {launches} (want {want}) | {smi}")
    check(launches == want, f"tour kernel launches {launches} != {want}")
    check(all(f"=== {k}." in text for k in range(1, 6)), "a section of the tour did not run")
    check("backend: kernel (the CUDA kernel)" in text, "the tour's env is not on the kernel")
    return sum(launches)


def api_phase(dev, smi, model, clip):
    """Phase 10: the training API and the per-env envs (module docstring).
    Returns the numbers the report line needs."""
    from pbrl_tpu_torch.train import checkpoint

    t_phase = time.time()
    tour = start_tour()
    try:
        _, _, walk_run = checkpoint.load_policy(checkpoint.bundled_policy("walk"), device=dev)
        out = {"api_launches": api_triple(dev, smi, model, clip, walk_run),
               "per_env": per_env_ppo(dev, smi, model, walk_run),
               "apg": per_env_apg(dev, smi, model, walk_run)}
    except BaseException:
        stop_tour(tour[0])
        raise
    out["quickstart_launches"] = quickstart_tour(smi, *tour)
    p = out["per_env"]
    p["rollout_ms"] = per_env_rollout_ms(smi, p.pop("env"), p.pop("one"), p.pop("ts"))
    phase_s = time.time() - t_phase
    log("api phase", f"{phase_s:.1f}s (budget {PHASE10_BUDGET_S}s) | {smi}")
    check(phase_s <= PHASE10_BUDGET_S, f"phase 10 took {phase_s:.1f}s > {PHASE10_BUDGET_S}s")
    return out


def run_tool(name, argv):
    """``scripts/<name>.py``'s ``main(argv)`` in this process, with its
    standard output captured: the JSON lines it printed, and the
    policy-step wrappers the envs it built own."""
    import importlib.util
    import io
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = io.StringIO()
    with track_steps() as built, contextlib.redirect_stdout(text):
        rc = mod.main(argv)
    check(rc == 0, f"scripts/{name}.py {' '.join(argv)} exited {rc}")
    return [json.loads(ln) for ln in text.getvalue().splitlines() if ln.startswith("{")], built


def finite(*xs):
    import math

    return all(math.isfinite(x) for x in xs)


def read_log(rel):
    """One of pbrl_tpu's logs in the checkout: a JSON file, or a run's
    output whose last JSON line is the result."""
    import os

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def ceiling_check(smi):
    """Phase 11a: the reward ceiling of backflip's bundled policy (module
    docstring)."""
    t = time.perf_counter()
    (out,), built = run_tool("torch_backflip_ceiling", ["--steps", str(TOOL_STEPS)])
    wall = time.perf_counter() - t
    launches = sum(k.launches for k in built)
    want = read_log(CEILING_LOG)
    env_rows, want_rows = out["envelope"], want["envelope"]
    check(list(env_rows) == list(want_rows)
          and all(list(env_rows[r]) == list(want_rows[r]) for r in want_rows),
          f"envelope rows or keys {list(env_rows)} differ from {CEILING_LOG}'s")
    diffs = {row: max(abs(env_rows[row][k] - v) for k, v in w.items())
             for row, w in want_rows.items()}
    for row, vals in env_rows.items():
        print(f"[smoke]   envelope {row:>10}: {json.dumps(vals)} (max |port - log| "
              f"{diffs[row]:.1e})", flush=True)
    ck = out["checkpoint"]
    log("ceiling", f"scripts/torch_backflip_ceiling.py --steps {TOOL_STEPS}: {wall:.2f}s, kernel "
        f"launches {launches}; part (c) {json.dumps(ck)} (pbrl_tpu's log, an earlier checkpoint: "
        f"{json.dumps(want['checkpoint'])}); ceiling at 1 frame "
        f"{out['ceiling_at_1frame_timing']}, fraction {out['eval_fraction_of_ceiling']} | {smi}")
    check(max(diffs.values()) <= CEILING_TOL + 1e-9,
          f"the envelope is not the log's to {CEILING_TOL}: {diffs}")
    check(launches == out["launches"] == TOOL_STEPS,
          f"ceiling kernel launches {launches} / {out['launches']} != {TOOL_STEPS}")
    check(finite(out["ceiling_at_1frame_timing"], out["eval_fraction_of_ceiling"],
                 *[v for k, v in ck.items() if k != "terms_mean"], *ck["terms_mean"].values()),
          f"non-finite ceiling part (c): {ck}")
    return {"ckpt": ck, "launches": launches, "s": wall}


def lag_check(smi):
    """Phase 11b: the lag of the artifact and of a rollout on the card
    (module docstring)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    (lag,), _ = run_tool("torch_measure_lag",
                         [os.path.join(root, "artifacts", "backflip.npz"), "backflip"])
    wall = time.perf_counter() - t
    want = read_log(LAG_LOG)
    d_sse = max(abs(a - b) for a, b in zip(lag["sse"], want["sse"]))
    log("lag", f"scripts/torch_measure_lag.py artifacts/backflip.npz backflip: {wall:.2f}s, best "
        f"lag {lag['best_lag_steps']} steps ({lag['best_lag_ms']:.2f} ms), SSE at best "
        f"{lag['sse_at_best']:.6f}, at 0 {lag['sse_at_zero']:.6f}; max |SSE - log| {d_sse:.2e} "
        f"over {len(lag['sse'])} lags (pbrl_tpu: {want['best_lag_steps']}) | {smi}")
    check(lag["best_lag_steps"] == want["best_lag_steps"],
          f"best lag {lag['best_lag_steps']} != {want['best_lag_steps']}")
    check(lag["lags_steps"] == want["lags_steps"] and d_sse <= LAG_TOL,
          f"the lag's SSE is not the log's to {LAG_TOL}: {d_sse}")
    npz = os.path.join(root, "build", "smoke_backflip_rollout.npz")
    t = time.perf_counter()
    _, built = run_cli(["rollout", "--clip", "backflip", "--steps", str(LAG_ROLLOUT_STEPS),
                        "--out", npz])
    launches = sum(k.launches for k in built)
    (own,), _ = run_tool("torch_measure_lag", [npz, "backflip"])
    wall = time.perf_counter() - t
    os.remove(npz)
    log("lag", f"cli rollout --clip backflip --steps {LAG_ROLLOUT_STEPS} on the card and its lag: "
        f"{wall:.2f}s, kernel launches {launches}; best lag {own['best_lag_steps']} steps "
        f"({own['best_lag_ms']:.2f} ms), SSE at best {own['sse_at_best']:.6f}, at 0 "
        f"{own['sse_at_zero']:.6f} (the artifact's: {lag['best_lag_steps']}, "
        f"{lag['sse_at_best']:.6f}) | {smi}")
    check(launches == LAG_ROLLOUT_STEPS, f"rollout kernel launches {launches} != "
          f"{LAG_ROLLOUT_STEPS}")
    check(finite(own["best_lag_steps"], own["sse_at_best"]), f"non-finite lag {own}")
    return {"best_lag": lag["best_lag_steps"], "own_best_lag": own["best_lag_steps"],
            "launches": launches}


def diag_check(smi, ceiling):
    """Phase 11c: the diagnostic rollouts of walk and backflip (module
    docstring)."""
    import os

    import numpy as np

    out = {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    for clip, steps in (("walk", DIAG_WALK_STEPS), ("backflip", TOOL_STEPS)):
        npz = os.path.join(build, f"smoke_diag_{clip}.npz")
        t = time.perf_counter()
        (line,), built = run_tool("torch_diag_rollout", ["--clip", clip, "--steps", str(steps),
                                                         "--out", npz])
        wall = time.perf_counter() - t
        launches = sum(k.launches for k in built)
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
        os.remove(npz)
        print("[smoke]   " + json.dumps(line), flush=True)
        log(f"diag {clip}", f"scripts/torch_diag_rollout.py --clip {clip} --steps {steps}: "
            f"{wall:.2f}s, kernel launches {launches}, mean reward {line['mean_reward']}, alive "
            f"{line['alive']}, npz {sorted(arrays)} | {smi}")
        check(launches == line["launches"] == steps,
              f"diag {clip} kernel launches {launches} / {line['launches']} != {steps}")
        check(arrays["qpos"].shape == (steps, 35)
              and all(np.isfinite(a).all() for a in arrays.values())
              and finite(line["mean_reward"], *line["terms_mean"].values()),
              f"diag {clip}: non-finite or misshapen output")
        out[clip] = {"launches": launches, "mean_reward": line["mean_reward"],
                     "alive": line["alive"]}
    walk = out["walk"]
    check(walk["alive"] == DIAG_WALK_STEPS and walk["mean_reward"] >= MIN_EVAL_REWARD,
          f"walk's diag rollout: alive {walk['alive']}, mean reward {walk['mean_reward']}")
    check(out["backflip"]["mean_reward"] == ceiling["mean_reward"],
          "backflip's diag rollout and the ceiling's part (c) differ: "
          f"{out['backflip']['mean_reward']} / {ceiling['mean_reward']}")
    return out


def sweep_check(smi, unscaled):
    """Phase 11d: campaign 33's stiffness sweep through ``cli eval`` (module
    docstring)."""
    import numpy as np

    from pbrl_tpu_torch.mocap.skeleton import generate_kp_kd_gains

    base_kp, base_kd = (np.asarray(g, np.float64) for g in generate_kp_kd_gains())
    out = []
    for kp, kd, src in SWEEP:
        logged = read_log(src)
        want_r, want_len = logged["eval_reward"], logged["eval_episode_length"]
        t = time.perf_counter()
        lines, built = run_cli(["eval", "--clip", "backflip", "--num-envs", str(RECIPE_ENVS),
                                "--steps", str(RECIPE_STEPS), "--env-set", f"kp_scale={kp}",
                                "--env-set", f"kd_scale={kd}"])
        wall = time.perf_counter() - t
        m, launches = lines[-1], sum(k.launches for k in built)
        gains_err = max(max(np.max(np.abs(np.asarray(k.spec.kp) / (base_kp * kp) - 1)),
                            np.max(np.abs(np.asarray(k.spec.kd) / (base_kd * kd) - 1)))
                        for k in built)
        log(f"sweep kp {kp}", f"cli eval --clip backflip --env-set kp_scale={kp} --env-set "
            f"kd_scale={kd}, {RECIPE_ENVS} envs x {RECIPE_STEPS} steps: {wall:.2f}s, kernel "
            f"launches {launches}: {m['eval_reward']:.5f} / {m['eval_episode_length']:.3f}; "
            f"recorded on a TPU ({src}, 128 envs): {want_r:.5f} / {want_len:.3f}; the kernel's "
            f"kp/kd tables against the scaled defaults: max relative error {gains_err:.1e} "
            f"| {smi}")
        check(launches == RECIPE_STEPS, f"kp {kp}: kernel launches {launches} != {RECIPE_STEPS}")
        check(built and gains_err <= GAIN_RTOL,
              f"kp {kp}: the kernel's gains are not kp x {kp}, kd x {kd}: {gains_err}")
        check(finite(*m.values()), f"kp {kp}: non-finite eval {m}")
        check(abs(m["eval_reward"] - want_r) <= SWEEP_REWARD_TOL,
              f"kp {kp}: eval_reward {m['eval_reward']} not within {SWEEP_REWARD_TOL} of {want_r}")
        check(abs(m["eval_episode_length"] / want_len - 1) <= SWEEP_LENGTH_TOL,
              f"kp {kp}: eval_episode_length {m['eval_episode_length']} not within "
              f"{SWEEP_LENGTH_TOL:.0%} of {want_len}")
        out.append({"kp": kp, "kd": kd, **m, "launches": launches, "s": wall})
    log("sweep", "eval_reward by kp_scale: " + ", ".join(
        f"{r['kp']}: {r['eval_reward']:.5f}" for r in out)
        + f"; unscaled (phase 6): {unscaled['eval_reward']:.5f}")
    check(out[-1]["kp"] == 2.0 and out[-1]["eval_reward"] < unscaled["eval_reward"],
          "kp 2.0 does not evaluate below the unscaled backflip eval")
    return out


def tools_phase(smi, unscaled):
    """Phase 11: the backflip investigation's tools and campaign 33's sweep
    (module docstring). Returns the numbers the report line needs."""
    t_phase = time.time()
    ceiling = ceiling_check(smi)
    out = {"ceiling": ceiling["launches"], "lag": lag_check(smi),
           "diag": diag_check(smi, ceiling["ckpt"]), "sweep": sweep_check(smi, unscaled)}
    phase_s = time.time() - t_phase
    log("tools phase", f"{phase_s:.1f}s (budget {PHASE11_BUDGET_S}s) | {smi}")
    check(phase_s <= PHASE11_BUDGET_S, f"phase 11 took {phase_s:.1f}s > {PHASE11_BUDGET_S}s")
    return out


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
    from pbrl_tpu_torch.envs import humanoid_task as task
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
    u = task.pd_target(env.clip, env.config, st.time, act, env.tables).contiguous()
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
    with watch_endings(env, keep_at=MID_EVAL_STEP) as rec:
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
    mid = rec.pop("kept_at")
    del rec
    mid_ms = time_launch(ks, *mid)
    mid_need = needed(sp, *mid)
    mid_bound_ms, mid_bound_by = bound(sp, mid_need["flop_per_env"], EVAL_ENVS)
    log("mid-eval", f"the eval's states at step {MID_EVAL_STEP}, B={EVAL_ENVS}: kernel "
        f"{mid_ms:.4f} ms/launch (start states {kernel_ms:.4f}); {mid_need['flop_per_env']:.1f} "
        f"FLOP/env/step (touching per env and substep: {mid_need['ground']:.3f} ground, "
        f"{mid_need['self']:.3f} self contacts) -> {mid_bound_ms:.5f} ms ({mid_bound_by}; "
        f"start states {bound_ms:.5f}) | {smi}")
    check(mid[0].shape[0] == EVAL_ENVS and bool(mid[0].isfinite().all()),
          "the mid-eval states are not the eval's batch")

    # 5. train
    tr = train_phase(dev, smi, model, clip)

    # 6. the other shipped recipes
    rc = recipes_phase(dev, smi, model)

    # 7. the engine, held-torque PD, the controllers, replay
    en = engine_phase(dev, smi, model, clip, metrics)

    # 8. APG through the engine, the DiffMimic clip
    ag = apg_phase(dev, smi, model)

    # 9. the last modules: data parallelism, the slide joint, rollout, bench
    lm = last_modules_phase(dev, smi)

    # 10. the training API, PPO and APG on the per-env env, the tour
    ap = api_phase(dev, smi, model, clip)

    # 11. the backflip investigation's tools, campaign 33's sweep
    tl = tools_phase(smi, rc["evals"]["backflip"])

    # 12. report
    print(json.dumps({"kernels": [{
        "name": "mimic_step", "route": "cuda",
        "source": "pbrl_tpu_torch/csrc/mimic_step.cu",
        "replaces": "pbrl_tpu/ops/mimic_kernel.py:144",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "mid_eval_ms": mid_ms, "mid_eval_bound_ms": mid_bound_ms,
        "train_launches": tr["launches"], "train_ms": tr["kernel_ms"],
        "train_bound_ms": tr["bound_ms"], "train_max_abs_err": tr["max_abs_err"],
        "recipe_launches": rc["launches"], "self_contact_ms": rc["self_ms"],
        "self_contact_bound_ms": rc["self_bound_ms"],
        "self_contact_max_abs_err": rc["self_err"], "backflip_finetune_launches":
        rc["ft_launches"], "held_launches": en["held_launches"],
        "torque_mode_ms": en["torque_ms"], "torque_mode_bound_ms": en["torque_bound"],
        "torque_mode_max_abs_err": en["held_err"], "apg_launches": ag["apg_launches"],
        "apg_eval_launches": ag["apg_eval_launches"],
        "dp_launches_per_rank": lm["dp"]["launches_per_rank"], "dp_env_steps_per_s":
        lm["dp"]["sps"], "slide_max_abs_err": lm["slide_err"],
        "rollout_launches": lm["rollout_launches"], "bench_env_steps_per_s": lm["bench_sps"],
        "api_train_launches": ap["api_launches"],
        "per_env_launches": ap["per_env"]["launches"] + ap["apg"]["launches"],
        "per_env_rollout_ms": ap["per_env"]["rollout_ms"],
        "quickstart_launches": ap["quickstart_launches"],
        "tools_launches": {"ceiling": tl["ceiling"], "rollout": tl["lag"]["launches"],
                           "diag": {c: d["launches"] for c, d in tl["diag"].items()},
                           "sweep": [r["launches"] for r in tl["sweep"]]},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
