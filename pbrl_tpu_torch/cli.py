"""Command line of the port (counterpart of ``pbrl_tpu/cli.py``).

    python -m pbrl_tpu_torch.cli info
    python -m pbrl_tpu_torch.cli replay --clip walk --out walk.npz
    python -m pbrl_tpu_torch.cli train --clip walk --checkpoint-dir runs/walk
    python -m pbrl_tpu_torch.cli train-apg --from-checkpoint runs/walk --checkpoint-dir runs/apg
    python -m pbrl_tpu_torch.cli eval --clip walk --checkpoint-dir runs/walk
    python -m pbrl_tpu_torch.cli rollout --clip walk --video walk.mp4
    python -m pbrl_tpu_torch.cli bench --num-envs 4096
    torchrun --nproc-per-node 4 -m pbrl_tpu_torch.cli train --distributed

``info`` prints the devices, the model's sizes, the bundled clips and the
registered environments. ``replay`` plays a clip back kinematically
(:class:`~pbrl_tpu_torch.envs.replay.ReplayEnv`) for ``--steps`` policy
steps (default one cycle) and writes the qpos trajectory to ``--out``;
``--video`` renders it with host MuJoCo (from ``--camera``), which must
be installed.

``train`` runs PPO (:func:`pbrl_tpu_torch.train.ppo.train`) with pbrl_tpu's
flags, ``--env-set`` and ``--train-set`` included; it prints one JSON line
per iteration and a last ``{"final": ...}`` line. With ``--checkpoint-dir``
it writes ``run_config.json`` and checkpoints there and resumes from the
latest one. ``--backend`` picks the physics: ``auto`` or ``kernel`` the
policy-step kernel, ``xla`` the einsum engine in plain PyTorch (pbrl_tpu's
name for its engine backend); ``--controller`` takes all four PD laws (the
kernel implicit and Stable PD only). With ``--distributed`` it is one rank
of a data-parallel run (:mod:`pbrl_tpu_torch.parallel`): the ranks meet at
``--coordinator`` (host:port) with ``--num-processes`` and
``--process-id``, or, without them, where torchrun's environment says;
each rank runs on ``cuda:LOCAL_RANK`` (modulo the cards; ``--device cpu``: the CPU), steps
``--num-envs / world`` envs, and together the ranks compute one process's
training step on the whole batch. The run's first line names the
collective backend (NCCL when each process has a card of its own, gloo when
processes share one or run on the CPU); only rank 0 prints progress and
writes the run config and checkpoints, and every rank prints the same
final line.

``train-apg`` runs analytic policy gradients
(:func:`pbrl_tpu_torch.train.apg.train`) with pbrl_tpu's flags, on the
engine (``backend="xla"``: the kernel has no backward). With
``--from-checkpoint`` (a run directory of the port, e.g. one written by
``checkpoint.import_train_state``) it starts from that run's params, obs
stats and ``env_steps`` and inherits its whole training ``EnvConfig``, its
clip and its network fields; ``--env-set`` and ``--apg-set`` apply on top.
It prints one JSON line per ``--steps-per-call`` iterations and a last
``{"final": ...}`` line; ``eval --checkpoint-dir`` reads its output.

``rollout`` runs one env of ``--clip`` with the policy's mean action
for ``--steps`` steps (the kernel's launches on the card), writes the qpos
trajectory with its rewards and dones to ``--out``, prints pbrl_tpu's
summary line and, with ``--video``, renders it. The policy is found as
``eval`` finds it. ``bench`` runs :mod:`pbrl_tpu_torch.bench` at
``--num-envs`` envs.

``eval`` rebuilds the env from the run configuration (``run_config.json``
in ``--checkpoint-dir``, which must hold one, else the copy inside the
policy file), strips the training-only perturbations as pbrl_tpu's eval
does, applies ``--env-set`` on top, and runs the deterministic
evaluation. The clip is ``--clip``, else the run configuration's. The
policy comes from ``--policy`` (an exported ``.npz``), else from the latest
of the port's checkpoints in ``--checkpoint-dir``, else from the bundled
``assets/<clip>_policy.npz`` written by ``scripts/export_torch_policy.py``
(one for each of the seven shipped clips); it must have been trained on
that clip.

Everything runs on ``--device`` (default ``cuda``); without a card the
commands stop with an error unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _require_device(device: str) -> None:
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this command runs on the card; "
                         "pass --device cpu to run it on the CPU")


def _env_config(run: dict):
    from pbrl_tpu_torch.envs import EnvConfig
    from pbrl_tpu_torch.utils.configio import dict_to_config

    cfg = dict_to_config(EnvConfig, dict(run.get("env_config") or {}))
    # Evaluation measures clean reference starts and the standard reward.
    return dataclasses.replace(cfg, rsi_noise_qpos=0.0, rsi_noise_qvel=0.0,
                               rsi_noise_root_xy=0.0, rsi_phase_bias=0.0,
                               curriculum_reset_prob=0.0, aerial_window=(),
                               drift_w=0.0, contact_tc_scale=1.0, friction_scale=1.0)


def _overrides(cfg, kvs, flag, tuple_item):
    """Apply repeatable ``FIELD=VALUE`` overrides to a dataclass config,
    typed by the field's current value: bools accept 1/true/yes, tuples
    are comma-separated ``tuple_item``s ('' = empty), the rest casts."""
    fields = {f.name for f in dataclasses.fields(type(cfg))}
    out = {}
    for kv in kvs:
        k, _, v = kv.partition("=")
        if k not in fields:
            raise SystemExit(f"{flag}: unknown {type(cfg).__name__} field {k!r}")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            out[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, tuple):
            out[k] = tuple(tuple_item(x) for x in v.split(",") if x != "")
        else:
            out[k] = type(cur)(v)
    return dataclasses.replace(cfg, **out)


def _float_or_str(x):
    try:
        return float(x)
    except ValueError:
        return x


def cmd_info(args):
    import torch

    from pbrl_tpu_torch.envs import registered_environments
    from pbrl_tpu_torch.mocap import bundled_clip_names
    from pbrl_tpu_torch.model import humanoid_model

    m = humanoid_model()
    cuda = torch.cuda.is_available()
    print(json.dumps({
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if cuda else [],
        "model": {"nq": m.nq, "nv": m.nv, "nu": m.nu, "nbody": m.nbody},
        "clips": bundled_clip_names(),
        "environments": registered_environments(),
    }))
    return 0


def _write_video(path, qpos, fps, camera):
    from pbrl_tpu_torch.model import humanoid_spec
    from pbrl_tpu_torch.viz import render_video, save_video

    out = save_video(path, render_video(humanoid_spec(), qpos, camera=camera or None), fps=fps)
    print(f"video -> {out}")


def cmd_replay(args):
    _require_device(args.device)

    from pbrl_tpu_torch.envs import ReplayEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model
    from pbrl_tpu_torch.viz import dump_trajectory

    env = ReplayEnv(humanoid_model(), load_clip(args.clip, device=args.device))
    steps = args.steps or int(float(env.clip.cycle_time) / env.config.policy_dt) + 1
    states = env.rollout(steps)
    qpos = states.pipeline.qpos[:, 0].cpu().numpy()
    dump_trajectory(args.out, qpos, 1.0 / env.config.policy_dt)
    print(json.dumps({"replayed": args.clip, "frames": steps, "out": args.out}))
    if args.video:
        _write_video(args.video, qpos, 1.0 / env.config.policy_dt, args.camera)
    return 0


def cmd_train(args):
    _require_device(args.device)
    if not args.distributed:
        return _train(args, args.device, None)

    import torch

    from pbrl_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize_distributed(distributed.DistributedConfig(
        coordinator_address=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id), device=args.device)
    try:
        mesh = make_mesh(args.device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        print(json.dumps({"distributed": {"backend": distributed.backend(),
                                          "world": mesh.world}}), flush=True)
        return _train(args, mesh.device, mesh)
    finally:
        distributed.shutdown()


def _train(args, device, mesh):
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model
    from pbrl_tpu_torch.train.ppo import TrainConfig, train

    env_cfg = EnvConfig(controller=args.controller,
                        enforce_joint_limits=not args.no_joint_limits,
                        early_termination=not args.no_early_termination,
                        action_mode=args.action_mode,
                        rsi_phase_bias=args.rsi_phase_bias,
                        torque_limit_scale=args.torque_scale,
                        policy_dt=args.policy_dt,
                        physics_dt=args.physics_dt,
                        pose_termination=args.pose_termination)
    env_cfg = _overrides(env_cfg, args.env_set, "--env-set", _float_or_str)
    env = MimicVecEnv(humanoid_model(), load_clip(args.clip, device=device), env_cfg,
                      backend=args.backend, device=device, mesh=mesh)
    cfg = TrainConfig(num_envs=args.num_envs, unroll_length=args.unroll_length,
                      total_env_steps=args.total_steps, learning_rate=args.lr,
                      gamma=args.gamma, seed=args.seed)
    cfg = _overrides(cfg, args.train_set, "--train-set", int)

    def progress(it, entry):
        print(json.dumps({"iteration": it, **{k: round(v, 5) if isinstance(v, float) else v
                                             for k, v in entry.items()}}), flush=True)

    _, history = train(env, cfg, progress_fn=progress if args.verbose else None,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=args.checkpoint_every, device=device)
    print(json.dumps({"final": history[-1] if history else {}}), flush=True)
    return 0


def cmd_train_apg(args):
    _require_device(args.device)

    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model
    from pbrl_tpu_torch.train import APGConfig, checkpoint, train_apg
    from pbrl_tpu_torch.utils.configio import dict_to_config

    env_cfg, clip, run = EnvConfig(), args.clip or "walk", None
    if args.from_checkpoint:
        # a fine-tune continues the source run's problem: its whole training
        # env (shaping and reset noise included), its clip and its widths
        run = checkpoint.load_run_config(args.from_checkpoint)
        if run.get("env_config"):
            env_cfg = dict_to_config(EnvConfig, run["env_config"])
        clip = args.clip or run.get("clip") or clip
    env_cfg = _overrides(env_cfg, args.env_set, "--env-set", _float_or_str)
    # the policy-step kernel has no backward: APG runs on the engine
    env = MimicVecEnv(humanoid_model(), load_clip(clip, device=args.device), env_cfg,
                      backend="xla", device=args.device)
    cfg = APGConfig(num_envs=args.num_envs, horizon=args.horizon, learning_rate=args.lr,
                    gamma=args.gamma, total_env_steps=args.total_steps, seed=args.seed)
    if run is not None and run.get("train_config"):
        tc = run["train_config"]
        cfg = dataclasses.replace(
            cfg, hidden=tuple(tc.get("hidden", cfg.hidden)),
            normalize_obs=tc.get("normalize_obs", cfg.normalize_obs),
            init_log_std=tc.get("init_log_std", cfg.init_log_std),
            fixed_log_std=tc.get("fixed_log_std", cfg.fixed_log_std))
    cfg = _overrides(cfg, args.apg_set, "--apg-set", int)

    def progress(it, entry):
        print(json.dumps({"iteration": it, **{k: round(v, 5) if isinstance(v, float) else v
                                             for k, v in entry.items()}}), flush=True)

    _, history = train_apg(env, cfg, progress_fn=progress if args.verbose else None,
                           checkpoint_dir=args.checkpoint_dir,
                           checkpoint_every=args.checkpoint_every,
                           steps_per_call=args.steps_per_call,
                           resume_from=args.from_checkpoint, device=args.device)
    print(json.dumps({"final": history[-1] if history else {}}))
    return 0


def _policy_env(args):
    """(policy, obs stats, run config, env) of ``eval`` and ``rollout``:
    the policy from ``--policy``, else ``--checkpoint-dir``'s latest
    checkpoint, else the clip's bundled export; the env of its
    eval-stripped run config with ``--env-set`` on top."""
    from pbrl_tpu_torch.envs import MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model
    from pbrl_tpu_torch.train import checkpoint

    run = checkpoint.load_run_config(args.checkpoint_dir) if args.checkpoint_dir else None
    clip = args.clip or (run or {}).get("clip") or "walk"
    if (args.policy is None and args.checkpoint_dir
            and checkpoint.latest_step(args.checkpoint_dir) is not None):
        policy, stats = checkpoint.load_policy_from_dir(args.checkpoint_dir, device=args.device)
        policy_run = run
    else:
        policy, stats, policy_run = checkpoint.load_policy(
            args.policy or checkpoint.bundled_policy(clip), device=args.device)
    if policy_run.get("clip") != clip:
        raise ValueError(f"the policy was trained on clip {policy_run.get('clip')!r}, "
                         f"not on {clip!r}")
    run = run or policy_run
    env_cfg = _overrides(_env_config(run), args.env_set, "--env-set", _float_or_str)
    env = MimicVecEnv(humanoid_model(), load_clip(clip, device=args.device), env_cfg,
                      device=args.device)
    return policy, stats, run, env


def _normalize_obs(run) -> bool:
    return (run.get("train_config") or {}).get("normalize_obs", True)


def cmd_eval(args):
    import torch

    from pbrl_tpu_torch.train import evaluate

    _require_device(args.device)
    policy, stats, run, env = _policy_env(args)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    metrics = evaluate(env, policy, stats, num_envs=args.num_envs, num_steps=args.steps,
                       generator=gen, normalize_obs=_normalize_obs(run))
    print(json.dumps({k: float(v) for k, v in metrics.items()}))
    return 0


REWARD_TERMS = ("reward_pose", "reward_vel", "reward_ee", "reward_com")


def rollout_trajectory(env, policy, stats, state, steps: int, normalize_obs: bool = True) -> dict:
    """``steps`` steps of the policy's mean action from ``state`` (no
    reset after a done, as pbrl_tpu's rollout), env 0's record as numpy:
    ``qpos`` (steps, nq), ``qvel`` (steps, nv), ``reward``, ``done``,
    ``time`` and ``root_err`` (steps,), and ``terms`` (steps, 4), the
    REWARD_TERMS in order. One copy to the host, at the end."""
    import torch

    from pbrl_tpu_torch.train.running_stats import normalize

    rows = []
    with torch.no_grad():
        for _ in range(steps):
            mean, _ = policy(normalize(stats, state.obs) if normalize_obs else state.obs)
            state = env.step(state, mean)
            m = state.metrics
            rows.append((state.qpos[0], state.qvel[0], state.reward[0], state.done[0],
                         state.time[0], m["root_err"][0],
                         torch.stack([m[k][0] for k in REWARD_TERMS])))
    keys = ("qpos", "qvel", "reward", "done", "time", "root_err", "terms")
    return {k: torch.stack(x).cpu().numpy() for k, x in zip(keys, zip(*rows))}


def cmd_rollout(args):
    import numpy as np
    import torch

    from pbrl_tpu_torch.viz import dump_trajectory

    _require_device(args.device)
    policy, stats, run, env = _policy_env(args)
    state = env.reset(1, torch.Generator(device=args.device).manual_seed(args.seed))
    r = rollout_trajectory(env, policy, stats, state, args.steps, _normalize_obs(run))
    qpos, reward, done = r["qpos"], r["reward"], r["done"]
    fps = 1.0 / env.config.effective_policy_dt
    dump_trajectory(args.out, qpos, fps, metrics={"reward": reward, "done": done})
    alive = int(np.argmax(done > 0)) or args.steps
    print(f"rollout: {args.steps} steps, mean reward {float(reward[:alive].mean()):.3f}, "
          f"alive {alive} steps -> {args.out}")
    if args.video:
        _write_video(args.video, qpos, fps, args.camera)
    return 0


def cmd_bench(args):
    import os

    from pbrl_tpu_torch import bench

    _require_device(args.device)
    os.environ["BENCH_NUM_ENVS"] = str(args.num_envs)
    bench.main(device=args.device)
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="python -m pbrl_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("info", help="print devices, model dims, clips")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("replay", help="kinematic clip playback -> trajectory")
    sp.add_argument("--clip", default="walk", help="bundled clip name or a file path")
    sp.add_argument("--steps", type=int, default=0, help="frames (default: one cycle)")
    sp.add_argument("--out", default="replay.npz")
    sp.add_argument("--video", default="", help="optional video output path (host MuJoCo)")
    sp.add_argument("--camera", default="back",
                    help="named model camera for --video (back/side; '' = free)")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser("train", help="PPO imitation training")
    sp.add_argument("--clip", default="walk", help="bundled clip name or a file path")
    sp.add_argument("--num-envs", type=int, default=2048)
    sp.add_argument("--unroll-length", type=int, default=16)
    sp.add_argument("--total-steps", type=int, default=10_000_000)
    sp.add_argument("--lr", type=float, default=3e-4)
    sp.add_argument("--gamma", type=float, default=0.95)
    sp.add_argument("--checkpoint-every", type=int, default=200,
                    help="iterations between checkpoints")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--controller", default="implicit_pd",
                    choices=["implicit_pd", "stable_pd", "standard_pd",
                             "inverse_dynamics_pd"])
    sp.add_argument("--action-mode", default="absolute",
                    choices=["absolute", "residual", "torque"])
    sp.add_argument("--no-early-termination", action="store_true")
    sp.add_argument("--no-joint-limits", action="store_true")
    sp.add_argument("--rsi-phase-bias", type=float, default=0.0)
    sp.add_argument("--policy-dt", type=float, default=1.0 / 60.0)
    sp.add_argument("--physics-dt", type=float, default=0.002)
    sp.add_argument("--pose-termination", type=float, default=0.0)
    sp.add_argument("--env-set", action="append", default=[], metavar="FIELD=VALUE",
                    help="override any EnvConfig field (repeatable)")
    sp.add_argument("--train-set", action="append", default=[], metavar="FIELD=VALUE",
                    help="override any TrainConfig field (repeatable), e.g. "
                         "--train-set hidden=512,256")
    sp.add_argument("--torque-scale", type=float, default=2.0)
    sp.add_argument("--backend", default="auto", choices=["auto", "kernel", "xla"],
                    help="physics: the policy-step kernel (auto, kernel) or the einsum "
                         "engine in plain PyTorch (xla)")
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--quiet", dest="verbose", action="store_false")
    sp.add_argument("--distributed", action="store_true",
                    help="one rank of a data-parallel run over torch.distributed (torchrun's "
                         "environment unless --coordinator/--num-processes/--process-id)")
    sp.add_argument("--coordinator", default=None,
                    help="host:port where the ranks meet (served by process 0)")
    sp.add_argument("--num-processes", type=int, default=None)
    sp.add_argument("--process-id", type=int, default=None)
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("train-apg", help="analytic-policy-gradient training through the "
                        "differentiable engine (usually a PPO fine-tune)")
    sp.add_argument("--clip", default=None, help="default: the source run's clip, else walk")
    sp.add_argument("--from-checkpoint", default=None,
                    help="warm-start params, obs stats and env_steps (and inherit the "
                         "training env config, clip and widths) from this run directory")
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--checkpoint-every", type=int, default=50)
    sp.add_argument("--steps-per-call", type=int, default=10,
                    help="iterations per progress line")
    sp.add_argument("--num-envs", type=int, default=256)
    sp.add_argument("--horizon", type=int, default=32,
                    help="truncated-BPTT window length (policy steps)")
    sp.add_argument("--total-steps", type=int, default=2_000_000)
    sp.add_argument("--lr", type=float, default=2e-5)
    sp.add_argument("--gamma", type=float, default=0.95)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--env-set", action="append", default=[], metavar="FIELD=VALUE",
                    help="override EnvConfig fields on top of the inherited run config")
    sp.add_argument("--apg-set", action="append", default=[], metavar="FIELD=VALUE",
                    help="override any APGConfig field (repeatable), e.g. "
                         "--apg-set action_noise=0.02 --apg-set remat=false")
    sp.add_argument("--quiet", dest="verbose", action="store_false")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.set_defaults(fn=cmd_train_apg)

    sp = sub.add_parser("eval", help="evaluate a policy")
    sp.add_argument("--clip", default=None)
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--policy", default=None, help="exported .npz")
    sp.add_argument("--num-envs", type=int, default=128)
    sp.add_argument("--steps", type=int, default=256)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--env-set", action="append", default=[], metavar="FIELD=VALUE",
                    help="override EnvConfig fields on top of the eval-stripped run "
                         "config (repeatable), e.g. --env-set ref_target_lead=0.025")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("rollout", help="roll a policy -> trajectory/video")
    sp.add_argument("--clip", default=None)
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--policy", default=None, help="exported .npz")
    sp.add_argument("--steps", type=int, default=300)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out", default="rollout.npz")
    sp.add_argument("--video", default="", help="optional video output path (host MuJoCo)")
    sp.add_argument("--camera", default="back",
                    help="named model camera for --video (back/side; '' = free)")
    sp.add_argument("--env-set", action="append", default=[], metavar="FIELD=VALUE",
                    help="override EnvConfig fields on top of the eval-stripped run config")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.set_defaults(fn=cmd_rollout)

    sp = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    sp.add_argument("--num-envs", type=int, default=4096)
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
