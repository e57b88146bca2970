"""Command line of the port (counterpart of ``pbrl_tpu/cli.py``).

    python -m pbrl_tpu_torch.cli info
    python -m pbrl_tpu_torch.cli replay --clip walk --out walk.npz
    python -m pbrl_tpu_torch.cli train --clip walk --checkpoint-dir runs/walk
    python -m pbrl_tpu_torch.cli eval --clip walk --checkpoint-dir runs/walk

``info`` prints the devices, the model's sizes, the bundled clips and the
registered environments. ``replay`` plays a clip back kinematically
(:class:`~pbrl_tpu_torch.envs.replay.ReplayEnv`) for ``--steps`` policy
steps (default one cycle) and writes the qpos trajectory to ``--out``;
``--video`` is refused, as rendering needs MuJoCo.

``train`` runs PPO (:func:`pbrl_tpu_torch.train.ppo.train`) with pbrl_tpu's
flags, ``--env-set`` and ``--train-set`` included; it prints one JSON line
per iteration and a last ``{"final": ...}`` line. With ``--checkpoint-dir``
it writes ``run_config.json`` and checkpoints there and resumes from the
latest one. ``--backend`` picks the physics: ``auto`` or ``kernel`` the
policy-step kernel, ``xla`` the einsum engine in plain PyTorch (pbrl_tpu's
name for its engine backend); ``--controller`` takes all four PD laws (the
kernel implicit and Stable PD only). One process on one device: the
multi-process flags are refused.

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


def cmd_replay(args):
    if args.video:
        raise SystemExit("--video: rendering needs host MuJoCo, which the port does not "
                         "use; write the trajectory with --out and render it elsewhere")
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
    return 0


def cmd_train(args):
    refused = {"--distributed": args.distributed or None, "--coordinator": args.coordinator,
               "--num-processes": args.num_processes, "--process-id": args.process_id}
    for flag, value in refused.items():
        if value is not None:
            raise SystemExit(f"{flag}: multi-process training is not ported yet "
                             "(the port trains on one card)")
    _require_device(args.device)

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
    env = MimicVecEnv(humanoid_model(), load_clip(args.clip, device=args.device), env_cfg,
                      backend=args.backend, device=args.device)
    cfg = TrainConfig(num_envs=args.num_envs, unroll_length=args.unroll_length,
                      total_env_steps=args.total_steps, learning_rate=args.lr,
                      gamma=args.gamma, seed=args.seed)
    cfg = _overrides(cfg, args.train_set, "--train-set", int)

    def progress(it, entry):
        print(json.dumps({"iteration": it, **{k: round(v, 5) if isinstance(v, float) else v
                                             for k, v in entry.items()}}), flush=True)

    _, history = train(env, cfg, progress_fn=progress if args.verbose else None,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=args.checkpoint_every, device=args.device)
    print(json.dumps({"final": history[-1] if history else {}}))
    return 0


def cmd_eval(args):
    import torch

    from pbrl_tpu_torch.envs import MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model
    from pbrl_tpu_torch.train import checkpoint, evaluate

    _require_device(args.device)
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
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    normalize = (run.get("train_config") or {}).get("normalize_obs", True)
    metrics = evaluate(env, policy, stats, num_envs=args.num_envs, num_steps=args.steps,
                       generator=gen, normalize_obs=normalize)
    print(json.dumps({k: float(v) for k, v in metrics.items()}))
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
    sp.add_argument("--video", default="", help="refused: rendering needs MuJoCo")
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
    sp.add_argument("--distributed", action="store_true")
    sp.add_argument("--coordinator", default=None)
    sp.add_argument("--num-processes", type=int, default=None)
    sp.add_argument("--process-id", type=int, default=None)
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.set_defaults(fn=cmd_train)

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
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
