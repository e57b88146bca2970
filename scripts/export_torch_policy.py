"""Export pbrl_tpu checkpoints for the PyTorch port.

Restores the latest Orbax checkpoint of each given run directory with the
JAX stack (the only place outside the tests where the port's data touches
``jax``/``orbax``) and writes ``.npz`` files that
``pbrl_tpu_torch.train.checkpoint`` reads with numpy alone, named after the
run configuration's clip (``ckpts/getup`` holds ``getup_facedown``):

* ``<clip>_policy.npz`` (``load_policy``): the policy params in float32
  under flax's names, the clamped ``log_std``, the observation statistics
  and the run configuration; all that evaluation needs.
* with ``--train-state``, ``<clip>_train_state.npz``
  (``import_train_state``): the rest of the learner state, so that a
  fine-tune resumes as pbrl_tpu's resume would: the value params, the
  unclamped ``log_std``, Adam's count, mu and nu of both nets, the
  observation statistics, ``env_steps``, the checkpoint's step and the run
  configuration.

The bundled files are regenerated with

    JAX_PLATFORMS=cpu python scripts/export_torch_policy.py --train-state \
        ckpts/walk ckpts/backflip
    JAX_PLATFORMS=cpu python scripts/export_torch_policy.py \
        ckpts/getup ckpts/getup_faceup ckpts/kick ckpts/punch ckpts/jump
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _save(path, arrays):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    return {"out": path, "bytes": os.path.getsize(path),
            "arrays": {k: list(v.shape) for k, v in arrays.items()}}


def export(checkpoint_dir, out_dir, train_state):
    """Write ``<clip>_policy.npz`` (and ``<clip>_train_state.npz``) for the
    latest checkpoint of ``checkpoint_dir``; returns one report per file."""
    from pbrl_tpu.train import checkpoint
    from pbrl_tpu.train.networks import PolicyNetwork

    step = checkpoint.latest_step(checkpoint_dir)
    payload = checkpoint.restore(checkpoint_dir, step)
    run_config = checkpoint.load_run_config(checkpoint_dir)
    clip = run_config["clip"]
    run = json.dumps(run_config)
    stats = {f"obs_stats/{k}": np.asarray(payload["obs_stats"][k], np.float32)
             for k in ("count", "mean", "m2")}

    policy = flatten(payload["params"]["policy"]["params"])
    raw_log_std = policy["log_std"]
    lo, hi = PolicyNetwork.min_log_std, PolicyNetwork.max_log_std
    policy["log_std"] = np.clip(raw_log_std, lo, hi).astype(np.float32)
    arrays = {f"policy/{k}": v for k, v in policy.items()}
    arrays.update(stats)
    arrays["run_config"] = np.asarray(run)
    reports = [_save(os.path.join(out_dir, f"{clip}_policy.npz"), arrays)]
    if not train_state:
        return reports

    # optax.chain(clip_by_global_norm, adam(schedule)): (EmptyState,
    # (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count)))
    adam, sched = payload["opt_state"][1]
    if int(adam["count"]) != int(sched["count"]):
        raise ValueError("the Adam and schedule counts differ")
    train = {f"value/{k}": v for k, v in flatten(payload["params"]["value"]["params"]).items()}
    train["policy/log_std"] = raw_log_std
    train["opt/count"] = np.asarray(adam["count"], np.int64)
    for which in ("mu", "nu"):
        for net in ("policy", "value"):
            for k, v in flatten(adam[which][net]["params"]).items():
                train[f"opt/{which}/{net}/{k}"] = v
    train.update(stats)
    train["env_steps"] = np.asarray(payload["env_steps"], np.int64)
    train["step"] = np.asarray(step, np.int64)
    train["run_config"] = np.asarray(run)
    reports.append(_save(os.path.join(out_dir, f"{clip}_train_state.npz"), train))
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint_dirs", nargs="*", default=["ckpts/walk"],
                    help="pbrl_tpu run directories (run_config.json + Orbax steps)")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "pbrl_tpu_torch", "assets"))
    ap.add_argument("--train-state", action="store_true",
                    help="also write each run's learner state")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    reports = [r for d in args.checkpoint_dirs
               for r in export(d, args.out_dir, args.train_state)]
    print(json.dumps(reports))
    return 0


if __name__ == "__main__":
    sys.exit(main())
