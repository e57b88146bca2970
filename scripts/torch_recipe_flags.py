"""Rebuild a run's training-recipe flags from the ``run_config.json`` in its
checkpoint directory, for the PyTorch port's command line.

The counterpart of ``scripts/recipe_flags.py``: one line of ``--env-set
k=v`` / ``--train-set k=v`` overrides, one for every field of the port's
``EnvConfig`` and ``TrainConfig`` that the stored run sets to other than
the default. The port's ``cli train`` applies the override lists last, so
appending this line to a ``train`` command reproduces the stored recipe
whatever the explicit flags' defaults:

    FLAGS=$(python scripts/torch_recipe_flags.py ckpts/backflip)
    python -m pbrl_tpu_torch.cli train --clip backflip $FLAGS --total-steps 500000000

Bools print as 1/0 and tuples comma-separated, as ``--env-set`` parses
them. The fields a campaign sets explicitly (SKIP_TRAIN) are left out. It
reads files only, on any machine.
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SKIP_TRAIN = {"num_envs", "total_env_steps", "learning_rate", "seed",
              "hidden", "checkpoint_every"}


def _fmt(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v)
    return str(v)


def recipe_flags(run_dir: str) -> str:
    """The override line of the run stored in ``run_dir``."""
    from pbrl_tpu_torch.envs import EnvConfig
    from pbrl_tpu_torch.train import TrainConfig, checkpoint

    run = checkpoint.load_run_config(run_dir)
    out = []
    for cls, key, flag, skip in ((EnvConfig, "env_config", "--env-set", set()),
                                 (TrainConfig, "train_config", "--train-set", SKIP_TRAIN)):
        defaults = cls()
        stored = run.get(key, {})
        for f in dataclasses.fields(cls):
            if f.name in skip or f.name not in stored:
                continue
            cur, ref = stored[f.name], getattr(defaults, f.name)
            if isinstance(ref, tuple):
                ref = list(ref)
            if cur != ref:
                out.append(f"{flag} {f.name}={_fmt(cur)}")
    return " ".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python scripts/torch_recipe_flags.py RUN_DIR", file=sys.stderr)
        return 2
    print(recipe_flags(argv[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
