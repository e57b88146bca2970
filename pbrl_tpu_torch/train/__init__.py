"""Training: networks, obs normalisation, the optimiser, PPO, analytic
policy gradients (APG), evaluation and checkpoints."""

from pbrl_tpu_torch.train import checkpoint, networks, optim, ppo, running_stats  # noqa: F401
from pbrl_tpu_torch.train.ppo import (  # noqa: F401
    TrainConfig,
    TrainState,
    Transition,
    compute_gae,
    evaluate,
    make_train_functions,
    train,
)
from pbrl_tpu_torch.train import apg  # noqa: F401
from pbrl_tpu_torch.train.apg import APGConfig, make_apg_functions  # noqa: F401
from pbrl_tpu_torch.train.apg import train as train_apg  # noqa: F401

# APG trains on PPO's state (the same fields, checkpointed alike); pbrl_tpu
# names its own ``APGTrainState``.
APGTrainState = TrainState
