"""Settings of the benchmark's own tests: the ``gpu`` marker, and cells cut
to a size the CPU runs in seconds (2 substeps a policy step, 4 envs)."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def tiny(cell: dict, conf: dict):
    """A copy of a cell and its configuration at 4 envs and a 4 ms policy
    step; in training, episodes of 6 ms, so that every rollout resets."""
    conf = json.loads(json.dumps(conf))
    conf["env_config"]["policy_dt"] = 0.004
    cell = dict(cell, num_envs=4)
    if cell["mode"] == "train":
        conf["env_config"]["max_episode_time"] = 0.006
        cell["train_set"] = {"num_envs": 4, "unroll_length": 2, "num_minibatches": 2,
                             "update_epochs": 1}
    else:
        cell["episode_steps"] = 3
    return cell, conf


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python -m pytest -m gpu benchmark/tests)")
    return torch.device("cuda")
