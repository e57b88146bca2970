"""``examples/quickstart_torch.py``, sections 4 and 5 on the CPU in a
subprocess: 2 envs of ``MimicVecEnv`` stepped once (the policy-step
kernel's plain version on the CPU), then a one-iteration PPO burst
through ``make_train_functions`` (2 envs x 8 steps) and its ``evaluate``
over 4 steps, every printed number finite; the section list is checked.
Sections 1-3 are ``tests/test_torch_tour.py``'s."""

import math
import re

import pytest

from tests.test_torch_tour import run_tour


def test_tour_env_and_ppo_burst():
    text = run_tour("--sections", "4,5", "--num-envs", "2", "--train-steps", "16")
    assert "backend: kernel (its plain version on the CPU)" in text
    r = float(re.search(r"2 envs stepped; mean reward (\S+)", text).group(1))
    m = re.search(r"16 env steps: reward (\S+) -> (\S+) at (\S+) steps/s", text)
    e = re.search(r"eval over 4 steps: reward (\S+), length (\S+)", text)
    assert m and e, text
    values = [r, *map(float, m.groups()), *map(float, e.groups())]
    assert all(math.isfinite(v) for v in values), values
    assert 0.0 < r <= 1.0 and float(e.group(2)) <= 4.0
    assert "=== 1." not in text


def test_tour_sections_checked():
    with pytest.raises(AssertionError, match="5 needs 4"):
        run_tour("--sections", "5")
