"""``cli train --distributed`` of the port: two ranks on the CPU (gloo).

Two processes of ``python -m pbrl_tpu_torch.cli train --clip walk
--distributed --device cpu`` split 4 envs x 4 steps (2 iterations) and a
third runs the same total batch alone, each with a timeout. The ranks
name their backend in their first line and print the same final line;
only rank 0 prints progress and writes the run config and checkpoints,
whose ``env_steps`` counts the whole batch; and their metrics and params
are within 1e-5 of the one process's (the two ranks' policy GEMMs round at
2 rows where the one process's run at 4). Ranks given different checkpoint
directories refuse to resume from different steps.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from pbrl_tpu_torch.train import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["train", "--clip", "walk", "--device", "cpu", "--num-envs", "4", "--unroll-length", "4",
        "--total-steps", "32", "--train-set", "hidden=32,32", "--env-set", "policy_dt=0.004"]
TIMEOUT_S = 300
TIMES = ("sps", "rollout_s", "learn_s")


def _lines(text):
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


def _ranks(dirs):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return [[*TINY, "--distributed", "--coordinator", f"localhost:{port}", "--num-processes",
             str(len(dirs)), "--process-id", str(r), "--checkpoint-dir", d]
            for r, d in enumerate(dirs)]


def _run(argvs):
    """Run the command lines side by side: [(returncode, stdout, stderr)]."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-m", "pbrl_tpu_torch.cli", *a], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def test_two_ranks_train_as_one_process(tmp_path):
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    outs = _run([*_ranks(dirs), [*TINY, "--checkpoint-dir", str(tmp_path / "one")]])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    rank0, rank1, one = (_lines(out) for _, out, _ in outs)

    assert rank0[0] == rank1[0] == {"distributed": {"backend": "gloo", "world": 2}}
    assert [ln["iteration"] for ln in rank0[1:-1]] == [0, 1]   # progress on rank 0 only
    assert len(rank1) == 2
    assert outs[0][1].splitlines()[-1] == outs[1][1].splitlines()[-1]  # the same final line
    final = rank0[-1]["final"]
    assert final["env_steps"] == 32 and all(np.isfinite(v) for v in final.values())

    # only rank 0 writes; its checkpoint counts the whole batch's steps
    assert not os.path.exists(dirs[1])
    assert checkpoint.latest_step(dirs[0]) == 2
    assert os.path.exists(os.path.join(dirs[0], "run_config.json"))
    dp = checkpoint.restore(dirs[0])
    sp = checkpoint.restore(str(tmp_path / "one"))
    assert dp["env_steps"] == sp["env_steps"] == 32

    # the same training as one process of the whole batch
    assert "distributed" not in one[0]
    for want, got in ((one[0], rank0[1]), (one[-1]["final"], final)):
        assert set(want) == set(got)
        for k in set(want) - set(TIMES):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for net in ("policy", "value"):
        for k, v in sp[net].items():
            torch.testing.assert_close(dp[net][k], v, rtol=0, atol=1e-5, msg=f"{net}.{k}")
    assert dp["opt"]["count"] == sp["opt"]["count"]

    # a resume needs one checkpoint directory for all ranks: rank 0's holds
    # step 2, rank 1's none, and both stop rather than drift apart
    for rc, _, err in _run(_ranks(dirs)):
        assert rc != 0 and "different checkpoints" in err, err[-3000:]
    assert checkpoint.latest_step(dirs[0]) == 2 and not os.path.exists(dirs[1])
