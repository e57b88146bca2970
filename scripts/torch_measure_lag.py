"""Measure the temporal lag of a rolled-out policy against its reference
clip, on the PyTorch port.

The counterpart of ``scripts/measure_lag.py``. It reads the trajectory
that ``python -m pbrl_tpu_torch.cli rollout --out`` writes (``qpos`` and
``fps``), looks the clip's reference up at the trajectory's frame times on
``--device`` (the card by default), and scans the lag in policy steps
(fractional, by linear interpolation; -3 to 6 in steps of 0.25): for each
lag L, the mean squared error of the actuated joints between ``qpos[t]``
and ``reference(t - L)``. A positive best lag means the policy runs late.
It prints one JSON line:

    python scripts/torch_measure_lag.py artifacts/backflip.npz backflip
    python scripts/torch_measure_lag.py --device cpu artifacts/backflip.npz backflip
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAGS = np.arange(-3.0, 6.01, 0.25)


def lag_sse(qpos: np.ndarray, ref: np.ndarray, lag: float) -> float:
    """MSE between qpos[t] and ref[t - lag] (linear interp, valid window)."""
    T = qpos.shape[0]
    ts = np.arange(T)
    src = ts - lag
    ok = (src >= 0) & (src <= T - 1)
    i0 = np.clip(np.floor(src[ok]).astype(int), 0, T - 2)
    w = src[ok] - i0
    ref_i = (1 - w)[:, None] * ref[i0] + w[:, None] * ref[i0 + 1]
    return float(np.mean((qpos[ok] - ref_i) ** 2))


def measure_lag(npz: str, clip_name: str, device="cuda") -> dict:
    import torch

    from pbrl_tpu_torch.mocap import load_clip, reference_state

    d = np.load(npz)
    q = np.asarray(d["qpos"])
    dt = 1.0 / float(d["fps"])
    T = q.shape[0]
    clip = load_clip(clip_name, device=device)
    t = torch.as_tensor(np.arange(T) * dt, dtype=torch.float32, device=device)
    ref = reference_state(clip, t)[0].cpu().numpy()

    joints = slice(7, q.shape[1])  # actuated joints; root excluded
    sses = [lag_sse(q[:, joints], ref[:, joints], lag) for lag in LAGS]
    best = float(LAGS[int(np.argmin(sses))])
    return {
        "npz": npz, "clip": clip_name, "steps": T,
        "best_lag_steps": best, "best_lag_ms": best * dt * 1000,
        "sse_at_zero": sses[int(np.argmin(np.abs(LAGS)))],
        "sse_at_best": min(sses),
        "lags_steps": LAGS.tolist(), "sse": [round(s, 5) for s in sses],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("npz", help="a trajectory written by cli rollout --out")
    ap.add_argument("clip", help="the shipped clip (or clip file) it imitates")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from pbrl_tpu_torch.cli import _require_device

    _require_device(args.device)
    print(json.dumps(measure_lag(args.npz, args.clip, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
