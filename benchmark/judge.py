"""The numbers that decide ``correct``: gaps between what the program (or,
for the control, the lower-precision reference) produced and what the
plain reference gives for the same inputs.

Every number is a gap that reads 0 for identical outputs; ``correct`` holds
when each is at or under its limit, and the limits live in the cell's
workload file beside the readings they were set from.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.clip import phase


def split(rec: torch.Tensor, widths):
    """A sampled record's (N, K) columns as {(side, field): (N, w)}."""
    out, off = {}, 0
    for side, field, w in widths:
        out[(side, field)] = rec[:, off:off + w]
        off += w
    return out


def abs_gap(got, ref) -> float:
    """Largest absolute difference."""
    return float(torch.max(torch.abs(got.double() - ref.double()))) if got.numel() else 0.0


def rel_gap(got, ref) -> float:
    """Largest difference against 1 + |reference| (absolute near 0,
    relative for large entries such as velocities)."""
    return float(torch.max(pair_rel_gap(got, ref))) if got.numel() else 0.0


def pair_rel_gap(got, ref):
    """Each row's largest difference against 1 + |reference|."""
    g, r = got.double().reshape(got.shape[0], -1), ref.double().reshape(ref.shape[0], -1)
    return torch.max(torch.abs(g - r) / (1.0 + torch.abs(r)), dim=1).values


def p90(per_pair) -> float:
    """The 90th percentile over the sampled pairs. A step from a state at
    a contact's onset can switch the contact in one program and not in the
    other on a rounding difference, so the widest gap of a few hundred
    pairs swings from seed to seed; the 90th percentile does not."""
    return float(torch.quantile(per_pair.double().cpu(), 0.9)) if per_pair.numel() else 0.0


def flips(got, ref) -> float:
    """How many 0/1 flags differ."""
    return float(torch.sum((got > 0.5) != (ref > 0.5)))


def step_numbers(inp: dict, action, out: dict, ref_obs_in, ref_action, ref_out: dict) -> dict:
    """The per-step gaps of sampled (step, env) pairs: the input obs
    against the reference's obs of the same state and the step's outputs
    against the reference's step from the same state (each the 90th
    percentile over pairs of a pair's largest gap), and the action (the
    largest gap: the networks are not chaotic)."""
    obs = torch.maximum(pair_rel_gap(inp["obs"], ref_obs_in), pair_rel_gap(out["obs"], ref_out["obs"]))
    return {
        "obs_gap_p90": p90(obs),
        "action_gap": abs_gap(action, ref_action),
        "qpos_gap_p90": p90(torch.max(torch.abs(out["qpos"].double() - ref_out["qpos"].double()),
                                      dim=1).values),
        "qvel_gap_p90": p90(pair_rel_gap(out["qvel"], ref_out["qvel"])),
        "reward_gap_p90": p90(torch.abs(out["reward"].reshape(-1).double()
                                        - ref_out["reward"].double())),
        "qvel_gap_max": rel_gap(out["qvel"], ref_out["qvel"]),
        "done_flips": flips(out["done"].reshape(-1), ref_out["done"]),
    }


def leaf_gap(got: dict, ref: dict) -> tuple:
    """The worst leaf's gap of norms, ``|‖got‖ - ‖ref‖|`` over the larger of
    ``‖ref‖`` and the median leaf's ``‖ref‖``; leaves whose reference norm
    is under a thousandth of the median's are left out (round-off moves
    them). Returns (gap, the worst leaf's name, the leaves left out)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    worst, name, skipped = 0.0, "", []
    for k, r in norms.items():
        if r < 1e-3 * med:
            skipped.append(k)
            continue
        g = float(torch.linalg.vector_norm(got[k].double()))
        gap = abs(g - r) / max(r, med)
        if gap >= worst:
            worst, name = gap, k
    return worst, name, skipped


def reset_numbers(env, first, transitions, low: bool = False) -> dict:
    """The env's resets against what a reset has to give, by the
    configuration of the reference ``env``.

    ``first`` is a batch of fresh starts (the train state's first reset);
    each of ``transitions`` is (pre, post): the states a policy step left
    and ``auto_reset`` made of them. An env that is not done comes through
    unchanged. A done env restarts fresh: its episode starting at its time,
    which lies in the clip's start range; in the clip's reference state at
    that time apart from the root's x and y, which lie within
    ``rsi_noise_root_xy`` of the clip's. Or, with ``curriculum_reset_prob``
    p > 0, it restarts in the state of an env that was alive in the
    curriculum's phase window (matched by time and velocity, which a fresh
    start shares with no live env), its root x, y moved to the clip's when
    the configuration recentres, its episode starting at that time.

    Returns ``reset_wrong``, the envs that break one of these rules;
    ``start_gap``, the largest gap of a restart's state and observation
    to the reference's (with ``low``, the control: the reference's own
    start looked up in bfloat16 in the program's place); and, where p > 0,
    the count of curriculum restarts among the done envs that had an env to
    copy (``curriculum_restarts`` of ``curriculum_candidates``) and
    ``curriculum_tail``, -log10 of that count's two-sided tail probability
    under Binomial(candidates, p)."""
    c, clip = env.c, env.clip
    p, window, noise = c["curriculum_reset_prob"], c["curriculum_phase_window"], c["rsi_noise_root_xy"]
    hi = float(clip.cycle_time) * (1.0 if clip.loop else 0.9) if c["reference_state_init"] else 0.0
    out = {"reset_wrong": 0.0, "start_gap": 0.0}

    def gap(q, v, obs, rq, rv, t):
        """The restart's (q, v, obs) against the reference (rq, rv) at times t."""
        if low:
            q, v = env.start(t, low=True)
            q = torch.cat([rq[:, :2], q[:, 2:]], 1)
            obs = env.obs(q, v, t)
        g = max(abs_gap(q, rq), rel_gap(v, rv), rel_gap(obs, env.obs(rq, rv, t)))
        out["start_gap"] = max(out["start_gap"], g)

    def fresh(s, rows):
        t, q = s.time[rows], s.qpos[rows]
        rq, rv = env.start(t)
        dxy = torch.max(torch.abs(q[:, :2] - rq[:, :2]), 1).values
        bad = (s.episode_start[rows] != t) | (t < 0) | (t > hi * (1 + 1e-6))
        bad |= dxy > noise * (1 + 1e-6) + 1e-5
        out["reset_wrong"] += float(bad.sum())
        gap(q, s.qvel[rows], s.obs[rows], torch.cat([q[:, :2], rq[:, 2:]], 1), rv, t)

    fresh(first, torch.arange(first.time.shape[0], device=first.time.device))
    n = k = 0
    for pre, post in transitions:
        done = pre.done > 0.5
        same = ((post.qpos == pre.qpos).all(1) & (post.qvel == pre.qvel).all(1)
                & (post.time == pre.time) & (post.episode_start == pre.episode_start)
                & (post.obs == pre.obs).all(1))
        out["reset_wrong"] += float((~done & ~same).sum())
        rows = torch.nonzero(done)[:, 0]
        if rows.numel() == 0:
            continue
        ok = ~done
        if window:
            ph = phase(clip, pre.time)
            ok &= (ph >= window[0]) & (ph <= window[1])
        peers = torch.nonzero(ok)[:, 0]
        copied = torch.zeros_like(rows, dtype=torch.bool)
        if peers.numel():
            match = ((post.time[rows][:, None] == pre.time[peers][None])
                     & (post.qvel[rows][:, None] == pre.qvel[peers][None]).all(-1))
            copied = match.any(1)
            n, k = n + rows.numel(), k + int(copied.sum())
            d, j = rows[copied], peers[match.to(torch.float32).argmax(1)][copied]
            if d.numel():
                t, q = post.time[d], post.qpos[d]
                bad = (post.episode_start[d] != t) | (q[:, 2:] != pre.qpos[j, 2:]).any(1)
                if p == 0:
                    bad |= True
                rq, _ = env.start(t)
                xy = rq[:, :2] if c["curriculum_recenter_xy"] else pre.qpos[j, :2]
                bad |= torch.max(torch.abs(q[:, :2] - xy), 1).values > 1e-5
                out["reset_wrong"] += float(bad.sum())
                ref_q = torch.cat([xy, pre.qpos[j, 2:]], 1)
                g = max(abs_gap(q, ref_q), rel_gap(post.obs[d], env.obs(ref_q, pre.qvel[j], t)))
                out["start_gap"] = max(out["start_gap"], 0.0 if low else g)
        fresh(post, rows[~copied])
    if p > 0:
        out.update(curriculum_restarts=float(k), curriculum_candidates=float(n),
                   curriculum_tail=binomial_tail(k, n, p))
    return out


def binomial_tail(k: int, n: int, p: float) -> float:
    """-log10 of the probability, under Binomial(n, p), of a count at
    least as far out as ``k`` on its side, doubled (two-sided); 0 at most."""
    if n == 0:
        return 0.0
    log_pmf = [math.lgamma(n + 1) - math.lgamma(i + 1) - math.lgamma(n - i + 1)
               + i * math.log(p) + (n - i) * math.log1p(-p) for i in range(n + 1)]
    low = sum(math.exp(x) for x in log_pmf[:k + 1])
    high = sum(math.exp(x) for x in log_pmf[k:])
    return max(0.0, -math.log10(min(1.0, 2.0 * min(low, high))))


def verdict(numbers: dict, limits: dict) -> bool:
    """Correct when every limited number is present and at or under its limit."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())


def report(numbers: dict, limits: dict) -> dict:
    """{name: {"value": ..., "limit": ...}} of the numbers that have a limit."""
    return {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
