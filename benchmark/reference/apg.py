"""APG's window in plain PyTorch: the loss of a window of policy steps from
a given entry state, its policy gradient by autograd through the reference
env, and the update.

From an entry state, a standard-normal noise draw of the window and the
policy's parameters, the window runs ``horizon`` steps of
:class:`~benchmark.reference.env.RefEnv` with the action
``policy_mean(normalize(obs)) + action_noise * noise[t]`` and gives

    L = -E_b[sum_t gamma^t r_t alive_t + gamma^H V(s_H) alive_H] / H,

where ``alive_t`` is 1 until the step at which the env is done (that step's
reward counts, the later ones are masked) and ``done`` carries no
gradient; the critic is frozen (a differentiable input, no gradient to its
weights). The update is optax's ``chain(zero_nans(),
clip_by_global_norm(max_grad_norm), adam(linear_schedule(lr, lr / 100,
num_iterations)))``, the rate read at Adam's count before the update.

Departures from the port's arithmetic (``pbrl_tpu_torch/train/apg.py`` over
``MimicVecEnv`` on the einsum engine):

* the physics is the frozen field program (``field_physics.py``, the
  policy-step kernel's plain version, one tensor op per scalar op), not the
  einsum engine the port differentiates: the same equations in another
  order of operations, so their values and derivatives part by rounding,
  and by more where a step's rounding switches a contact on or off;
* ``angle_between``'s gradient is the port's own rule (the derivative of
  ``acos`` clamped at ``|d| = 1 - 1e-6``), written in plain torch in
  ``quaternion.py``;
* the whole window is held for the backward, where the port recomputes
  each step inside it (``torch.utils.checkpoint``): the same values;
* the entry observation is rebuilt from the entry state (the port takes the
  one its reset made; ``start_gap`` holds the two together);
* matmuls in float32 with TF32 off (the caller's switch; the control turns
  it on).

Nothing here imports ``pbrl_tpu_torch`` or JAX.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference.learner import B1, B2, EPS, _leaves


def load_critic(train_state: str, device):
    """(value params ``value/torso...``, obs statistics [count, mean, m2])
    of an exported learner state: what an APG fine-tune holds frozen."""
    with np.load(train_state) as z:
        arrays = {k: z[k] for k in z.files}
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=torch.device(device)).clone()
    value = {f"value/{k}": t(v) for k, v in _leaves(arrays, "value/").items()}
    stats = [t(arrays[f"obs_stats/{k}"]) for k in ("count", "mean", "m2")]
    return value, stats


def tf32(x):
    """``x`` rounded to TF32's 10 mantissa bits (to nearest, ties away),
    the precision the card's TF32 matmuls take their float32 operands in;
    the gradient passes straight through. On the CPU this stands in for the
    control's TF32 matmuls."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x).detach()


def mlp(params: dict, net: str, x, low: bool = False):
    """A swish MLP of leaves ``<net>/torso.hidden_<i>.weight`` (out, in)
    and ``.bias``, then ``<net>/torso.out``; with ``low``, each matmul's
    operands rounded to TF32."""
    r = tf32 if low else (lambda y: y)
    i = 0
    while f"{net}/torso.hidden_{i}.weight" in params:
        x = torch.nn.functional.silu(r(x) @ r(params[f"{net}/torso.hidden_{i}.weight"]).t()
                                     + params[f"{net}/torso.hidden_{i}.bias"])
        i += 1
    return r(x) @ r(params[f"{net}/torso.out.weight"]).t() + params[f"{net}/torso.out.bias"]


def normalize(stats, obs):
    count, mean, m2 = stats
    std = torch.sqrt(torch.clamp(m2 / torch.clamp(count, min=2.0), min=1e-6))
    return torch.clamp((obs - mean) / std, -10.0, 10.0)


def action(params: dict, stats, obs, noise, cfg: dict, low: bool = False):
    """The window's action of each row: the policy mean plus the noise."""
    mean = mlp(params, "policy", normalize(stats, obs) if cfg["normalize_obs"] else obs, low)
    return mean + cfg["action_noise"] * noise if cfg["action_noise"] > 0 else mean


def value_tail(value: dict, stats, obs, cfg: dict, low: bool = False):
    """The frozen critic at the window's last observation."""
    return mlp(value, "value", normalize(stats, obs) if cfg["normalize_obs"] else obs, low)[..., 0]


def window_loss(env, params: dict, value: dict, stats, entry: dict, noise, cfg: dict,
                follow=None):
    """The loss of one window from ``entry`` (``qpos``, ``qvel``, ``time``,
    ``episode_start`` of each env) with ``noise`` (horizon, B, nu), with
    the graph to ``params``.

    With ``follow``, the (qpos, qvel) another program reached after each
    step, each step after the first starts from that state: its value is
    the followed one, its derivative the reference's own step before it
    (``follow + (x - x.detach())``), and its observation is rebuilt from
    it. The window then takes the reference's derivatives along the other
    program's path, which the float32 rounding of the two cannot part over
    the window's steps the way two free paths of a contact-rich motion
    part."""
    q, v = entry["qpos"], entry["qvel"]
    t, start = entry["time"], entry["episode_start"]
    obs = env.obs(q, v, t)
    B = q.shape[0]
    alive = torch.ones(B, device=q.device)
    acc = torch.zeros(B, device=q.device)
    disc = 1.0
    for k in range(cfg["horizon"]):
        a = action(params, stats, obs, noise[k], cfg)
        out = env.step(q, v, t, start, a)
        acc = acc + disc * alive * out["reward"]
        alive = alive * (1.0 - out["done"].detach())
        disc *= cfg["gamma"]
        q, v, obs = out["qpos"], out["qvel"], out["obs"]
        t = t + env.n_substeps * env.c["physics_dt"]
        if follow is not None:
            fq, fv = follow[k]
            q, v = fq + (q - q.detach()), fv + (v - v.detach())
            obs = env.obs(q, v, t)
    ret = acc
    if cfg["value_bootstrap"]:
        ret = ret + cfg["gamma"] ** cfg["horizon"] * alive * value_tail(value, stats, obs, cfg)
    return -torch.mean(ret) / cfg["horizon"]


def loss_and_grad(env, params: dict, value: dict, stats, entry: dict, noise, cfg: dict,
                  follow=None):
    """(loss, {leaf: gradient}) of the window (:func:`window_loss`); the
    gradient of a leaf the loss does not reach (the log-std) is zero."""
    leaves = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
    loss = window_loss(env, leaves, value, stats, entry, noise, cfg, follow)
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(leaves[k]) if g is None else g
                                  for k, g in zip(names, grads)}


def learning_rate(cfg: dict, count: int) -> float:
    """The rate at Adam's ``count``: linear from ``learning_rate`` to 1% of
    it over the run's iterations (float32, as optax's schedule)."""
    lr = cfg["learning_rate"]
    total = max(1, cfg["total_env_steps"] // (cfg["num_envs"] * cfg["horizon"]))
    if not cfg["lr_decay"]:
        return lr
    c = np.float32(min(max(count, 0), total))
    frac = np.float32(1.0) - c / np.float32(total)
    return float(np.float32(lr - lr * 0.01) * frac + np.float32(lr * 0.01))


@torch.no_grad()
def update(params: dict, grads: dict, mu: dict, nu: dict, count: int, cfg: dict):
    """The params after one update from ``grads`` and Adam's state before
    it; returns (params, mu, nu, count), new tensors."""
    g = {k: torch.where(torch.isnan(x), 0.0, x) for k, x in grads.items()}
    norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
    if norm >= cfg["max_grad_norm"]:
        g = {k: x / norm * cfg["max_grad_norm"] for k, x in g.items()}
    lr = learning_rate(cfg, count)
    count += 1
    bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
    mu = {k: B1 * mu[k] + (1.0 - B1) * g[k] for k in params}
    nu = {k: B2 * nu[k] + (1.0 - B2) * g[k] ** 2 for k in params}
    new = {k: params[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS) for k in params}
    return new, mu, nu, count


# -- the followed window, one process per block of steps ----------------------
#
# Along a followed path every step starts from a known state, so the
# steps' forwards are independent: each worker process builds the graphs of
# its block of steps at once, and only the backward's chain runs in turn,
# last step first, each step's derivative of its input state handed to the
# step before it. The reference's physics issues one tensor op per scalar
# op, so a step costs the CPU the same few seconds for 64 envs or 2048:
# the blocks overlap where the envs could not.


def _step_inputs(entry, follow, cfg, n_substeps, physics_dt):
    """(qpos, qvel, time) each step of the window starts from."""
    q, v, t = [entry["qpos"]], [entry["qvel"]], [entry["time"]]
    for k in range(cfg["horizon"] - 1):
        q.append(follow[k][0])
        v.append(follow[k][1])
        t.append(t[-1] + n_substeps * physics_dt)
    return q, v, t


def _arrays(x):
    """Tensors (in nested dicts, lists and tuples) as numpy arrays, and back:
    what crosses between processes goes by value."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: _arrays(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_arrays(v) for v in x)
    return x


def _worker(clip, env_config, cfg, steps, inbox, outbox):
    """One worker of :class:`FollowedWindows`: for each window sent, the
    forward of its ``steps``, then each step's backward when asked (the
    cotangent of its output state in, its input state's out), then the
    gradient of the params."""
    torch.set_num_threads(1)
    from benchmark.reference.env import RefEnv

    env = RefEnv(clip, env_config, "cpu")
    while True:
        msg = inbox.get()
        if msg[0] == "stop":
            return
        _, low, inputs = msg
        inputs = _arrays(inputs)
        params = {k: p.clone().requires_grad_(True) for k, p in inputs["params"].items()}
        kept = {}
        for k in steps:
            q = inputs["q"][k].clone().requires_grad_(True)
            v = inputs["v"][k].clone().requires_grad_(True)
            obs = env.obs(q, v, inputs["t"][k])
            a = action(params, inputs["stats"], obs, inputs["noise"][k], cfg, low)
            out = env.step(q, v, inputs["t"][k], inputs["start"], a)
            kept[k] = (q, v, out)
            outbox.put(_arrays(("forward", k, out["reward"], out["done"])))
        while True:
            msg = _arrays(inbox.get())
            if msg[0] == "grads":
                outbox.put(_arrays(("grads", {n: torch.zeros_like(p) if p.grad is None
                                              else p.grad for n, p in params.items()})))
                break
            _, k, weight, lam_q, lam_v = msg
            q, v, out = kept.pop(k)
            torch.autograd.backward([torch.sum(weight * out["reward"]), out["qpos"],
                                     out["qvel"]], [None, lam_q, lam_v])
            outbox.put(_arrays(("backward", k, q.grad, v.grad)))


class FollowedWindows:
    """:func:`window_loss` with ``follow`` on the CPU, its steps in
    ``workers`` processes (started at once, so that their imports and set-up
    overlap the caller's other work, and kept for later windows until
    :meth:`close`). :meth:`start` sends a window, whose forwards then run
    while the caller goes on; :meth:`finish` runs the backward's chain and
    returns (loss, {leaf: gradient}): the sequential window's, up to the
    order in which each leaf's gradient is summed, and leaves the seconds it
    waited for the forwards and took for the chain in ``seconds``. With
    ``low``, the matmuls' operands are rounded to TF32 (the control)."""

    def __init__(self, clip: str, env_config: dict, cfg: dict, workers: int):
        import multiprocessing as mp

        from benchmark.reference.env import RefEnv

        self.clip, self.env_config, self.cfg = clip, env_config, cfg
        self.env = RefEnv(clip, env_config, "cpu")
        H = cfg["horizon"]
        W = max(1, min(workers, H))
        self.blocks = [list(range(H))[w::W] for w in range(W)]
        self.owner = {k: w for w, ks in enumerate(self.blocks) for k in ks}
        ctx = mp.get_context("spawn")
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(W)]
        self.procs = [ctx.Process(target=_worker, args=(clip, env_config, cfg, ks,
                                                        self.inboxes[w], self.outbox),
                                  daemon=True) for w, ks in enumerate(self.blocks)]
        for p in self.procs:
            p.start()
        self.pending = None
        self.seconds = {}

    def _receive(self, kind):
        import queue

        while True:
            try:
                msg = self.outbox.get(timeout=5)
                break
            except queue.Empty:
                dead = [p.exitcode for p in self.procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a reference worker exited with code {dead[0]}")
        if msg[0] != kind:
            raise RuntimeError(f"reference worker sent {msg[0]!r}, expected {kind!r}")
        return _arrays(msg[1:])

    def start(self, params: dict, value: dict, stats, entry: dict, noise, follow,
              low: bool = False):
        cpu = lambda x: x.detach().to("cpu")
        entry = {k: cpu(x) for k, x in entry.items()}
        follow = [(cpu(q), cpu(v)) for q, v in follow]
        env, cfg = self.env, self.cfg
        q, v, t = _step_inputs(entry, follow, cfg, env.n_substeps, env.c["physics_dt"])
        inputs = {"params": {k: cpu(p) for k, p in params.items()},
                  "stats": [cpu(x) for x in stats], "noise": cpu(noise), "q": q, "v": v,
                  "t": t, "start": entry["episode_start"]}
        for box in self.inboxes:
            box.put(("window", low, _arrays(inputs)))
        self.pending = ({k: cpu(p) for k, p in value.items()}, inputs["stats"], follow,
                        t[-1] + env.n_substeps * env.c["physics_dt"], low, inputs["params"])

    def finish(self):
        value, stats, follow, t_end, low, params = self.pending
        self.pending = None
        cfg, H = self.cfg, self.cfg["horizon"]
        B = follow[0][0].shape[0]
        rewards, dones = [None] * H, [None] * H
        t0 = time.perf_counter()
        for _ in range(H):
            k, r, d = self._receive("forward")
            rewards[k], dones[k] = r, d
        t1 = time.perf_counter()
        # the loss's weight of each step's reward: -gamma^k alive_k / (B H)
        alive, weights, acc = torch.ones(B), [], torch.zeros(B)
        for k in range(H):
            weights.append(-(cfg["gamma"] ** k) * alive / (B * H))
            acc = acc + cfg["gamma"] ** k * alive * rewards[k]
            alive = alive * (1.0 - dones[k])
        # the critic's tail from the followed final state
        qH = follow[H - 1][0].clone().requires_grad_(True)
        vH = follow[H - 1][1].clone().requires_grad_(True)
        ret = acc
        if cfg["value_bootstrap"]:
            tail = cfg["gamma"] ** H * alive * value_tail(value, stats, self.env.obs(qH, vH, t_end),
                                                          cfg, low)
            torch.autograd.backward(-torch.sum(tail) / (B * H))
            ret = ret + tail.detach()
        lam_q = torch.zeros_like(qH) if qH.grad is None else qH.grad
        lam_v = torch.zeros_like(vH) if vH.grad is None else vH.grad
        for k in reversed(range(H)):
            self.inboxes[self.owner[k]].put(_arrays(("backward", k, weights[k], lam_q, lam_v)))
            _, lam_q, lam_v = self._receive("backward")
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        for box in self.inboxes:
            box.put(("grads",))
        for _ in self.inboxes:
            (g,) = self._receive("grads")
            for k, x in g.items():
                grads[k] += x
        self.seconds = {"forwards_s": t1 - t0, "chain_s": time.perf_counter() - t1}
        return float(-torch.mean(ret) / H), grads

    def __call__(self, *args, **kw):
        self.start(*args, **kw)
        return self.finish()

    def close(self):
        for box in self.inboxes:
            box.put(("stop",))
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
