"""A new mode, configuration, cell and per-layer rate join a copy of the
benchmark through new files and entries appended to its manifest alone,
and the harness runs, judges and traces the cell on the CPU.

The mode added here steps ``MimicVecEnv`` on the engine (``backend="xla"``),
so it never launches the policy-step kernel; it has one fault of its own
and its own CPU cut. Every file of the copy that was there before keeps
its bytes, and the manifest keeps its entries as they were."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

MODE = '''"""Scratch cells: ``MimicVecEnv`` on the engine, a few steps from a
seeded reset with seeded actions. It launches no kernel."""

import copy

import torch

from benchmark import judge
from benchmark.proxy import StepProxy
from benchmark.reference.env import RefEnv

FAULTS = ("frozen_physics",)


def plant(name, prog):
    env = prog.proxy._env
    physics = env._physics
    env._physics = lambda q, v, u: (q.clone(), v.clone(), *physics(q, v, u)[2:])

    def undo():
        del env._physics
    return undo


def tiny(cell, conf):
    conf = copy.deepcopy(conf)
    conf["env_config"]["policy_dt"] = 0.004
    return dict(cell, num_envs=2, episode_steps=2), conf


class Program:
    launches_kernel = False

    def __init__(self, cell, conf, device):
        from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
        from pbrl_tpu_torch.mocap import load_clip
        from pbrl_tpu_torch.model import humanoid_model
        from pbrl_tpu_torch.utils.configio import dict_to_config

        self.cell, self.conf, self.device = cell, conf, torch.device(device)
        self.env_config = conf["env_config"]
        env = MimicVecEnv(humanoid_model(), load_clip(conf["clip"], device=self.device),
                          dict_to_config(EnvConfig, self.env_config), device=self.device,
                          backend=conf["backend"])
        self.proxy = StepProxy(env)
        self.proxy.full = True
        self.num_envs, self.num_steps = cell["num_envs"], cell["episode_steps"]
        self.steps_per_unit = self.num_envs * self.num_steps

    def start(self, seed):
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.proxy.clear()

    def warm(self):
        pass

    def unit(self, split=False):
        self.proxy.begin_unit()
        state = self.proxy.reset(self.num_envs, self.gen)
        for _ in range(self.num_steps):
            action = 0.3 * torch.randn((self.num_envs, self.proxy.action_size),
                                       generator=self.gen, device=self.device)
            state = self.proxy.step(state, action)
        return self.steps_per_unit, {}

    def free(self):
        self.kept = [s for unit in self.proxy.records for s in unit]
        self.proxy = None

    def reference(self, device):
        return {"env": RefEnv(self.conf["clip"], self.env_config, device)}

    def numbers(self, ref, control=False):
        cat = lambda side, f: torch.cat([getattr(s[side], f) for s in self.kept])
        out = ref["env"].step(cat("in", "qpos"), cat("in", "qvel"), cat("in", "time"),
                              cat("in", "episode_start"),
                              torch.cat([s["action"] for s in self.kept]))
        return {"qpos_gap": judge.abs_gap(cat("out", "qpos"), out["qpos"]),
                "qvel_gap": judge.rel_gap(cat("out", "qvel"), out["qvel"])}
'''

RATE = '''"""The window's rate of the engine cells, per layer."""

from benchmark.run import reader

read = reader("untraced_env_steps_per_s")
'''

CELL = "walk-engine-steps"

# Run in the copy: the rules, a sound run, the mode's fault, a traced run
# with the kernel's entry made to raise, and a fault of another mode.
DRIVE = '''
import json, sys, types
sys.path[:0] = [%r, %r, %r]
from benchmark import faults, run
import test_bench_manifest
from pbrl_tpu_torch.ops import mimic_kernel

CELL = %r
res = {"bench": run.HERE}
test_bench_manifest.cell_rules(test_bench_manifest.MANIFEST, CELL)
res["rules"] = True

def launched(*a, **k):
    raise AssertionError("the policy-step kernel was called")
mimic_kernel.MimicStep.__call__ = launched

def go(trace=0, fault=None):
    manifest, cell, conf = run.load_cell(CELL)
    cell, conf = run.mode_of(cell).tiny(cell, conf)
    args = types.SimpleNamespace(workload=CELL, seed=2 ** 31 + 99, seconds=0.01, trace=trace)
    undo, logged = [], []
    out = run.run_cell(args, manifest, cell, conf, "cpu", logged.append,
                       break_program=(lambda p: undo.append(faults.plant(fault, p)))
                       if fault else None)
    for u in undo:
        u()
    return out, logged

res["sound"], _ = go()
res["fault"], _ = go(fault="frozen_physics")
res["traced"], logged = go(trace=1)
res["traced_log"] = [m for m in logged if "kernel" in m]
try:
    _, cell, conf = run.load_cell(CELL)
    faults.plant("altered", types.SimpleNamespace(cell=cell))
except ValueError as e:
    res["altered"] = str(e)
print(json.dumps(res))
'''


def digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """The copy with the new files and entries, and what a run there gave."""
    dst = tmp_path_factory.mktemp("added") / "repo"
    bench = dst / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {str(p.relative_to(dst)) for p in bench.rglob("*") if p.is_file()}
    (dst / "assets").symlink_to(os.path.join(ROOT, "assets"))  # the reference's clips
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))

    (bench / "modes" / "engine_steps.py").write_text(MODE)
    conf = json.load(open(bench / "configs" / "walk.json"))
    conf.update(backend="xla", why="walk's recipe stepped on the engine")
    (bench / "configs" / "walk-engine.json").write_text(json.dumps(conf, indent=1))
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps({
        "name": CELL, "config": "walk-engine", "traffic": "engine_2x2", "mode": "engine_steps",
        "chips": 1, "num_envs": 4096, "episode_steps": 8, "why": "test",
        "limits": {"qpos_gap": 1e-4, "qvel_gap": 1e-3}}, indent=1))
    (bench / "metrics" / f"{CELL}.env_steps_per_s.py").write_text(RATE)
    grown = json.loads(json.dumps(manifest))
    grown["configs"].append({"name": "walk-engine", "source": manifest["configs"][0]["source"],
                             "file": "benchmark/configs/walk-engine.json", "reduced": [],
                             "why": "test"})
    grown["workloads"].append({"name": CELL, "config": "walk-engine", "traffic": "engine_2x2",
                               "chips": 1, "why": "test"})
    grown["per_layer"].append({"name": f"{CELL}.env_steps_per_s", "unit": "env-steps/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step", "moves": "step_ms_p95",
                               "workloads": [CELL]})
    (dst / "BENCHMARK.json").write_text(json.dumps(grown, indent=1))

    code = DRIVE % (str(dst), str(bench / "tests"), ROOT, CELL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=dst,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return {"dst": dst, "before": before, "manifest": manifest,
            "result": json.loads(out.stdout.strip().splitlines()[-1])}


def test_old_files_keep_their_bytes(added):
    dst = added["dst"]
    assert added["before"]
    for rel in added["before"]:
        assert digest(dst / rel) == digest(os.path.join(ROOT, rel)), rel
    grown = json.load(open(dst / "BENCHMARK.json"))
    old = added["manifest"]
    assert set(grown) == set(old)
    for key, value in old.items():
        if isinstance(value, list):
            assert grown[key][:len(value)] == value and len(grown[key]) == len(value) + (
                key in ("configs", "workloads", "per_layer"))
        else:
            assert grown[key] == value


def test_new_cell_keeps_the_rules_and_runs_from_the_copy(added):
    res = added["result"]
    assert res["rules"] is True
    assert res["bench"] == str(added["dst"] / "benchmark")


def test_sound_run_is_correct_and_the_modes_fault_is_not(added):
    res = added["result"]
    assert res["sound"]["correct"] is True, res["sound"]["checks"]
    assert res["fault"]["correct"] is False, res["fault"]["checks"]


def test_traced_run_without_the_kernel(added):
    """The traced run reads the cell's own rate entry and nothing of the
    kernel: no launch, no kernel inputs, no roofline or FLOP count."""
    res = added["result"]["traced"]
    assert res["correct"] is True, res["checks"]
    assert list(res["metrics"]) == [f"{CELL}.env_steps_per_s"]
    assert res["metrics"][f"{CELL}.env_steps_per_s"]["value"] > 0
    assert added["result"]["traced_log"] == ["kernel launches in the window: 0 for 4 policy "
                                             "steps; step intervals timed: 0"]


def test_a_kernel_fault_is_not_one_of_a_kernel_less_mode(added):
    msg = added["result"]["altered"]
    assert "'altered' is not a fault of mode 'engine_steps'" in msg and "frozen_physics" in msg
