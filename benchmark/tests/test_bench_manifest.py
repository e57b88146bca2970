"""The harness finds every piece by name, and what it loads."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import run
from conftest import ROOT

MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_manifest_keys_and_files():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    for c in MANIFEST["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
        assert callable(run.reader(m["name"]))


def cell_rules(manifest: dict, name: str):
    """Every rule a cell of ``manifest`` keeps, found by name through the
    ``benchmark`` on the path: its files, its metrics and its rate."""
    _, cell, _ = run.load_cell(name)
    w = next(w for w in manifest["workloads"] if w["name"] == name)
    assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
    assert os.path.exists(os.path.join(run.HERE, "modes", f"{cell['mode']}.py"))
    e2e = run.cell_metrics(manifest, name, trace=False)
    assert {"step_ms_p95", "setup_s"} <= {m["name"] for m in e2e}
    layer = run.cell_metrics(manifest, name, trace=True)
    assert layer
    # The window's rate, exactly once: end to end as env_steps_per_s, or
    # through one per-layer entry of unit env-steps/s that names the cell.
    e2e_rates = [m for m in e2e if m["unit"] == "env-steps/s"]
    layer_rates = [m for m in manifest["per_layer"] if m["unit"] == "env-steps/s"
                   and name in m.get("workloads", [name])]
    assert len(e2e_rates) + len(layer_rates) == 1, (e2e_rates, layer_rates)
    if e2e_rates:
        assert e2e_rates[0]["name"] == "env_steps_per_s"
    else:
        assert name in layer_rates[0].get("workloads", []) and layer_rates[0] in layer
    assert cell["limits"]


@pytest.mark.parametrize("name", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_found_by_name(name):
    cell_rules(MANIFEST, name)


def test_rate_rule_counts_each_cell_once():
    """A cell with its rate twice (end to end and per layer), or with none,
    breaks the rule."""
    both = json.loads(json.dumps(MANIFEST))
    next(m for m in both["end_to_end"] if m["name"] == "env_steps_per_s")["workloads"].append(
        "walk-eval")
    none = json.loads(json.dumps(MANIFEST))
    next(m for m in none["per_layer"] if m["name"] == "untraced_env_steps_per_s")[
        "workloads"].remove("walk-eval")
    for manifest in (both, none):
        with pytest.raises(AssertionError):
            cell_rules(manifest, "walk-eval")


def test_new_workload_file_is_picked_up(tmp_path):
    """A copy of the benchmark with one more workload file and its own
    per-layer rate file (and their entries appended to the manifest) finds
    the new cell, and the cell keeps every rule, with no other edit."""
    dst = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "benchmark"), dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    cell = json.load(open(dst / "benchmark" / "workloads" / "walk-eval.json"))
    cell.update(name="walk-eval-16k", num_envs=16384, traffic="eval_16384x300")
    json.dump(cell, open(dst / "benchmark" / "workloads" / "walk-eval-16k.json", "w"))
    (dst / "benchmark" / "metrics" / "walk-eval-16k.env_steps_per_s.py").write_text(
        "from benchmark.run import reader\n\nread = reader('untraced_env_steps_per_s')\n")
    manifest["workloads"].append({"name": "walk-eval-16k", "config": "walk",
                                  "traffic": "eval_16384x300", "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "walk-eval-16k.env_steps_per_s", "unit": "env-steps/s",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "whole step", "moves": "step_ms_p95",
                                  "workloads": ["walk-eval-16k"]})
    json.dump(manifest, open(dst / "BENCHMARK.json", "w"))
    code = ("import sys; sys.path[:0] = [%r, %r]; from benchmark import run; "
            "import test_bench_manifest as t; t.cell_rules(t.MANIFEST, 'walk-eval-16k'); "
            "m, c, f = run.load_cell('walk-eval-16k'); "
            "print(c['num_envs'], f['clip'], [x['name'] for x in run.cell_metrics(m, 'walk-eval-16k', False)], "
            "run.reader('walk-eval-16k.env_steps_per_s').__module__)"
            % (str(dst), str(dst / "benchmark" / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=dst,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("16384 walk ['step_ms_p95', 'setup_s'] benchmark_metric_")


def test_result_line_keys():
    manifest, cell, conf = run.load_cell("walk-eval")
    cell, conf = run.mode_of(cell).tiny(cell, conf)
    args = types.SimpleNamespace(workload="walk-eval", seed=2 ** 31 + 11, seconds=0.01, trace=0)
    out = run.run_cell(args, manifest, cell, conf, "cpu", lambda m: None)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(cell["limits"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_jax_and_a_reference_apart_from_the_program():
    """A run's process loads no module named jax, jaxlib, flax or
    pbrl_tpu (top-level names compared whole), and the reference and the
    yardstick load nothing of pbrl_tpu_torch."""
    code = (
        "import sys, types; sys.path.insert(0, %r)\n"
        "import benchmark.reference.env, benchmark.reference.learner, benchmark.judge, "
        "benchmark.flops, benchmark.trace\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'pbrl_tpu_torch' not in tops, 'the reference loads the program'\n"
        "from benchmark import run\n"
        "m, c, f = run.load_cell('walk-eval'); c, f = run.mode_of(c).tiny(c, f)\n"
        "a = types.SimpleNamespace(workload='walk-eval', seed=3, seconds=0.01, trace=0)\n"
        "run.run_cell(a, m, c, f, 'cpu', lambda s: None)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'pbrl_tpu'}), 'pbrl_tpu_torch' in tops)\n"
        % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pbrl_tpu_torch_like", types.ModuleType("x"))
    assert "pbrl_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in run.forbidden_modules()
