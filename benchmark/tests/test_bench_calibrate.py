"""``calibrate --every-unit`` at the CPU cut: the window's last-unit number
read after each unit, the control's beside it, the float64 witness and a
fault's readings, summarised as the limits are set from them."""

import json
import types

from benchmark import calibrate, run


def test_every_unit_reads_each_unit(tmp_path):
    _, cell, conf = run.load_cell("walk-ppo")
    cell, conf = run.mode_of(cell).tiny(cell, conf)
    prog = run.mode_of(cell).Program(cell, conf, "cpu")
    ref = prog.reference("cpu")
    out = tmp_path / "units.json"
    args = types.SimpleNamespace(workload="walk-ppo", every_unit=2, witness=True,
                                 faults="half_batch", fault_seeds=1, out=str(out))
    assert calibrate.every_unit(args, prog, ref, [2 ** 31 + 5]) == 0
    got = json.loads(out.read_text())
    assert [len(rows) for rows in got["units"].values()] == [2]
    row = got["summary"]["window_delta_gap"]
    assert row["units"] == 2
    # sound float32 on both sides at the CPU cut; half the batch reads far above
    assert row["lower"] < 1e-4 < row["half_batch"]
    assert got["summary"]["program_f64_gap"]["lower"] > 0
    assert set(got["summary"]) == {"window_delta_gap", "program_f64_gap", "reference_f64_gap"}
