"""scripts/compare_smoke_runs.py on two made-up chip_smoke.py outputs per tree:
the end-to-end numbers and kernel rows it reads, each tree's spread, the delta
and which metrics pass both spreads."""
import contextlib
import importlib.util
import io
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    path = os.path.join(REPO, "scripts", "compare_smoke_runs.py")
    spec = importlib.util.spec_from_file_location("compare_smoke_runs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(tmp_path, name, rtf, step_ms, kernel_ms):
    lines = ["NVIDIA H100 80GB HBM3, 700.00 W",
             {"phase": "decode", "dtype": "float32", "rtf": rtf, "t": 1.0},
             {"phase": "decode", "bf16_vs_f32_mel_l1": 0.01},
             {"phase": "train", "causal": False, "dtype": "float32", "ms_per_step": step_ms},
             {"phase": "kernel_vs_plain", "name": "lstm_scan", "ms": 99.0},
             {"kernels": [{"name": "lstm_scan", "shape": "decode", "rows": 272, "steps": 1024,
                           "H": 128, "dtype": "float32", "ms": kernel_ms}]},
             {"ok": True}]
    path = tmp_path / name
    path.write_text("\n".join(l if isinstance(l, str) else json.dumps(l) for l in lines) + "\n")
    return str(path)


def test_compare_reads_both_trees_and_flags_what_passes_the_spreads(tmp_path):
    mod = _script()
    a = [_run(tmp_path, f"a{i}", 400.0 + i, 245.0, 4.70 + 0.01 * i) for i in range(2)]
    b = [_run(tmp_path, f"b{i}", 404.0 - i, 245.5, 5.00) for i in range(2)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main([f"parent={','.join(a)}", f"change={','.join(b)}"])
    rows = [json.loads(l) for l in out.getvalue().splitlines()]
    by = {r["metric"]: r for r in rows[:-1]}
    assert set(by) == {"e2e:decode|float32:rtf", "e2e:train|False|float32:ms_per_step",
                       "kernel:lstm_scan|decode|272|1024|128|float32"}
    rtf = by["e2e:decode|float32:rtf"]
    assert rtf["parent"] == [400.0, 401.0] and rtf["higher_is_better"]
    assert rtf["delta"] == pytest.approx(403.5 / 400.5 - 1)
    assert rtf["spread"] == pytest.approx({"parent": 1 / 400, "change": 1 / 403})
    assert rtf["beyond_spread"]                       # 0.75 % against spreads of 0.25 %
    kern = by["kernel:lstm_scan|decode|272|1024|128|float32"]
    assert not kern["higher_is_better"] and kern["beyond_spread"]
    assert not by["e2e:train|False|float32:ms_per_step"]["higher_is_better"]
    assert rows[-1] == {"metrics": 3, "beyond_spread": 3}
    with pytest.raises(SystemExit):
        mod.main([f"parent={a[0]}"])
