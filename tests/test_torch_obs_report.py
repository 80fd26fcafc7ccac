"""The port's run report (``obs/report.py``) and perf trend gate
(``obs/trend.py``, the ledger half) against the JAX package, over one
run directory the port's CLI wrote (the LR on a 6-client mnist twin, 2
rounds, ``--perf --device_obs --health --telemetry --trace_dir``).

* ``render_report`` renders the same text in both packages (exact).
* ``compare_ledgers``, ``compare_device``, ``check_recompiles``,
  ``phase_medians``, the mfu lint and the CLI's exit codes give the same
  verdicts in both packages over the same ledgers (exact).
* ``python -m fedml_tpu_torch.obs.report`` and ``.obs.trend`` run.
"""

import copy
import json
import subprocess
import sys

import pytest

from fedml_tpu.obs import report as j_report
from fedml_tpu.obs import trend as j_trend
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.obs import report, trend


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("run")
    main(["--algo", "cross_silo", "--model", "lr", "--dataset", "mnist",
          "--client_num_in_total", "6", "--client_num_per_round", "3",
          "--batch_size", "4", "--comm_round", "2", "--agg_mode", "stream",
          "--norm_clip", "5.0", "--platform", "cpu", "--log_stdout",
          "false", "--perf", "true", "--device_obs", "true", "--health",
          "true", "--telemetry", "true", "--run_dir", str(root),
          "--trace_dir", str(root / "trace")])
    return root


def test_report_text_equals_jax(run_dir):
    got = report.render_report(str(run_dir), str(run_dir / "trace"))
    want = j_report.render_report(str(run_dir), str(run_dir / "trace"))
    assert got == want
    for section in ("perf ledger", "critical path", "device observatory",
                    "learning health", "round timelines", "telemetry"):
        assert section in got
    got_n = report.merge_traces(str(run_dir / "trace"),
                                str(run_dir / "t_merged.json"))
    want_n = j_report.merge_traces(str(run_dir / "trace"),
                                   str(run_dir / "j_merged.json"))
    assert got_n == want_n > 0
    assert json.loads((run_dir / "t_merged.json").read_text()) == \
        json.loads((run_dir / "j_merged.json").read_text())


def _slow(rows, factor):
    out = copy.deepcopy(rows)
    for r in out:
        r["phases"] = {k: v * factor + 1.0 for k, v in r["phases"].items()}
        r["round_s"] = r["round_s"] * factor + 1.0
        for c in r["device"]["compiles"]:
            c["wall_s"] = c["wall_s"] * factor + 1.0
        r["device"]["memory"] = [{"id": 0, "source": "memory_stats",
                                  "bytes_in_use": 1 << 30}]
    return out


def test_trend_verdicts_equal_jax(run_dir, tmp_path):
    rows = trend.load_ledger(str(run_dir / "perf.jsonl"))
    assert j_trend.validate_ledger(rows) == [] == trend.validate_ledger(rows)
    slow = _slow(rows, 3.0)
    for cur, base in ((slow, rows), (rows, slow), (rows, rows)):
        assert trend.compare_ledgers(cur, base) == \
            j_trend.compare_ledgers(cur, base)
        assert trend.compare_device(cur, base) == \
            j_trend.compare_device(cur, base)
    assert trend.compare_ledgers(slow, rows)   # the slow run regresses
    bad = copy.deepcopy(rows)
    bad[-1]["recompiles"] = 2
    assert trend.check_recompiles(bad) == j_trend.check_recompiles(bad) \
        != []
    assert trend.phase_medians(rows) == j_trend.phase_medians(rows)
    assert trend.device_compile_seconds(rows) == \
        j_trend.device_compile_seconds(rows)
    art = tmp_path / "a.json"
    art.write_text(json.dumps({"cells": [{"mfu": 1.57}, {"mfu": 0.3}]}))
    assert trend.lint_mfu_artifacts([str(art)]) == \
        j_trend.lint_mfu_artifacts([str(art)]) != []
    assert trend.max_mfu(json.loads(art.read_text())) == 1.57
    slow_path = tmp_path / "slow.jsonl"
    slow_path.write_text("".join(json.dumps(r) + "\n" for r in slow))
    for args in (["--ledger", str(run_dir / "perf.jsonl"), "--baseline",
                  str(slow_path), "--health_ledger",
                  str(run_dir / "health.jsonl")],
                 ["--ledger", str(slow_path), "--baseline",
                  str(run_dir / "perf.jsonl")],
                 ["--lint_mfu", str(art)], []):
        assert trend.main(args) == j_trend.main(args)


def test_module_entry_points_run(run_dir, capsys):
    assert report.main(["--run_dir", str(run_dir)]) == 0
    assert "perf ledger" in capsys.readouterr().out
    out = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.obs.trend", "--ledger",
         str(run_dir / "perf.jsonl"), "--health_ledger",
         str(run_dir / "health.jsonl")], capture_output=True, text=True,
        timeout=60)
    assert out.returncode == 0 and "PASS" in out.stdout


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    """``--profile_dir`` (the JAX package's jax.profiler trace) wraps the
    run in ``torch.profiler`` and exports a Chrome trace."""
    main(["--algo", "fedavg", "--model", "lr", "--dataset", "mnist",
          "--client_num_in_total", "4", "--client_num_per_round", "2",
          "--comm_round", "1", "--platform", "cpu", "--log_stdout",
          "false", "--profile_dir", str(tmp_path / "prof")])
    (trace_file,) = (tmp_path / "prof").glob("trace-*.json")
    assert json.loads(trace_file.read_text())["traceEvents"]
