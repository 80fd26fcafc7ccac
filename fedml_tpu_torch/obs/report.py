"""Run-report merger: metrics.jsonl + telemetry snapshot + round traces
→ one human-readable per-round timeline (CLI: ``python -m
fedml_tpu_torch.obs.report``; the port's copy of
``fedml_tpu/obs/report.py``, rendering the same text).

The three observability streams land in different files with different
shapes (wandb-style events, Prometheus-style series, Perfetto-style
spans).  Debugging a slow or faulty federation needs them TOGETHER:
"round 3 took 9s" (trace) next to "silo 2 retried 14 sends" (telemetry)
next to "test_acc dropped" (metrics).  This module reads whatever subset
exists and renders it; every section degrades to absence, so the report
works on a crashed run (atomic summary.json + whatever trace files were
exported) as well as a finished one.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

# -- loaders (each tolerates absence) ----------------------------------------


def load_jsonl(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn final line of a crashed run
    return out


def load_json(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_trace_events(trace_dir: Optional[str],
                      include_meta: bool = False) -> List[dict]:
    """Merge every process's exported span file in ``trace_dir`` (the
    multi-process stitch: each gRPC silo exports its own).  Span ("X")
    events only by default; ``include_meta`` keeps the ``process_name``
    metadata Perfetto uses to label node tracks."""
    if not trace_dir:
        return []
    events: List[dict] = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "*.json"))):
        try:
            data = load_json(path)
        except json.JSONDecodeError:
            continue
        if isinstance(data, dict):
            data = data.get("traceEvents", [])
        if isinstance(data, list):
            events.extend(e for e in data if isinstance(e, dict))
    keep = ("X", "M") if include_meta else ("X",)
    # dedupe across files — the same invariant trace.py enforces
    # in-process: one event per span id.  This also makes the loader
    # idempotent when a --merge_trace output was written INTO trace_dir
    # (it would otherwise re-glob and double every span), and collapses
    # duplicate process_name metadata from multiple exporters.
    seen, uniq = set(), []
    for e in events:
        if e.get("ph") not in keep:
            continue
        if e["ph"] == "M":
            key = ("M", e.get("pid"), e.get("name"),
                   json.dumps(e.get("args"), sort_keys=True))
        else:
            span_id = (e.get("args") or {}).get("span_id")
            key = ("X", span_id) if span_id is not None else ("X", id(e))
        if key in seen:
            continue
        seen.add(key)
        uniq.append(e)
    return uniq


def merge_traces(trace_dir: str, out_path: str) -> Optional[int]:
    """Write one combined Perfetto file from all per-process exports;
    returns the span count (load it at ui.perfetto.dev).  A missing or
    empty trace dir returns None WITHOUT writing: a zero-span merged
    file would read as "traced, and nothing happened" when the truth is
    "nothing was traced"."""
    events = load_trace_events(trace_dir, include_meta=True)
    if not any(e["ph"] == "X" for e in events):
        return None
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return sum(1 for e in events if e["ph"] == "X")


# -- round timeline ----------------------------------------------------------


def group_round_traces(events: List[dict]) -> List[dict]:
    """Group span events by trace id; one entry per federated round (or
    async version), ordered by start time."""
    by_trace: Dict[str, List[dict]] = {}
    for e in events:
        tid = (e.get("args") or {}).get("trace_id")
        if tid is not None:
            by_trace.setdefault(tid, []).append(e)
    rounds = []
    for tid, evs in by_trace.items():
        evs.sort(key=lambda e: e.get("ts", 0))
        t0 = min(e["ts"] for e in evs)
        t1 = max(e["ts"] + e.get("dur", 0) for e in evs)
        root = next((e for e in evs
                     if not (e.get("args") or {}).get("parent_id")), evs[0])
        rounds.append({"trace_id": tid, "t0": t0, "total_s": (t1 - t0) / 1e6,
                       "root": root, "events": evs})
    rounds.sort(key=lambda r: r["t0"])
    return rounds


def _timeline_lines(trace: dict) -> List[str]:
    """Indented span tree for one round: depth from the parent chain,
    siblings ordered by start time."""
    evs = trace["events"]
    by_id = {(e.get("args") or {}).get("span_id"): e for e in evs}
    children: Dict[Optional[str], List[dict]] = {}
    for e in evs:
        args = e.get("args") or {}
        parent = args.get("parent_id")
        if parent not in by_id:
            parent = None  # orphan (e.g. exporter missing one process)
        children.setdefault(parent, []).append(e)
    lines: List[str] = []

    def walk(parent_id: Optional[str], depth: int) -> None:
        for e in sorted(children.get(parent_id, []),
                        key=lambda x: x.get("ts", 0)):
            args = e.get("args") or {}
            rel_ms = (e["ts"] - trace["t0"]) / 1e3
            lines.append(f"  {'  ' * depth}{e['name']:<12s} "
                        f"node={args.get('node', '?'):<4} "
                        f"+{rel_ms:8.1f}ms  {e.get('dur', 0) / 1e6:8.4f}s")
            walk(args.get("span_id"), depth + 1)

    walk(None, 0)
    return lines


# -- perf ledger section -----------------------------------------------------


def _perf_lines(rows: List[dict]) -> List[str]:
    """Per-round flight-recorder table from ``perf.jsonl`` rows (phase
    breakdown in ms + RSS watermark + recompile count), plus a summary
    line.  Phases are columns, union across rounds — a round missing a
    phase (checkpoint gated off) renders '-'."""
    phases = sorted({p for r in rows for p in (r.get("phases") or {})})
    out = ["  " + "  ".join(
        [f"{'round':>6s}", f"{'total_ms':>9s}"]
        + [f"{p[:14]:>14s}" for p in phases]
        + [f"{'rss_peak_mb':>11s}", f"{'recomp':>6s}"])]
    for r in rows:
        ph = r.get("phases") or {}
        rss = (r.get("rss") or {}).get("peak_bytes")
        cells = [f"{str(r.get('round', '?')):>6s}",
                 f"{r['round_s'] * 1e3:9.1f}" if r.get("round_s") is not None
                 else f"{'-':>9s}"]
        cells += [f"{ph[p] * 1e3:14.2f}" if p in ph else f"{'-':>14s}"
                  for p in phases]
        cells.append(f"{rss / 2 ** 20:11.1f}" if rss is not None
                     else f"{'-':>11s}")
        cells.append(f"{r.get('recompiles', 0):>6d}")
        out.append("  " + "  ".join(cells))
    late = [r for r in rows[1:] if r.get("recompiles")]
    rss_peaks = [(r.get("rss") or {}).get("peak_bytes") for r in rows]
    rss_peaks = [b for b in rss_peaks if b is not None]
    out.append(
        f"  {len(rows)} round(s); "
        + (f"peak RSS {max(rss_peaks) / 2 ** 20:.1f} MiB; "
           if rss_peaks else "no RSS watermark (no /proc); ")
        + (f"RECOMPILES after the baseline round in "
           f"{len(late)} round(s) — a hot function is retracing"
           if late else "recompiles after the baseline round: 0"))
    return out


# -- device observatory section ----------------------------------------------


def _device_lines(rows: List[dict]) -> List[str]:
    """Per-round device table from the perf ledger's ``device`` sections
    (obs/device.py): memory in-use/watermark (summed across devices),
    compile-ledger entries, achieved FLOP/s and MFU — plus a summary
    naming every compile with its wall time.  Rounds without a device
    section render '-' (the observatory is additive)."""
    def mb(v):
        return f"{v / 2 ** 20:10.1f}" if v is not None else f"{'-':>10s}"

    out = ["  " + "  ".join(
        [f"{'round':>6s}", f"{'mem_mb':>10s}", f"{'mem_peak_mb':>11s}",
         f"{'devs':>4s}", f"{'compiles':>8s}", f"{'compile_ms':>10s}",
         f"{'mfu':>9s}"])]
    all_compiles: List[dict] = []
    backend = None
    sources = set()
    for r in rows:
        dev = r.get("device")
        if not isinstance(dev, dict):
            continue
        backend = dev.get("backend") or backend
        mem = dev.get("memory") or []
        in_use = [e.get("bytes_in_use") for e in mem]
        in_use = [b for b in in_use if b is not None]
        peaks = [e.get("round_peak_bytes") or e.get("peak_bytes")
                 or e.get("bytes_in_use") for e in mem]
        peaks = [b for b in peaks if b is not None]
        sources.update(e.get("source") for e in mem if e.get("source"))
        comps = dev.get("compiles") or []
        all_compiles.extend(comps)
        compile_s = sum(float(e.get("wall_s") or 0.0) for e in comps)
        mfu = dev.get("mfu")
        out.append("  " + "  ".join(
            [f"{str(r.get('round', '?')):>6s}",
             mb(sum(in_use) if in_use else None),
             mb(max(peaks) if peaks else None)[:11].rjust(11),
             f"{len(mem) if mem else 0:>4d}",
             f"{len(comps):>8d}",
             f"{compile_s * 1e3:10.1f}" if comps else f"{'-':>10s}",
             f"{mfu:9.2e}" if isinstance(mfu, (int, float))
             else f"{'-':>9s}"]))
    head = f"  backend {backend or '?'}"
    if sources:
        head += f"; memory via {'/'.join(sorted(sources))}"
    head += (f"; {len(all_compiles)} compile(s) totalling "
             f"{sum(float(e.get('wall_s') or 0.0) for e in all_compiles) * 1e3:.1f}ms"
             if all_compiles else "; no compiles ledgered")
    out.append(head)
    for e in all_compiles:
        out.append(f"    compile {e.get('fn', '?'):<28s} "
                   f"{float(e.get('wall_s') or 0.0) * 1e3:8.1f}ms  "
                   f"{e.get('signature', '')[:48]}")
    return out


# -- critical-path section ---------------------------------------------------


def _critical_path_lines(rows: List[dict]) -> List[str]:
    """Per-round binding-constraint table from the perf ledger's
    ``critical_path`` records (obs/critical_path.py): what the round was
    actually waiting on, the wall-clock attribution shares, coverage,
    and the fold-overlap ratio — plus a summary naming the dominant
    constraint across the run."""
    out = ["  " + "  ".join(
        [f"{'round':>6s}", f"{'binding':>12s}", f"{'uploads':>7s}",
         f"{'coverage':>8s}", f"{'fold_ovl':>8s}",
         "attribution (top shares)"])]
    tally: dict = {}
    for r in rows:
        cp = r.get("critical_path")
        if not isinstance(cp, dict):
            continue
        binding = str(cp.get("binding", "?"))
        tally[binding] = tally.get(binding, 0) + 1
        attr = cp.get("attribution") or {}
        round_s = cp.get("round_s") or 0.0
        top = sorted(attr.items(), key=lambda kv: -kv[1])[:3]
        shares = "  ".join(
            f"{k}={v * 1e3:.1f}ms"
            + (f" ({v / round_s:.0%})" if round_s else "")
            for k, v in top)
        ovl = cp.get("fold_overlap_ratio")
        out.append("  " + "  ".join(
            [f"{str(r.get('round', '?')):>6s}", f"{binding:>12s}",
             f"{cp.get('uploads', 0):>7d}",
             f"{cp.get('coverage', 0.0):8.3f}",
             f"{ovl:8.2f}" if isinstance(ovl, (int, float))
             else f"{'-':>8s}", shares]))
    if tally:
        dominant = max(tally.items(), key=lambda kv: kv[1])
        out.append(f"  binding constraint: {dominant[0]} in "
                   f"{dominant[1]}/{sum(tally.values())} round(s) "
                   f"({', '.join(f'{k}={v}' for k, v in sorted(tally.items()))})")
    return out


# -- health ledger section ---------------------------------------------------


def _health_lines(rows: List[dict]) -> List[str]:
    """Per-round learning-health table from ``health.jsonl`` rows, plus
    a per-edge rollup table when the run carried the multi-level
    topology, plus an alarm summary line."""
    def num(v, spec="8.4f", width=8):
        return f"{v:{spec}}" if isinstance(v, (int, float)) \
            else f"{'-':>{width}s}"

    out = ["  " + "  ".join(
        [f"{'round':>6s}", f"{'up':>4s}", f"{'acc':>4s}", f"{'rej':>4s}",
         f"{'drop':>4s}", f"{'norm_mean':>10s}", f"{'norm_cv':>8s}",
         f"{'align':>8s}", f"{'gdelta':>9s}", "alarms"])]
    fired_total = 0
    for r in rows:
        norm = r.get("norm") or {}
        align = r.get("alignment") or {}
        alarms = r.get("alarms") or {}
        fired = sorted(a for a, v in alarms.items() if not v.get("ok"))
        fired_total += len(fired)
        mean = norm.get("mean")
        std = norm.get("std")
        cv = (std / mean) if mean and std is not None else None
        out.append("  " + "  ".join(
            [f"{str(r.get('round', '?')):>6s}",
             f"{r.get('uploads', 0):>4d}", f"{r.get('accepted', 0):>4d}",
             f"{r.get('rejected', 0):>4d}", f"{r.get('dropped', 0):>4d}",
             num(mean, "10.4f", 10), num(cv, "8.3f", 8),
             num((align.get("mean")), "8.4f", 8),
             num(r.get("global_delta_norm"), "9.4f", 9),
             ",".join(fired) if fired else "-"]))
    edge_rows = [r for r in rows if r.get("edges")]
    if edge_rows:
        out.append("  per-edge rollup (latest round with edge frames):")
        last = edge_rows[-1]
        out.append("  " + "  ".join(
            [f"{'edge':>6s}", f"{'up':>4s}", f"{'acc':>4s}",
             f"{'weight':>9s}", f"{'norm_mean':>10s}", f"{'align':>8s}",
             f"{'gdelta':>9s}"]))
        for e, s in sorted(last["edges"].items(),
                           key=lambda kv: (len(kv[0]), kv[0])):
            norm = s.get("norm") or {}
            align = s.get("alignment") or {}
            out.append("  " + "  ".join(
                [f"{e:>6s}", f"{s.get('uploads', 0):>4d}",
                 f"{s.get('accepted', 0):>4d}",
                 num(s.get("weight"), "9.1f", 9),
                 num(norm.get("mean"), "10.4f", 10),
                 num(align.get("mean"), "8.4f", 8),
                 num(s.get("global_delta_norm"), "9.4f", 9)]))
        rollup = last.get("edge_rollup") or {}
        if rollup.get("count"):
            out.append(f"  edge rollup (merged moments): "
                       f"count={rollup['count']} "
                       f"mean={rollup['mean']:.4f} std={rollup['std']:.4f}")
    out.append(
        f"  {len(rows)} round(s); "
        + (f"DRIFT ALARMS fired {fired_total} time(s) — see the alarms "
           f"column" if fired_total
           else "drift alarms: none fired"))
    return out


# -- renderer ----------------------------------------------------------------

_ROUND_KEYS = ("round", "version", "step")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_report(run_dir: Optional[str] = None,
                  trace_dir: Optional[str] = None,
                  perf_ledger: Optional[str] = None,
                  health_ledger: Optional[str] = None) -> str:
    """``perf_ledger`` / ``health_ledger``: explicit ledger paths for
    runs that wrote them outside ``run_dir`` (the ``--perf_ledger`` /
    ``--health_ledger`` flags); default to ``run_dir/{perf,health}.jsonl``."""
    out: List[str] = ["=" * 64, "fedml_tpu run report", "=" * 64]
    summary = load_json(os.path.join(run_dir, "summary.json")) \
        if run_dir else None
    events = load_jsonl(os.path.join(run_dir, "metrics.jsonl")) \
        if run_dir else []
    telemetry = load_json(os.path.join(run_dir, "telemetry.json")) \
        if run_dir else None

    if summary:
        cfg = summary.get("config") or {}
        head = " ".join(f"{k}={cfg[k]}" for k in
                        ("algo", "model", "dataset", "client_num_per_round",
                         "comm_round") if k in cfg)
        if head:
            out += ["", f"run: {head}"]
        final = summary.get("final")
        if isinstance(final, dict) and final:
            out += ["final: " + "  ".join(f"{k}={_fmt(v)}"
                                          for k, v in sorted(final.items())
                                          if isinstance(v, (int, float)))]

    round_rows = [e for e in events
                  if any(k in e for k in _ROUND_KEYS)
                  and any(isinstance(v, (int, float))
                          for k, v in e.items() if not k.startswith("_"))]
    if round_rows:
        out += ["", "-- rounds (metrics.jsonl) " + "-" * 37]
        cols = sorted({k for e in round_rows for k, v in e.items()
                       if isinstance(v, (int, float))
                       and not k.startswith("_")},
                      key=lambda k: (k not in _ROUND_KEYS, k))
        out.append("  " + "  ".join(f"{c:>12s}" for c in cols))
        for e in round_rows:
            out.append("  " + "  ".join(
                f"{_fmt(e[c]) if c in e else '-':>12s}" for c in cols))

    perf_path = perf_ledger or (os.path.join(run_dir, "perf.jsonl")
                                if run_dir else None)
    perf_rows = load_jsonl(perf_path) if perf_path else []
    health_path = health_ledger or (os.path.join(run_dir, "health.jsonl")
                                    if run_dir else None)
    health_rows = load_jsonl(health_path) if health_path else []

    if run_dir and not round_rows and (perf_rows or health_rows):
        # perf-/health-only run (no per-round metrics.jsonl rows — eval
        # logging off or a crashed sink): say so explicitly, so the
        # absent rounds table reads as "not recorded", never as "the
        # run had no rounds" while the ledgers below clearly show them
        out += ["", "(no per-round metrics.jsonl rows — perf/health-only "
                    "run; rounds appear in the ledger sections below)"]

    if perf_rows:
        out += ["", "-- perf ledger (perf.jsonl, phase ms) " + "-" * 25]
        out += _perf_lines(perf_rows)
        if any(isinstance(r.get("critical_path"), dict) for r in perf_rows):
            out += ["", "-- critical path (perf.jsonl critical_path "
                        "section) " + "-" * 15]
            out += _critical_path_lines(perf_rows)
        if any(isinstance(r.get("device"), dict) for r in perf_rows):
            out += ["", "-- device observatory (perf.jsonl device "
                        "section) " + "-" * 17]
            out += _device_lines(perf_rows)
    elif perf_ledger:
        # an EXPLICITLY named ledger that renders nothing must say so —
        # an instrumented run silently reporting as uninstrumented is
        # the blindness this subsystem exists to end
        out += ["", f"-- perf ledger: no rows at {perf_ledger} "
                    f"(missing or empty)"]

    if health_rows:
        out += ["", "-- learning health (health.jsonl) " + "-" * 29]
        out += _health_lines(health_rows)
    elif health_ledger:
        out += ["", f"-- health ledger: no rows at {health_ledger} "
                    f"(missing or empty)"]

    traces = group_round_traces(load_trace_events(trace_dir))
    if traces:
        out += ["", "-- round timelines (trace) " + "-" * 36]
        for tr in traces:
            label = tr["root"]["name"]
            args = tr["root"].get("args") or {}
            for key in _ROUND_KEYS:
                if key in args:
                    label = f"{label} {key}={args[key]}"
                    break
            out.append(f"{label}  [trace {tr['trace_id']}]  "
                       f"total {tr['total_s']:.4f}s")
            out += _timeline_lines(tr)

    if telemetry:
        out += ["", "-- telemetry " + "-" * 50]
        for kind in ("counters", "gauges"):
            for series, value in sorted((telemetry.get(kind) or {}).items()):
                out.append(f"  {series:<56s} {_fmt(value)}")
        for series, h in sorted((telemetry.get("histograms") or {}).items()):
            if not h.get("count"):
                continue
            out.append(f"  {series:<56s} count={h['count']} "
                       f"mean={_fmt(h['mean'])} min={_fmt(h['min'])} "
                       f"max={_fmt(h['max'])}")
        counters = telemetry.get("counters") or {}
        hists = telemetry.get("histograms") or {}
        examples = counters.get("fedml_trainer_examples_total")
        train_s = sum(h["sum"] for name, h in hists.items()
                      if name.startswith(("fedml_trainer_train_seconds",
                                          "fedml_trainer_compile_seconds")))
        if examples and train_s:
            out += ["", f"  derived: examples/sec ≈ "
                        f"{examples / train_s:,.1f} "
                        f"({_fmt(examples)} examples / "
                        f"{train_s:.3f}s in-trainer)"]

    if len(out) == 3:
        out.append("(no artifacts found — pass --run_dir and/or "
                   "--trace_dir of an instrumented run)")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="obs_report",
        description="Merge metrics.jsonl + telemetry + round traces into "
                    "a per-round timeline report")
    p.add_argument("--run_dir", "--metrics_dir", dest="run_dir", default=None,
                   help="directory holding metrics.jsonl / summary.json / "
                        "telemetry.json")
    p.add_argument("--trace_dir", default=None,
                   help="directory holding per-process *.json span exports")
    p.add_argument("--merge_trace", default=None, metavar="OUT",
                   help="also write one combined Perfetto JSON here")
    p.add_argument("--perf_ledger", default=None,
                   help="explicit perf.jsonl path for runs that wrote it "
                        "outside --run_dir (default: run_dir/perf.jsonl)")
    p.add_argument("--health_ledger", default=None,
                   help="explicit health.jsonl path for runs that wrote it "
                        "outside --run_dir (default: run_dir/health.jsonl)")
    args = p.parse_args(argv)
    if args.merge_trace:
        if not args.trace_dir:
            print("--merge_trace: no --trace_dir given; nothing to merge")
        else:
            n = merge_traces(args.trace_dir, args.merge_trace)
            if n is None:
                print(f"--merge_trace: no span exports under "
                      f"{args.trace_dir!r} (missing or empty trace dir); "
                      f"nothing written")
            else:
                print(f"merged {n} span events -> {args.merge_trace}")
    print(render_report(args.run_dir, args.trace_dir,
                        perf_ledger=args.perf_ledger,
                        health_ledger=args.health_ledger), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
