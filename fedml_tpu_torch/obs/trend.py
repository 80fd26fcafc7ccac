"""Perf trend gate over flight-recorder ledgers + the timing-trust lint
(CLI: ``python -m fedml_tpu_torch.obs.trend``).

The port's copy of the ledger half of ``fedml_tpu/obs/trend.py``: the
validators of the JAX package's ``BENCH_*.json`` artifacts wait for the
port's twins of those benches.

Three checks, each CI-usable (non-zero exit on failure, every verdict
names the phase/artifact that tripped it):

* **phase regression** — per-phase medians of the current ``perf.jsonl``
  vs a baseline ledger; a phase beyond ``noise_frac`` AND ``min_abs_s``
  (both must trip — a 2ms phase doubling is noise, a 2s phase doubling
  is not) is a named regression.
* **recompile gate** — any ledger round after the first with
  ``recompiles > 0`` fails: the flight recorder's sentry counted a hot
  function retracing (a hot callable re-captured or rebuilt for a new
  signature after its first round).
* **device gates** — when both ledgers carry the device observatory's
  ``device`` sections (obs/device.py), total hot-jit compile time and
  the per-device memory watermark each gate against the baseline
  (relative band + absolute floor, round 0 in scope — compile cost
  lives there).  Pre-device-observatory ledgers compare vacuously, so
  old artifacts never fail the new gate.
* **mfu lint** — every mfu value in every given JSON artifact must be
  ≤ 1.0 *or explicitly retracted* (a ``timing_untrusted`` mark on the
  artifact, or an ``mfu_retracted`` key beside the offending cell).
* **health ledger schema** (``--health_ledger``) — the learning-health
  ledger (`obs/health.py`) must carry round/upload accounting, norm
  moments, alignment, and alarm verdicts on every line; a malformed
  ledger fails HERE, not in the reader that trusts it later.

``max_mfu`` here is the single source of truth for "largest MFU
anywhere in an artifact" (recursive — nested scaling curves included).
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import statistics
from typing import Dict, Iterator, List, Optional, Tuple

# markers that make an mfu > 1.0 value an acknowledged retraction
# instead of a lint violation: artifact-level timing_untrusted (the
# quarantine path writes it), or a sibling mfu_retracted note on
# the offending cell/any enclosing dict
RETRACTION_KEYS = ("timing_untrusted", "mfu_retracted")


# ---------------------------------------------------------------------------
# mfu lint
# ---------------------------------------------------------------------------

def iter_mfu(obj, path: str = "",
             retracted: bool = False) -> Iterator[Tuple[str, float, bool]]:
    """Yield ``(json_path, value, retracted)`` for every numeric ``mfu``
    key anywhere in ``obj``.  ``retracted`` is sticky downward: a
    retraction marker on any enclosing dict covers its whole subtree."""
    if isinstance(obj, dict):
        here = retracted or any(obj.get(k) for k in RETRACTION_KEYS)
        for k, v in obj.items():
            if k == "mfu" and isinstance(v, (int, float)):
                yield f"{path}/mfu", float(v), here
            else:
                yield from iter_mfu(v, f"{path}/{k}", here)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from iter_mfu(v, f"{path}[{i}]", retracted)


def max_mfu(details) -> float:
    """Largest MFU anywhere in an artifact (recursive; retraction
    markers do NOT hide values here — an artifact carrying an impossible
    number stays refusable as evidence even after it owns up to it)."""
    return max((v for _, v, _ in iter_mfu(details)), default=0.0)


def lint_mfu_artifacts(paths: List[str]) -> List[str]:
    """Violations: unreadable artifacts and unretracted mfu > 1.0 cells.
    Empty list == lint green."""
    violations: List[str] = []
    for path in paths:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            violations.append(f"{path}: unreadable ({e})")
            continue
        for jpath, value, retracted in iter_mfu(data):
            if value > 1.0 and not retracted:
                violations.append(
                    f"{path}:{jpath} = {value:.3g} > 1.0 — physically "
                    f"impossible and not marked retracted (add "
                    f"timing_untrusted or mfu_retracted, or re-capture)")
    return violations


# ---------------------------------------------------------------------------
# ledger loading + phase statistics
# ---------------------------------------------------------------------------

def load_ledger(path: str) -> List[dict]:
    """Read a ``perf.jsonl`` ledger; a torn final line (crashed run) is
    skipped, any other malformed line fails loudly."""
    rows: List[dict] = []
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                continue  # torn tail of a crashed run
            raise ValueError(f"{path}:{i + 1}: malformed ledger line")
    return rows


def validate_ledger(rows: List[dict]) -> List[str]:
    """Schema check: every line carries round/phases/recompiles (and an
    RSS watermark where the platform provides one).  The ``device``
    section (obs/device.py) is OPTIONAL — pre-device-observatory ledgers
    keep validating — but where present it must be well-formed: memory
    is a per-device list or null (never a fabricated placeholder),
    compile entries name their fn and wall time, and an mfu above 1.0
    is a schema failure (physically impossible — the timing-trust
    contract applies to the live ledger exactly as to BENCH artifacts).

    Phase names are open vocabulary (the `PHASES` comment in obs/perf):
    a sharded-spine ledger (``shard_finalize`` phase + a ``shards``
    line field) and a pre-shard ledger both validate — new shapes never
    orphan old artifacts, old readers never fail on new ones.  A
    ``shards`` field, where present, must be a positive int (a sharded
    round with a fabricated shard count would poison the trend
    comparison's like-for-like check)."""
    problems = []
    if not rows:
        return ["ledger is empty"]
    for i, row in enumerate(rows):
        for key in ("round", "phases", "recompiles", "wire"):
            if key not in row:
                problems.append(f"line {i + 1}: missing {key!r}")
        if "shards" in row and (not isinstance(row["shards"], int)
                                or isinstance(row["shards"], bool)
                                or row["shards"] < 1):
            problems.append(f"line {i + 1}: shards must be a positive "
                            f"int, got {row['shards']!r}")
        if "rss" in row and row["rss"] is not None \
                and "peak_bytes" not in row["rss"]:
            problems.append(f"line {i + 1}: rss without peak_bytes")
        if "device" in row and row["device"] is not None:
            problems += _validate_device_section(row["device"], i + 1)
        if "critical_path" in row and row["critical_path"] is not None:
            # the ingest observatory's per-round record —
            # optional, so pre-observatory ledgers keep validating, but
            # where present its binding must name a known constraint and
            # its attribution must agree with its coverage claim
            from fedml_tpu_torch.obs import critical_path as _cpath
            problems += _cpath.validate_record(
                row["critical_path"], path=f"line {i + 1}: critical_path")
    return problems


def _validate_device_section(dev, line_no: int) -> List[str]:
    problems = []
    if not isinstance(dev, dict):
        return [f"line {line_no}: device is not a section dict"]
    mem = dev.get("memory")
    if mem is not None:
        if not isinstance(mem, list) or not mem:
            problems.append(f"line {line_no}: device memory must be a "
                            f"non-empty per-device list or null")
        else:
            for e in mem:
                if not isinstance(e, dict) or "bytes_in_use" not in e \
                        or "source" not in e:
                    problems.append(f"line {line_no}: device memory entry "
                                    f"without bytes_in_use/source")
                    break
    comps = dev.get("compiles")
    if not isinstance(comps, list):
        problems.append(f"line {line_no}: device without a compiles list")
    else:
        for e in comps:
            if not isinstance(e, dict) or "fn" not in e or "wall_s" not in e:
                problems.append(f"line {line_no}: compile entry without "
                                f"fn/wall_s")
                break
    mfu = dev.get("mfu")
    if isinstance(mfu, (int, float)) and mfu > 1.0:
        problems.append(f"line {line_no}: device mfu {mfu:.3g} > 1.0 — "
                        f"physically impossible (timing or peak-table "
                        f"failure, not performance)")
    return problems


def validate_health_ledger(rows: List[dict]) -> List[str]:
    """Schema check for ``health.jsonl`` (obs/health.py): every line
    carries the round/upload accounting, the Welford norm summary, the
    alignment summary, and the alarm verdicts — so a malformed ledger
    fails the GATE, never the reader that trusts it later.  (Torn tails
    are `load_ledger`'s job; edge-actor summaries riding inside frames
    are never ledgered directly and are not validated here.)"""
    problems = []
    if not rows:
        return ["health ledger is empty"]
    for i, row in enumerate(rows):
        for key in ("round", "uploads", "accepted", "rejected", "norm",
                    "alignment", "alarms", "silos"):
            if key not in row:
                problems.append(f"line {i + 1}: missing {key!r}")
        norm = row.get("norm")
        if isinstance(norm, dict):
            for key in ("count", "mean", "std", "min", "max"):
                if key not in norm:
                    problems.append(f"line {i + 1}: norm without {key!r}")
        elif "norm" in row:
            problems.append(f"line {i + 1}: norm is not a summary dict")
        alarms = row.get("alarms")
        if isinstance(alarms, dict):
            for name, v in alarms.items():
                if not isinstance(v, dict) or "ok" not in v \
                        or "threshold" not in v:
                    problems.append(f"line {i + 1}: alarm {name!r} without "
                                    f"ok/threshold verdict")
        elif "alarms" in row:
            problems.append(f"line {i + 1}: alarms is not a verdict dict")
        acc = row.get("accepted")
        ups = row.get("uploads")
        if isinstance(acc, int) and isinstance(ups, int) and acc > ups:
            problems.append(f"line {i + 1}: accepted {acc} > uploads {ups}")
    return problems



def phase_medians(rows: List[dict],
                  skip_first: bool = True) -> Dict[str, float]:
    """Median per-phase seconds across the ledger (plus ``round_s``).
    The first round is skipped by default: it pays the jit compiles and
    would poison both sides of a comparison — even (especially) when it
    is the ONLY round, since a one-round smoke gated against a
    steady-state baseline would read its compile cost as a regression.
    A single-round ledger therefore yields no medians."""
    if skip_first:
        rows = rows[1:]
    acc: Dict[str, List[float]] = {}
    for row in rows:
        for name, dt in (row.get("phases") or {}).items():
            acc.setdefault(name, []).append(float(dt))
        if row.get("round_s") is not None:
            acc.setdefault("round_s", []).append(float(row["round_s"]))
    return {name: statistics.median(vals) for name, vals in acc.items()}


def check_recompiles(rows: List[dict]) -> List[str]:
    """Rounds after the ledger's first line with recompiles > 0."""
    return [f"round {row.get('round')}: {row['recompiles']} recompile(s) "
            f"after the baseline round "
            f"({row.get('recompiled', {})})"
            for row in rows[1:] if row.get("recompiles")]


def device_compile_seconds(rows: List[dict]) -> Optional[float]:
    """Total registered-hot-jit compile wall seconds across the ledger
    (round 0 INCLUDED — compile cost lives there, so the device gate
    must not skip it the way phase medians do).  None when no line
    carries a device section (pre-device-observatory ledger)."""
    total, seen = 0.0, False
    for row in rows:
        dev = row.get("device")
        if not isinstance(dev, dict):
            continue
        seen = True
        for e in dev.get("compiles") or []:
            try:
                total += float(e.get("wall_s") or 0.0)
            except (TypeError, ValueError):
                continue
    return total if seen else None


def device_mem_peak_bytes(rows: List[dict]) -> Optional[int]:
    """Largest per-device memory watermark anywhere in the ledger
    (round peak preferred, falling back to backend-lifetime peak, then
    the in-use sample).  None when no line measured device memory."""
    peak = None
    for row in rows:
        dev = row.get("device")
        if not isinstance(dev, dict):
            continue
        for e in dev.get("memory") or []:
            for key in ("round_peak_bytes", "peak_bytes", "bytes_in_use"):
                v = e.get(key)
                if v is not None:
                    peak = max(peak or 0, int(v))
                    break
    return peak


def compare_device(current: List[dict], baseline: List[dict],
                   noise_frac: float = 0.25,
                   min_abs_compile_s: float = 0.05,
                   min_abs_mem_bytes: int = 16 << 20) -> List[str]:
    """Device-layer regressions of ``current`` vs ``baseline``: total
    hot-jit compile time and the device-memory watermark, each gated by
    BOTH a relative band and an absolute floor (the phase-gate
    discipline).  Ledgers without device sections on either side
    compare vacuously — old ledgers never fail the new gate."""
    out: List[str] = []
    cc, cb = device_compile_seconds(current), device_compile_seconds(baseline)
    if cc is not None and cb is not None \
            and cc > cb * (1.0 + noise_frac) and (cc - cb) > min_abs_compile_s:
        ratio = (cc / cb) if cb else float("inf")
        out.append(f"device compile regression: total hot-jit compile "
                   f"{cb * 1e3:.1f}ms -> {cc * 1e3:.1f}ms ({ratio:.2f}x)")
    mc, mb = device_mem_peak_bytes(current), device_mem_peak_bytes(baseline)
    if mc is not None and mb is not None \
            and mc > mb * (1.0 + noise_frac) and (mc - mb) > min_abs_mem_bytes:
        ratio = (mc / mb) if mb else float("inf")
        out.append(f"device memory regression: watermark "
                   f"{mb / 2 ** 20:.1f}MiB -> {mc / 2 ** 20:.1f}MiB "
                   f"({ratio:.2f}x)")
    return out


def compare_ledgers(current: List[dict], baseline: List[dict],
                    noise_frac: float = 0.25,
                    min_abs_s: float = 0.005) -> List[dict]:
    """Per-phase regressions of ``current`` vs ``baseline`` medians.
    A phase regresses when it exceeds the baseline by BOTH the relative
    noise band and the absolute floor."""
    cur = phase_medians(current)
    base = phase_medians(baseline)
    out = []
    for name in sorted(base):
        b, c = base[name], cur.get(name)
        if c is None:
            continue  # phase absent this run (e.g. checkpointing off)
        if c > b * (1.0 + noise_frac) and (c - b) > min_abs_s:
            out.append({"phase": name, "baseline_s": b, "current_s": c,
                        "ratio": (c / b) if b else float("inf")})
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _expand(patterns: List[str]) -> List[str]:
    paths: List[str] = []
    for pat in patterns:
        # a pattern matching nothing passes through verbatim — the lint
        # then reports it unreadable, loudly
        paths.extend(sorted(_glob.glob(pat)) or [pat])
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="perf_trend",
        description="Perf regression gate over flight-recorder ledgers "
                    "(+ the mfu<=1.0 timing-trust lint). Exit 0 = pass, "
                    "1 = regression/lint failure, 2 = missing inputs.")
    p.add_argument("--ledger", default=None,
                   help="current run's perf.jsonl")
    p.add_argument("--baseline", default=None,
                   help="baseline perf.jsonl to gate against (optional: "
                        "without it only schema + recompile checks run)")
    p.add_argument("--noise", type=float, default=0.25,
                   help="relative noise band a phase must exceed to count "
                        "as a regression (default 0.25 = +25%%)")
    p.add_argument("--min_abs_ms", type=float, default=5.0,
                   help="absolute floor (ms) a regression must also exceed")
    p.add_argument("--lint_mfu", nargs="*", default=None, metavar="GLOB",
                   help="JSON artifacts (globs ok) to lint for "
                        "unretracted mfu > 1.0")
    p.add_argument("--no_recompile_gate", action="store_true",
                   help="skip the recompiles-after-round-0 gate")
    p.add_argument("--no_device_gate", action="store_true",
                   help="skip the device compile-time/memory gates "
                        "(obs/device.py sections)")
    p.add_argument("--min_abs_compile_ms", type=float, default=50.0,
                   help="absolute floor (ms) a total-compile-time "
                        "regression must also exceed")
    p.add_argument("--min_abs_mem_mb", type=float, default=16.0,
                   help="absolute floor (MiB) a device-memory watermark "
                        "regression must also exceed")
    p.add_argument("--health_ledger", default=None,
                   help="health.jsonl to schema-validate (obs/health.py): "
                        "a malformed health ledger fails the gate, not "
                        "the reader that trusts it later")
    args = p.parse_args(argv)
    if args.ledger is None and not args.lint_mfu \
            and args.health_ledger is None:
        p.print_usage()
        print("perf_trend: nothing to do (pass --ledger, --health_ledger "
              "and/or --lint_mfu)")
        return 2

    failures: List[str] = []

    if args.ledger is not None:
        try:
            rows = load_ledger(args.ledger)
        except (OSError, ValueError) as e:
            print(f"perf_trend: cannot read ledger: {e}")
            return 2
        problems = validate_ledger(rows)
        failures += [f"ledger schema: {x}" for x in problems]
        if not problems:
            print(f"ledger: {len(rows)} rounds, phases "
                  f"{sorted({k for r in rows for k in r['phases']})}")
        if not args.no_recompile_gate:
            failures += [f"recompile gate: {x}"
                         for x in check_recompiles(rows)]
        if args.baseline is not None:
            try:
                base = load_ledger(args.baseline)
            except (OSError, ValueError) as e:
                print(f"perf_trend: cannot read baseline: {e}")
                return 2
            if len(rows) < 2:
                # the only round pays the jit compiles; gating it against
                # a steady-state baseline would flag compile cost as a
                # regression — say so instead of a hollow "no regression"
                print("phase gate: ledger has no steady-state rounds "
                      "after the compile-paying first round — nothing "
                      "to compare (run >= 2 rounds for a gateable "
                      "ledger)")
            else:
                regressions = compare_ledgers(
                    rows, base, noise_frac=args.noise,
                    min_abs_s=args.min_abs_ms / 1e3)
                for r in regressions:
                    failures.append(
                        f"phase regression: {r['phase']} "
                        f"{r['baseline_s'] * 1e3:.1f}ms -> "
                        f"{r['current_s'] * 1e3:.1f}ms "
                        f"({r['ratio']:.2f}x, band +{args.noise:.0%})")
                if not regressions:
                    print(f"phase gate: no regression vs {args.baseline} "
                          f"(band +{args.noise:.0%}, floor "
                          f"{args.min_abs_ms:.1f}ms)")
            if not args.no_device_gate:
                # device gate (compile time + memory watermark): round 0
                # is in scope — compile cost lives there — so this runs
                # even on a one-round smoke.  Pre-device-observatory
                # ledgers on either side compare vacuously.
                if device_compile_seconds(rows) is None \
                        or device_compile_seconds(base) is None:
                    print("device gate: ledger(s) carry no device "
                          "section — skipped (pre-device-observatory "
                          "ledger, or --device_obs off)")
                else:
                    dev_regressions = compare_device(
                        rows, base, noise_frac=args.noise,
                        min_abs_compile_s=args.min_abs_compile_ms / 1e3,
                        min_abs_mem_bytes=int(args.min_abs_mem_mb
                                              * 2 ** 20))
                    failures += dev_regressions
                    if not dev_regressions:
                        print(f"device gate: no compile-time or "
                              f"device-memory regression vs "
                              f"{args.baseline} (band +{args.noise:.0%})")

    if args.health_ledger is not None:
        try:
            health_rows = load_ledger(args.health_ledger)
        except (OSError, ValueError) as e:
            print(f"perf_trend: cannot read health ledger: {e}")
            return 2
        problems = validate_health_ledger(health_rows)
        failures += [f"health ledger schema: {x}" for x in problems]
        if not problems:
            alarms = sum(1 for r in health_rows
                         for v in (r.get("alarms") or {}).values()
                         if not v.get("ok"))
            print(f"health ledger: {len(health_rows)} rounds, schema OK, "
                  f"{alarms} alarm verdict(s) fired")

    if args.lint_mfu:
        paths = _expand(args.lint_mfu)
        violations = lint_mfu_artifacts(paths)
        failures += [f"mfu lint: {v}" for v in violations]
        if not violations:
            print(f"mfu lint: {len(paths)} artifact(s) green "
                  f"(every mfu <= 1.0 or explicitly retracted)")

    if failures:
        for f_ in failures:
            print(f"FAIL {f_}")
        print(f"perf_trend: {len(failures)} failure(s)")
        return 1
    print("perf_trend: PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
