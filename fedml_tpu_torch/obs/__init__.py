"""Observability: the port of ``fedml_tpu/obs/`` (stdlib only at import
time; torch loads inside the device probes).

    trace          span tracer; context rides Message headers under
                   ``_trace``; Perfetto trace_event export
    telemetry      counter/gauge/histogram registry; Prometheus text +
                   JSON snapshots
    critical_path  per-round overlap accounting of the receive path
    perf           the perf.jsonl flight recorder, the recompile sentry,
                   the SLO evaluator
    device         memory watermarks, the compile ledger, FLOPs and MFU
                   against the card's peak
    health         learning-health statistics + health.jsonl
    report         metrics + ledgers + traces -> one run report
                   (``python -m fedml_tpu_torch.obs.report``)
    trend          the perf/health ledger gates and the mfu lint
                   (``python -m fedml_tpu_torch.obs.trend``)

Trace and telemetry are process-global opt-ins (``enable()``); disabled
they are a null tracer / null registry and instrumented hot paths pay a
single branch per event.  Enable BEFORE constructing transports/actors —
instrumented constructors cache their metric handles.
"""

from fedml_tpu_torch.obs.device import DeviceRecorder
from fedml_tpu_torch.obs.health import HealthAccumulator
from fedml_tpu_torch.obs.perf import (PerfRecorder, RecompileError,
                                      RecompileSentry, RssSampler,
                                      SloEvaluator)
from fedml_tpu_torch.obs.telemetry import (NullRegistry, TelemetryRegistry,
                                           start_http_server)
from fedml_tpu_torch.obs.trace import Span, SpanContext, SpanTracer

__all__ = ["NullRegistry", "TelemetryRegistry", "start_http_server",
           "Span", "SpanContext", "SpanTracer",
           "DeviceRecorder", "HealthAccumulator", "PerfRecorder",
           "RecompileError", "RecompileSentry", "RssSampler",
           "SloEvaluator"]
