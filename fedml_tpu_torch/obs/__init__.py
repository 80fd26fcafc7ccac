"""Observability: the telemetry registry (span tracing is not ported
yet)."""
