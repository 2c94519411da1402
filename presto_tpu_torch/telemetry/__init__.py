"""Counters of the port (presto_tpu/telemetry's ledger, traces and
metrics are not ported yet)."""
