"""Execution services (reference: presto_tpu/execution). This slice
ports the co-fragment dynamic filters."""
