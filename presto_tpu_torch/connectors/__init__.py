"""Connector SPI + the tpch connector (reference: presto_tpu/connectors)."""
