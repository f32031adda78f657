"""Metrics of the port: a local registry and the typed stat bundles."""
