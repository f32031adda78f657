"""Metrics of the port: a local registry, the typed stat bundles and the
stage timer."""
