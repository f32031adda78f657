"""Columnar batches of the port."""
