"""Schema types of the port."""
