"""Runtime plumbing of the port: environment knobs, device resolution
and the replication loop (`runtime.local`)."""
