"""Runtime plumbing of the port: environment knobs and device resolution."""
