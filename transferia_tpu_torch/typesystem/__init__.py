"""Type-mapping rules and versioned fallbacks of the port."""
