"""Usage metering of the port."""
