"""The harness: finds cells, configurations, traffic and metrics by name and runs one cell."""
