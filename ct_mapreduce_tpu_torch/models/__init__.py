"""The port's entry point: config → aggregator → ingest/drain."""
