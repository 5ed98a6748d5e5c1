"""The ingest runtime: the raw-entry codec and the sink that drives the aggregator."""
