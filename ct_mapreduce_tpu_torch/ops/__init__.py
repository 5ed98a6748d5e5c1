"""Device ops of the port: the DER walker, SHA-256 fingerprints, the
bucket table and the two ingest steps."""
