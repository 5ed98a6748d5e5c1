"""Device ops of the port: SHA-256 fingerprints, the bucket table and
the pre-parsed step."""
