"""The port's command-line entry points: ct-fetch and storage-statistics."""
