"""Device-count configuration (the mesh itself is ROADMAP queue 1 item 12)."""
