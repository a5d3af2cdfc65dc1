"""Audio I/O, loaders and fixtures (numpy on the host)."""
