"""Multi-process plumbing of the port (``repro/distributed``): the fleet fan-out's runtime queries."""
