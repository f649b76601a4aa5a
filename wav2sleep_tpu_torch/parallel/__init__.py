"""Host-side task parallelism (ingest's fan-out over processes and hosts)."""
