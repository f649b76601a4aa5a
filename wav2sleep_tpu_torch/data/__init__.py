"""Host-side EDF reading and resampling for the port's serving pipelines (numpy only)."""
