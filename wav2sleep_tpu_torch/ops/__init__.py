"""Device ops of the port: the hand-written kernels and their plain versions."""
