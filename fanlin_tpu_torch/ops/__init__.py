"""Device-side code of the port: planning, the CUDA resample kernel and
the torch transform chain."""
