"""Device-side ops of the port: the length scan and the fused search."""
