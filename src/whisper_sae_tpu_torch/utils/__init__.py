"""Device, checkpoint and profiling helpers."""
