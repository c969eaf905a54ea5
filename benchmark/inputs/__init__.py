"""Inputs the benchmark makes from a run's seed, on the device, in a few
large draws: weights, rows and mels.  The program and the plain
reference are handed the same tensors."""
