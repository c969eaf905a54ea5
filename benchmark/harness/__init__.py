"""The benchmark's own machinery: finding a cell's files by name, seeds,
the device and module guards, spans, the traced window and the run."""
