"""Plain PyTorch references of what the timed paths compute, and the
comparisons that decide ``correct``.  Nothing here imports the program."""
