"""Feature cache and batch loader."""
