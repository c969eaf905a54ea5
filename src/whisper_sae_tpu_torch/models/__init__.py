"""SAE models."""
