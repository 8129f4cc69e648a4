"""Detection models."""
