"""Data-side helpers of the port (featurisation)."""
