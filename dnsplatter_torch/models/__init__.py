"""Gaussian state, losses used by the metrics, and the DN-Splatter model."""
