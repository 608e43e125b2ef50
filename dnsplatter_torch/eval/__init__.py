"""Evaluation: image, depth and normal metrics and the dataset runner."""
