"""Rendering ops: math, projection, binning, compositing kernels."""
