"""Plugins and experiment writers."""
