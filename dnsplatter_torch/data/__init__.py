"""Scene data: synthetic scenes and image output."""
