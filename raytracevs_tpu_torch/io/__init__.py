"""Image I/O."""
