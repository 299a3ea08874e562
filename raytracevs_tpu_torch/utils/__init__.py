"""Host utilities."""
