"""The Engine runtime."""
