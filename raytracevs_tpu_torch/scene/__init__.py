"""Scene description, sanitization and flattening (numpy host layer)."""
