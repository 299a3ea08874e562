"""Command-line surface (cli.py)."""
