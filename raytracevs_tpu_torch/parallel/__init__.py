"""Row-sharded rendering over several devices (parallel/tiles.py)."""
