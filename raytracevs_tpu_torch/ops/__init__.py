"""Render ops: sampling, intersection, shading and the frame renderer."""
