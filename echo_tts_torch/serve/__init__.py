"""Serving layer of the port (so far: the model cache, serve/models.py)."""
