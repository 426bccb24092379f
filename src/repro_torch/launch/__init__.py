"""Entry points: the serving CLI and its step functions."""
