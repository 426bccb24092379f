"""Atomic, resumable checkpoints (numpy npz)."""
