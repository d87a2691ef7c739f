"""Checkpoints of the trainers' states."""
