"""Atomic, asynchronous checkpoints of nested tensor and numpy trees."""
