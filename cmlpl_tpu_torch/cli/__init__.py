"""Command-line entry points: predict (one-shot) and serve (JSON lines)."""
