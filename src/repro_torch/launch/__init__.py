"""Launch layer: the serve entry points (prefill, greedy decode step)."""
