"""Serving: prefill and greedy decode over a fixed-capacity cache."""
