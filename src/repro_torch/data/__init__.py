"""Synthetic inputs made from a seed (numpy only)."""
