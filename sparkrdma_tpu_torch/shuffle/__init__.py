"""Reduce-side device fetch: the arena registry and the wave compiler."""
