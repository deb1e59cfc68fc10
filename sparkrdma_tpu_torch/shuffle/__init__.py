"""Reduce-side device fetch (the arena registry and the wave compiler)
and the SPMD TeraSort's range planning."""
