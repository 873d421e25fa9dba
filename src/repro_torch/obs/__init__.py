"""Observability of the port (host timers)."""
