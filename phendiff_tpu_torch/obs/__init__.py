"""Observability: trackers, step timing, and device-time profiles of the
port on the card."""
