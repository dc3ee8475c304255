"""Observability: device-time profiles of the port on the card."""
