"""Measurement scripts of the port (run on the card; each prints the card's
name and power limit beside its numbers)."""
