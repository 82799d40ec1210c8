"""Measurement set-up of the port (throughput runs on the card)."""
