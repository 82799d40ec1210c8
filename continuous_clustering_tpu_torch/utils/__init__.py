"""Helpers of the port's tools."""
