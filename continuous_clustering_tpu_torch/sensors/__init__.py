"""Sensor inputs of the port: raw packets or point messages -> firings."""
