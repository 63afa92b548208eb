"""Helpers without a device: strict JSON."""
