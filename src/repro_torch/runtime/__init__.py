"""Serving runtime of the port (frozen DONN inference)."""
