"""Serving runtime of the port: frozen DONN inference and the LM steps."""
