"""Serving engine of the port: collector, serving step, engine loop."""
