"""Resilience of the port: the engine's overload degradation ladder."""
