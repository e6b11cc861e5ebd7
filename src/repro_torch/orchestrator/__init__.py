"""Supervision contract shared by the port's entry points."""
