"""Fixture: time quantities that drop or mix their units: an unsuffixed
dataclass field, and seconds added to milliseconds."""
from dataclasses import dataclass


@dataclass
class Window:
    start_s: float
    duration: float  # units-s violation: field


def deadline_s(start_s, budget_ms):
    return start_s + budget_ms  # units-s violation: seconds + milliseconds
