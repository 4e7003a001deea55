from .wildcard import wildcard_match
from .quantity import parse_quantity, compare_quantities
from .duration import parse_duration

__all__ = ["wildcard_match", "parse_quantity", "compare_quantities", "parse_duration"]
