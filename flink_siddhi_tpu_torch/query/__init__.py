from .parser import parse_plan, parse_query, SiddhiQLError
from . import ast

__all__ = ["parse_plan", "parse_query", "SiddhiQLError", "ast"]
