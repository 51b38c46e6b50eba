"""MetricsQL: the AST, the parser and the optimizer.

The port's copy of ``victoriametrics_tpu/query/metricsql/__init__.py``,
whole.
"""

from .ast import (AggrFuncExpr, BinaryOpExpr, DurationExpr, FuncExpr,
                  MetricExpr, NumberExpr, RollupExpr, StringExpr)
from .parser import parse, ParseError

__all__ = ["parse", "ParseError", "AggrFuncExpr", "BinaryOpExpr",
           "DurationExpr", "FuncExpr", "MetricExpr", "NumberExpr",
           "RollupExpr", "StringExpr"]
