"""Serving workload: requests and the variable-length request stream."""
from .pipeline import Request, VarLenRequestStream  # noqa: F401
