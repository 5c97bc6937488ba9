"""The request-id echo-safety check.

Counterpart of `safe_request_id` in paddle_tpu/observability/requests.py,
copied (importing it would import the JAX package). A layer that echoes
an inbound id on its replies (`X-Request-Id`, `X-Tenant-Id`) applies
these rules, or the echo becomes a response-header injection vector.
"""
from __future__ import annotations

__all__ = ["safe_request_id"]

# an echoed header carries CR/LF intact, so an unvalidated id is a
# response-header injection vector: RFC 7230 token chars only, bounded
# length
_RID_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    "!#$%&'*+-.^_`|~")
_RID_MAX = 128


def safe_request_id(rid):
    """The inbound id if it is safe to echo, else None (the caller then
    generates one)."""
    if not rid or not isinstance(rid, str) or len(rid) > _RID_MAX:
        return None
    if not all(c in _RID_CHARS for c in rid):
        return None
    return rid
