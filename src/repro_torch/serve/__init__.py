"""Serving front door."""

from .query_service import QueryService, Ticket  # noqa: F401
