"""The benchmark's one error type."""


class NoResult(Exception):
    """The run cannot give a result; the message says why (standard error)."""
