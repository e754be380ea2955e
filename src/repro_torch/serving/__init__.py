"""Serving: the paged continuous-batching engine and its parts."""
