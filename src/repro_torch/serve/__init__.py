"""Serving-side ACE: the request guardrail."""
