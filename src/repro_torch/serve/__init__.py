"""Serving-side ACE: the request guardrail (``engine``) and the open-loop
front end that batches, queues and sheds in front of it (``frontend``)."""
