"""Inference surface of the port: the paged-KV serving engine."""
