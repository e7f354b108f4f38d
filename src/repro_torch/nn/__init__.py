"""Layers of the port: dense/norm/activation helpers, RoPE, paged attention."""
