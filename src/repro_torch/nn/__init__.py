"""Layers of the port: dense/norm/activation helpers, RoPE, attention
(full-sequence, dense and paged caches), Mixture-of-Experts, the recurrent
blocks and ResNet."""
