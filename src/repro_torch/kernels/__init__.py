"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the wrappers that pick one by device (``ops``)."""
