"""Operators of the port. Each kernel module holds the CUDA wrapper, its
plain PyTorch version and its launch counter ``LAUNCHES``."""
