"""Hopper kernels (CUDA C++ under csrc/), their wrappers and plain versions."""
