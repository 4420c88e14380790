"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each with its
plain torch version beside it."""
