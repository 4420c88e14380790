"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each with its
plain torch version beside it: the trailing updates and the four task
kernels (``tiles``), the panel kernels (``panel``) and the df64 trailing
updates (``df64_tiles``)."""
