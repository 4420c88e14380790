"""The native host runtime of the out-of-core path: the C++ tile store
(``csrc/tilestore.cpp``, built at first use), its host stores
(:mod:`~dla_tpu_torch.runtime.staging`) and in-place host BLAS
(:mod:`~dla_tpu_torch.runtime.hostblas`). numpy and ctypes only."""
