"""The plain reference: a right-looking blocked Cholesky and its two
triangular solves in plain PyTorch, in float64, on column panels, and the
comparisons that judge the program's answers.

It imports neither JAX nor anything of the program, and takes nothing the
program made: it starts from the inputs the benchmark made.
"""
