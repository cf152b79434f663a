"""The benchmark's plain reference: the graphs and the checks of a colouring.

Plain PyTorch and NumPy.  Nothing here imports jax, the JAX package or
the package under test, and nothing here takes a number the package
under test made: each graph is derived again from its definition and
seed, and a colouring is judged against that.
"""
