"""Plain PyTorch reference of the benchmarked paths, frozen.

Copies of the port's plain arithmetic at the time the benchmark was
written: the u32 RNG contract (``rng``), the fp32 math it needs
(``mathx``), ``fast_init`` with its Perlin food (``init``), the plain
lattice step with the Jones and MLP-family (wide) rules and the pinned
folds (``step``), and full-covariance CMA-ES with the training generation's
key schedule (``es``).  Nothing here imports the program, JAX or the JAX
package, and nothing takes a weight, table or state the program made: the
benchmark hands both sides the same seed-made inputs and this package works
out the rest again.
"""
