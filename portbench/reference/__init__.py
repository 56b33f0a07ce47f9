"""The yardstick: the plain reference models, their initialisation rule, and
the counts of work and the peaks that the per-layer shares are taken against.

Plain PyTorch and NumPy only. Nothing here imports ``cfdbench_tpu_torch`` or
the JAX package, and nothing here takes what the program made: every tensor
it reads was made by the benchmark from the seed, or is the program's output
that it judges.
"""
