"""The plain reference that decides `correct`.

Plain NumPy and PyTorch, frozen with the benchmark. It imports nothing of
the port (`repro_torch`), of its JAX original or of `jax`, and takes nothing
the program made: it works the code, the decode and the queueing out again
from the configuration and from the inputs the harness drew.
"""
