"""The plain reference that decides `correct`: NumPy and plain torch only.

Nothing here imports the port, jax or the JAX package, and nothing here
takes what the port made: the sequences are read back from the FASTA
files the benchmark wrote, and the port's output records are only read
to be judged.
"""
