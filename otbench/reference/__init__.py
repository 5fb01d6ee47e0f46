"""Plain references of the benchmark: the upstream plane example, the
optimality check, and the byte arithmetic of the roofline metrics. NumPy and
SciPy only: nothing here imports the program."""
