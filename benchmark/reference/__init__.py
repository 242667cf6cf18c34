"""The plain reference the benchmark holds the program to: float64 NumPy,
importing nothing of the program."""
