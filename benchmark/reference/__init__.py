"""The plain references the program is held against: NumPy and PyTorch
only, nothing of the program."""
