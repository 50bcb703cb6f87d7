"""Plain references: PyTorch only, nothing of the program."""
