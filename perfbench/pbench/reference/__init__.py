"""Plain PyTorch references, one module per family; import nothing of the program."""
