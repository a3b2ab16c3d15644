"""The plain reference: frozen plain-PyTorch copies of what the check
compares, importing nothing of the program."""
