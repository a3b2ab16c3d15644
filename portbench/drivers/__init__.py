"""One driver per entry of the program that a configuration names."""
