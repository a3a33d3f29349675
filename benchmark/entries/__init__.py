"""Drivers of the program's entries, one module per entry a configuration names."""
