"""The plain reference of each configuration, one module per entry."""
