"""How the program takes a configuration file, one module per model type."""
