"""Dense LLaMA-style decoder: config, layers, attention, transformer."""
