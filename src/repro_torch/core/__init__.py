"""Prediction tree, speculative machinery and the PipeDec engine."""
