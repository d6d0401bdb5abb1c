"""Helpers of the training step: level flattening and step diagnostics."""
