"""Attention helpers shared by the model code."""
