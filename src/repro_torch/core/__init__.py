"""Masks, mask sites, BCD and the candidate-evaluation engine."""
