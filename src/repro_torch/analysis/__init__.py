"""Cost models used by the evaluation engine."""
