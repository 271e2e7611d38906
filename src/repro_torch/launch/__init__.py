"""Functions that wire models to evaluators."""
