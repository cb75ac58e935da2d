"""The eval protocol: evaluator, metrics and scorer."""
