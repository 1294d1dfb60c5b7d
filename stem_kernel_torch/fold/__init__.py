"""Base-pair probabilities: energy model, LUTs, scaled McCaskill engine."""
