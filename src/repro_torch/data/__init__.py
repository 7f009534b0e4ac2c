"""Data: the synthetic Markov corpus and the frontend stubs."""
