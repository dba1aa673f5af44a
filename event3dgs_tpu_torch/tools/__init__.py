"""Offline tooling: render products, evaluation, kernel timing."""
