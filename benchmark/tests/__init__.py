"""Tests of the benchmark itself (CPU, and ``card`` tests on the card)."""
