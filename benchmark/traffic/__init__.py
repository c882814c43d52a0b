"""The benchmark's inputs: seeded clouds and the open-loop HTTP generator."""
