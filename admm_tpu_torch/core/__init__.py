"""Solver engines and proximal operators."""
