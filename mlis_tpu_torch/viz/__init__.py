"""Figures (matplotlib, Agg), the paper figure reproductions and Foxglove layouts."""
