"""Measurement scripts for the port's kernels, run on an NVIDIA card."""
