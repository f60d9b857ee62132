"""Experiment-harness primitives shared by quality and ablation experiments."""
