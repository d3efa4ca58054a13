"""Evaluation: metrics, feature networks, the reference-format harness, DreamSim."""
