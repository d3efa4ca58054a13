"""Command-line entry points of the port (`python -m evoworld_tpu_torch.cli.<name>`)."""
