"""Command-line entry points (`python -m plenoctree_tpu_torch.cli.<name>`)."""
