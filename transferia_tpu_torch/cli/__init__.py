"""The port's command-line interface (`python -m transferia_tpu_torch.cli.main`)."""
