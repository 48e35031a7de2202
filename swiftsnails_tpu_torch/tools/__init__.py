"""Tools of the port: ``python -m swiftsnails_tpu_torch.tools.<name>``."""
