"""Log-density models."""
