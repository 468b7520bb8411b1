"""Task composition and chain results."""
