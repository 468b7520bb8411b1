"""Multi-chain engine."""
