"""Frontends bridging traced PyTorch programs into DHLO."""
