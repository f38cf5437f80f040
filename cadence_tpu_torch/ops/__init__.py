"""Tensor layout, packer, replay kernel and dispatcher."""
