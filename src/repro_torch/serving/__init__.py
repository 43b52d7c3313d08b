"""Serving layer of the port: so far the VPC NT chain (``vpc``)."""
