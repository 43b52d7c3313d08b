"""Fused VPC datapath: firewall -> NAT -> ChaCha20 in one CUDA launch
(packet state stays in registers across all three NTs)."""
from .ops import vpc_datapath  # noqa: F401
from .ref import vpc_datapath_ref  # noqa: F401
