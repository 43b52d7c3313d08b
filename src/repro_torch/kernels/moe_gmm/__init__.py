"""Grouped matmul for the MoE expert FFNs: the CUDA kernel's wrapper, the
device-dispatching op and the plain version."""
from .kernel import moe_gmm_cuda  # noqa: F401
from .ops import GroupedMatmul, grouped_matmul  # noqa: F401
from .ref import moe_gmm_ref  # noqa: F401
