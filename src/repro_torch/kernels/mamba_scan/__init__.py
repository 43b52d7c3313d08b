"""Mamba (S6) selective scan with a carried state: the CUDA kernel's
wrapper, the device-dispatching op and the plain version."""
from .kernel import mamba_ssm_cuda  # noqa: F401
from .ops import segmented_scan, selective_scan  # noqa: F401
from .ref import mamba_ssm_ref  # noqa: F401
