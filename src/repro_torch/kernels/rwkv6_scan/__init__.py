"""RWKV-6 WKV recurrence with a carried state: the CUDA kernel's wrapper,
the device-dispatching op and the plain version."""
from .kernel import rwkv6_wkv_cuda  # noqa: F401
from .ops import segmented_wkv, wkv  # noqa: F401
from .ref import rwkv6_wkv_ref  # noqa: F401
