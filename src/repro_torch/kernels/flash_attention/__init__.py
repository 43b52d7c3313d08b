"""Flash attention forward (causal or full GQA): the CUDA kernel's wrapper,
the device-dispatching op on the model's layout, and the plain version."""
from .kernel import flash_attention_cuda  # noqa: F401
from .ops import flash_attention  # noqa: F401
from .ref import attention_ref  # noqa: F401
