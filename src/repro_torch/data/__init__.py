"""The step-indexed synthetic data stream: the JAX package's ``data``."""
from .pipeline import Prefetcher, SyntheticLM, pack_documents  # noqa: F401
