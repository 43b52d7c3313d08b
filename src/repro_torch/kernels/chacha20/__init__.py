"""ChaCha20 (RFC 8439): shared round code, the stand-alone CUDA kernel and
the byte-payload encryption entry."""
