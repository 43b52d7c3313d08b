"""A recurrent scan over fixed-length segments, under autograd: the port of
the JAX package's ``jax.lax.scan(jax.checkpoint(seg), state, xs)`` in
``models/mamba.py::ssm_scan`` and ``models/rwkv6.py::wkv_scan``.

The forward runs one scan a segment (the CUDA kernel on the card, its plain
version on the CPU), each from the previous segment's final state, and
keeps only the state entering each segment, as ``jax.checkpoint`` keeps
only a segment's carry.  The backward walks the segments in reverse: it
recomputes each with the plain scan from its saved state under autograd
and takes the gradient of (y, final state) with respect to the segment's
inputs, the parameters and the state it started from, which it carries to
the segment before.  The JAX package has no backward kernel for either
scan; it differentiates the checkpointed ``lax.scan``.

A scan here is ``fn(*seq, *params, state) -> (y, final_state)``, where each
``seq`` tensor is (B, S, ...) and is cut along S, ``params`` are passed to
every segment whole, and ``state`` may be None (zero).
"""
from __future__ import annotations

import torch


def segment_length(S: int, chunk: int) -> int:
    """The JAX package's segment rule: ``min(chunk, S)``, and one segment
    of all S steps when that does not divide S."""
    c = min(chunk, S)
    return S if S % c else c


class SegmentedScan(torch.autograd.Function):
    """``apply(scan, ref, chunk, n_seq, state, *inputs) -> (y, state)``:
    ``inputs[:n_seq]`` are the sequence tensors, the rest the parameters;
    ``scan`` runs a segment forward and ``ref`` (the plain scan, which
    autograd can differentiate) recomputes it in the backward."""

    @staticmethod
    def forward(ctx, scan, ref, chunk, n_seq, state, *inputs):
        seq, params = inputs[:n_seq], inputs[n_seq:]
        S = seq[0].shape[1]
        c = segment_length(S, chunk)
        ys, starts = [], []
        for s0 in range(0, S, c):
            starts.append(state)
            y, state = scan(*(a[:, s0:s0 + c].contiguous() for a in seq),
                            *params, state)
            ys.append(y)
        ctx.meta = (ref, c, n_seq, len(inputs))
        ctx.save_for_backward(*inputs, *starts)
        return torch.cat(ys, 1) if len(ys) > 1 else ys[0], state

    @staticmethod
    def backward(ctx, dy, d_state):
        ref, c, n_seq, n_in = ctx.meta
        saved = ctx.saved_tensors
        seq, params, starts = saved[:n_seq], saved[n_seq:n_in], saved[n_in:]
        d_seq: list[list] = [[] for _ in seq]
        d_params = None
        for i in reversed(range(len(starts))):
            s0 = i * c
            with torch.enable_grad():
                xs = [a[:, s0:s0 + c].detach().requires_grad_() for a in seq]
                ps = [p.detach().requires_grad_() for p in params]
                st = starts[i]
                if st is not None:
                    st = st.detach().requires_grad_()
                y, out = ref(*xs, *ps, st)
                wrt = xs + ps + ([] if st is None else [st])
                g = torch.autograd.grad((y, out), wrt,
                                        (dy[:, s0:s0 + c], d_state))
            for acc, gi in zip(d_seq, g[:n_seq]):
                acc.append(gi)
            gp = g[n_seq:n_in]
            d_params = gp if d_params is None else \
                [a + b for a, b in zip(d_params, gp)]
            d_state = g[n_in] if st is not None else None
        d_seq = [torch.cat(acc[::-1], 1) for acc in d_seq]
        return (None, None, None, None, d_state, *d_seq, *d_params)


def segmented(scan, ref, chunk: int, seq, params, state):
    """(y, final state) of ``scan`` over ``chunk``-step segments (see
    :class:`SegmentedScan`)."""
    return SegmentedScan.apply(scan, ref, chunk, len(seq), state, *seq,
                               *params)


__all__ = ["SegmentedScan", "segment_length", "segmented"]
