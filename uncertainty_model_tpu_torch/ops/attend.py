"""The core of EfficientAttention in the serving forward: both softmaxes,
the per-head context and its application, on (B, N, C) token maps.

``attend(keys, queries, values, heads, smax, keys_smax)`` softmaxes the
keys over the tokens (in ``keys_smax``'s formulation, default ``smax``)
and the queries over each head's channels (in ``smax``'s), forms each
head's context ``sum_n keys[n, k] values[n, v]`` and applies it to the
queries.  On a CUDA tensor it launches the hand-written kernel
``csrc/attend.cu`` (counted in ``attend.launches``), which reads the keys,
queries and values once, computes in f32 and rounds the output once; on a
CPU tensor it runs :func:`attend_plain`, two softmaxes and two einsums in
plain PyTorch.  The training model's ``models/layers.py::
EfficientAttention`` runs under autograd and shares none of this.

The kernel cuts each image's tokens into chunks (:func:`plan_attend`):
each chunk's blocks keep an online softmax of the keys (the running max,
the sum of the exponentials and the context they weight), the chunks'
partials are rescaled to the global max and summed, and the queries'
softmax and the product with the normalised context follow token by
token.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..models.layers import SMAX, softmax
from . import hand

THREADS = 256          # a block's threads (``csrc/attend.cu::kThreads``)
HEAD_DIMS = (4, 8, 16, 32, 64)   # the head widths the kernel is built for
GROUP_CHANNELS = 32    # the channels of a token a block reads, at least
BLOCKS_PER_SM = 16     # blocks a launch aims at, per SM
LANE_TOKENS = 8        # the fewest tokens a lane of a block takes
PARTIAL_BYTES = 4 << 20   # the chunks' partials stay within this, or an
                          # eighth of the keys' and values' bf16 bytes


def attend_plain(keys, queries, values, heads, smax, keys_smax=None):
    """EfficientAttention on (B, N, C) token maps: keys softmaxed over the
    tokens (in ``keys_smax``'s formulation, default ``smax``), queries
    over each head's channels (in ``smax``'s), per-head context."""
    b, n, c = keys.shape

    def split(t):
        return t.reshape(b, n, heads, c // heads)

    keys = softmax(split(keys), 1, keys_smax or smax)
    queries = softmax(split(queries), -1, smax)
    context = torch.einsum("bnhk,bnhv->bhkv", keys, split(values))
    return torch.einsum("bhkv,bnhk->bnhv", context, queries).reshape(b, n, c)


def context_threads(d: int) -> int:
    """The context kernel's threads a head: a thread a 4 x 8 block of its
    d x d context (4 x 4 where d is 4)."""
    return (d // 4) * (d // 8 if d >= 8 else 1)


class AttendPlan(NamedTuple):
    """How the kernel cuts a call: ``group`` heads a block, ``chunk``
    tokens a context block, ``block`` tokens an apply block."""
    group: int
    chunk: int
    block: int


def _cut(tokens: int, want: int, lane_cap: int, cost_cap: int) -> int:
    """Tokens a block: ``tokens`` cut into about ``want`` pieces, at most
    ``lane_cap`` and ``cost_cap`` of them (and at least one)."""
    pieces = max(1, min(want, lane_cap, cost_cap))
    return -(-tokens // pieces)


def plan_attend(batch: int, tokens: int, heads: int, d: int,
                sms: int) -> AttendPlan:
    """The kernel's cut of a (batch, tokens, heads x d) call on a card of
    ``sms`` SMs.  A block takes the fewest heads that give it
    ``GROUP_CHANNELS`` channels of each token (whole 32-byte sectors in
    bf16) and whose threads (``context_threads``) divide ``THREADS``, so
    that its lanes fill the block and every warp is whole for the
    shuffles.  An (image, head group) is cut into enough chunks for
    ``BLOCKS_PER_SM`` blocks an SM, each lane taking at least
    ``LANE_TOKENS`` tokens, and into no more than keep the chunks'
    partials (d + 2 floats a head's k) within an eighth of the keys' and
    values' bf16 bytes or ``PARTIAL_BYTES`` in all; the apply blocks alike,
    each reading the group's d x d context."""
    tiles = context_threads(d)
    groups = [g for g in range(1, heads + 1)
              if heads % g == 0 and THREADS % (g * tiles) == 0]
    group = min([g for g in groups if g * d >= GROUP_CHANNELS]
                or [max(groups)])
    units = batch * (heads // group)
    want = -(-BLOCKS_PER_SM * sms // units)
    lanes = THREADS // (group * tiles)
    partial = 4 * units * group * d * (d + 2)
    chunk = _cut(tokens, want, tokens // (lanes * LANE_TOKENS),
                 max(tokens // (8 * (d + 2)), PARTIAL_BYTES // partial))
    lanes_a = THREADS // (group * d // 4)
    context = 4 * units * group * d * d
    block = _cut(tokens, want, tokens // (lanes_a * LANE_TOKENS),
                 max(tokens // (8 * d), PARTIAL_BYTES // context))
    return AttendPlan(group, chunk, block)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def attend(keys: torch.Tensor, queries: torch.Tensor, values: torch.Tensor,
           heads: int, smax: str, keys_smax: str | None = None
           ) -> torch.Tensor:
    """EfficientAttention's core on (B, N, C) token maps, ``heads`` heads
    of ``C / heads`` channels: :func:`attend_plain`'s function.  CPU
    tensors run the plain version; CUDA tensors (float32 or bfloat16, of
    one type, contiguous, head width in ``HEAD_DIMS``) launch the kernel or
    raise."""
    operands = (keys, queries, values)
    if keys.ndim != 3 or min(keys.shape) < 1 or any(
            t.shape != keys.shape for t in operands):
        shapes = [tuple(t.shape) for t in operands]
        raise ValueError(f"attend takes three equal non-empty (B, N, C) "
                         f"token maps, not {shapes}")
    b, n, c = keys.shape
    if c % heads:
        raise ValueError(f"attend: {c} channels do not split into {heads} "
                         "heads")
    keys_smax = keys_smax or smax
    if smax not in SMAX or keys_smax not in SMAX:
        raise ValueError(f"attend: softmax formulations {keys_smax!r}, "
                         f"{smax!r} not in {SMAX}")
    d = c // heads
    return hand.run(
        attend, operands,
        lambda: attend_plain(keys, queries, values, heads, smax, keys_smax),
        lambda: _attend_kernel(keys, queries, values, heads, smax,
                               keys_smax),
        flops=4 * b * n * heads * d * d)


def _attend_kernel(keys, queries, values, heads, smax, keys_smax):
    code = hand.check("attend", {"keys": keys, "queries": queries,
                                 "values": values}, aligned=True)
    b, n, c = keys.shape
    d = c // heads
    if d not in HEAD_DIMS:
        raise ValueError(f"attend kernel takes heads of {HEAD_DIMS} "
                         f"channels, not {d}")
    plan = plan_attend(b, n, heads, d, _sms(keys.device.index))
    floats = hand.c_function("umt_attend_work")(b, n, heads, d, plan.group,
                                                plan.chunk)
    if floats < 0:
        raise ValueError(f"attend: the kernel refuses {plan} for "
                         f"{tuple(keys.shape)}, {heads} heads")
    work = torch.empty(floats, dtype=torch.float32, device=keys.device)
    out = torch.empty_like(keys)
    hand.launch(attend, "umt_attend", keys.device, code,
                keys_smax != "nomax", smax != "nomax", keys.data_ptr(),
                queries.data_ptr(), values.data_ptr(), out.data_ptr(),
                work.data_ptr(), b, n, heads, d, plan.group, plan.chunk,
                plan.block)
    return out


attend.launches = 0
