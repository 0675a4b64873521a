"""Bitstream packing, 1-padding, byte stuffing and RST splicing on torch
tensors (counterpart of ``jpegtpu.entropy.assemble``).

Words are u32 bit patterns held in int64: torch on the CPU implements
neither shifts nor ``+`` on ``torch.uint32``. Every symbol's bits span at
most two 32-bit big-endian words; two masked shifts and a scatter-add place
them. Bit ranges are disjoint, so add == or, and words that several symbols
share accumulate correctly. These are the plain twins of the segment-merge
and stuffing kernels (``csrc/seg_merge.cu``, ``csrc/stuff.cu``).
"""

from __future__ import annotations

from typing import Tuple

import torch

# Conservative static bound on coded bits per 8x8 block: 63 AC symbols of at
# most 16(code)+10(mag) bits plus a DC symbol of at most 11(code)+11(mag).
MAX_BITS_PER_BLOCK = 63 * 26 + 22
# Worst-case 32-bit words per block in the port's buffers (52).
WORDS_PER_BLOCK = -(-MAX_BITS_PER_BLOCK // 32)

_U32 = 0xFFFFFFFF


def to_i32_bits(words: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the same bit patterns as int32."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def from_i32_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their u32 values in int64."""
    return words.to(torch.int64) & _U32


def pack_words(lens: torch.Tensor, bits: torch.Tensor, n_seg: int,
               w_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack symbol slots into per-segment big-endian words.

    lens/bits: [n_seg * slots_per_seg] (any shape with that many elements),
    in stream order; bits right-aligned in the low `lens` bits, lens <= 32.
    Returns (words [n_seg, w_cap] int64 holding u32, seg_bits [n_seg]
    int64). A word past its segment's w_cap words is dropped; seg_bits
    still counts every bit.
    """
    dev = lens.device
    l = lens.reshape(n_seg, -1).to(torch.int64)
    v = bits.reshape(n_seg, -1).to(torch.int64)

    csum = torch.cumsum(l, dim=1)
    offs = csum - l
    seg_bits = csum[:, -1]

    w_idx = offs >> 5
    b_in_w = offs & 31
    n1 = torch.minimum(l, 32 - b_in_w)
    rem = l - n1                                     # bits spilling to word+1
    hi = (v >> rem) << (32 - b_in_w - n1)
    lo = (v & ((1 << rem) - 1)) << (32 - rem)
    hi = torch.where(l > 0, hi, 0)
    lo = torch.where(rem > 0, lo, 0)

    seg_base = (torch.arange(n_seg, device=dev) * w_cap)[:, None]
    spare = n_seg * w_cap
    words = torch.zeros(spare + 1, dtype=torch.int64, device=dev)
    # A word past its segment (an empty slot's, the spill word of a slot
    # that has none, or one that overflows w_cap) goes to a spare word,
    # dropped below.
    for w, part in ((w_idx, hi), (w_idx + 1, lo)):
        words.index_add_(0, torch.where(w < w_cap, seg_base + w, spare)
                         .reshape(-1), part.reshape(-1))
    return words[:-1].reshape(n_seg, w_cap), seg_bits


def pad_ones(words: torch.Tensor, seg_bits: torch.Tensor) -> torch.Tensor:
    """1-pad each segment's final partial byte (ITU-T T.81 F.1.2.3), in
    place: words [n_seg, W] int64 holding u32, zero past seg_bits. A byte
    past the W words is not padded."""
    n_seg, w_cap = words.shape
    tail = seg_bits & 7
    padb = (8 - tail) & 7
    b_in = seg_bits & 31
    padval = ((1 << padb) - 1) << (32 - b_in - padb)
    col = torch.clamp(seg_bits >> 5, max=w_cap - 1)
    rows = torch.arange(n_seg, device=words.device)
    words[rows, col] += torch.where((padb > 0) & (seg_bits >> 5 < w_cap),
                                    padval, 0)
    return words


def explode_bytes(words: torch.Tensor) -> torch.Tensor:
    """[n, W] int32/int64 words (u32 bit patterns) -> [n, 4W] int64
    big-endian bytes."""
    w = words.to(torch.int64)
    by = torch.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF,
                      (w >> 8) & 0xFF, w & 0xFF], dim=-1)
    return by.reshape(words.shape[0], 4 * words.shape[1])


def stuff_and_splice(by: torch.Tensor, nbytes: torch.Tensor,
                     seg_start: torch.Tensor, mnum: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """Scatter segment bytes to their stuffed positions: byte i of segment
    s lands at seg_start[s] + i + (#0xFF before i); the 0x00 after each
    0xFF comes from the zero-filled output; the RST marker 0xFF, mnum[s]
    follows segment s where mnum[s] != 0.

    by: [n_seg, B] int64 bytes, nbytes [n_seg] valid bytes per segment,
    seg_start [n_seg] stuffed start offsets, mnum [n_seg] marker numbers.
    Returns u8 [cap]."""
    dev = by.device
    pos = torch.arange(by.shape[1], device=dev)[None, :]
    valid = pos < nbytes[:, None]
    is_ff = ((by == 0xFF) & valid).to(torch.int64)
    shift = torch.cumsum(is_ff, dim=1) - is_ff
    out_pos = seg_start[:, None] + pos + shift
    out = torch.zeros(cap, dtype=torch.uint8, device=dev)
    out[out_pos[valid]] = by[valid].to(torch.uint8)
    marked = mnum > 0
    end = (seg_start + nbytes + is_ff.sum(dim=1))[marked]
    out[end] = 0xFF
    out[end + 1] = mnum[marked].to(torch.uint8)
    return out
