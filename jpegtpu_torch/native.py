"""Host stuffing of a compacted stream (counterpart of
``jpegtpu.native.stuff_assemble_contig``; a numpy copy, because
``jpegtpu.native`` imports jpegtpu and so JAX). jpegtpu's C++ library is
not ported: one vectorised insert does the work."""

from __future__ import annotations

import numpy as np


def stuff_assemble_contig(stream: np.ndarray, nbytes: np.ndarray,
                          restart: int) -> bytes:
    """Back-to-back segment bytes (``compact.compact_segments``) and each
    segment's byte count -> the entropy-coded scan: a 0x00 after every
    0xFF byte, and the RST marker 0xFF, 0xD0 + s % 8 after every segment s
    but the last when restart > 0 (ITU-T T.81 B.1.1.5, B.2.1.2). Reads the
    first ``sum(nbytes)`` bytes of stream."""
    nbytes = np.asarray(nbytes, np.int64).reshape(-1)
    stream = np.ascontiguousarray(stream, np.uint8).reshape(-1)
    stream = stream[:int(nbytes.sum())]
    pos = [np.flatnonzero(stream == 0xFF) + 1]
    val = [np.zeros(pos[0].size, np.uint8)]
    if restart > 0 and nbytes.size > 1:
        ends = np.cumsum(nbytes[:-1])
        pos.append(np.repeat(ends, 2))
        val.append(np.stack([np.full(ends.size, 0xFF),
                             0xD0 + np.arange(ends.size) % 8], axis=1)
                   .reshape(-1).astype(np.uint8))
    # np.insert places values that share an index in the order given, so a
    # segment's last 0xFF gets its 0x00 before the marker that follows it.
    return np.insert(stream, np.concatenate(pos),
                     np.concatenate(val)).tobytes()
