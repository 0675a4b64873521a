"""The default route's chain from a cached plan: one native call enqueues
the pixel kernel, the block pack, the segment merge and the stuffing
(``csrc/chain.cu``, ``jt_encode_chain``).

``encoder.device_encode`` and ``device_encode_batch`` run every call that
``encoder._chained`` admits from a plan (the default route,
``device_stuff=True``, ``pixel_path="nat"``, ``fuse_bp=False``, in a mode
of ``MODES``, on the card), but a shape with no pixels or whose segments
may reach 2^31 bits; every other call takes the per-kernel wrappers.
``plan`` checks the operands with the wrappers' own checks and raises
what they raise. ``Plan.encode`` gives the chain an image it can read as
the wrappers would: padded to whole MCUs (``fused_dctq.pad_mcus``,
counted in ``PADS.gathers``) where the width is not whole MCUs or the row
pad is as long as the image, else copied where it is not contiguous or
not 16-byte aligned.

A ``Plan`` is built on the first call of a shape and kept in the tables'
``plans`` (``EncoderTables``, which drops them whenever it moves), the
``KEPT`` shapes used last: the gain needs shapes that repeat, and a call
of a shape not kept builds its plan first (a few hundred microseconds of
Python, PERF.md). A plan holds what the wrappers work out on every call,
from the same functions (``fused_dctq.nat_view``, ``factored_sizes``,
``entropy_pack.dc_strides``, ``seg_merge_sizes``,
``compact.stuff_launcher``, ``stuff_scratch_words``, ``scan_capacity``),
and lays the intermediates out in two buffers; the device pointers of the
tables' factors, bias and LUTs, and the version counter of each: one
written in place, or replaced, makes the next call build the plan again.
A call allocates two buffers and the bounds from torch's caching
allocator and makes one foreign call, which reports the launchers it
called; each of their kernels' ``launches`` rises by that. ``PLANS``
counts plans built, calls served by a kept plan, and calls of the two
entry points that took the per-kernel path.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from jpegtpu_torch.config import EncoderConfig
from jpegtpu_torch.kernels import _build, compact, entropy_pack, fused_dctq
from jpegtpu_torch.kernels.fused_pipeline import FUSED_MODES as MODES

CHAIN = _build.Kernel("jt_encode_chain", [
    _build.PTR, _build.PTR,                           # plan, img
    _build.PTR, _build.PTR, _build.PTR,               # work, out, bounds
    _build.PTR])                                      # launched
# The kernels jt_encode_chain may launch, in the order of its launched[]:
# each entry 1 where the chain called that launcher and it returned 0.
CHAINED = (fused_dctq.PIXEL, fused_dctq.PIXEL_DC_PLANE,
           entropy_pack.BLOCK_PACK_SEGMENTS, entropy_pack.SEG_MERGE,
           compact.STUFF, compact.STUFF_CHUNKS)
# Alignment of every intermediate within its buffer, in bytes.
ALIGN = 256
# Plans an EncoderTables keeps, the shapes used last.
KEPT = 8


class ChainArgs(ctypes.Structure):
    """The mirror of ``csrc/chain.cu``'s ``ChainPlan``: every field 8
    bytes, in its order."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lum", "chroma", "bias", "dc_codes", "dc_lens", "ac_codes",
        "ac_lens", "mnum")] + [(name, ctypes.c_longlong) for name in (
            "n_mcu", "nrx", "row_bytes", "h", "my", "mh", "mw", "groups",
            "with_dc", "dc_stride", "dc_step", "g", "n_luma", "restart",
            "mcu_words", "n_seg", "mps", "seg_words", "spi", "chunks",
            "dc_at", "seg_bits_at", "merge_scratch_at", "stuff_scratch_at",
            "mlens_at")]


@dataclasses.dataclass
class PlanCounts:
    """How calls of ``device_encode`` and ``device_encode_batch`` went:
    ``built`` counts plans built (a rebuild too), ``hits`` calls served by
    a kept plan, ``fallbacks`` calls that took the per-kernel path. A run
    sets them to 0 before the work it checks and reads them after, as it
    does ``_build.Kernel.launches``."""
    built: int = 0
    hits: int = 0
    fallbacks: int = 0


PLANS = PlanCounts()


def _align(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


class Plan:
    """One call shape's chain on one ``EncoderTables``: images like imgs
    (padded to whole MCUs where ``pad``) in n_seg segments of mps MCUs,
    spi an image (a single image: all of n_seg). Build it with ``plan``."""

    def __init__(self, imgs: torch.Tensor, tables, subsampling: str,
                 restart: int, n_seg: int, mps: int, spi: int, batch: bool,
                 factors: tuple, luts: list):
        mh, mw, _, n_out = fused_dctq.fused_geometry(subsampling)
        h, w = imgs.shape[-3], imgs.shape[-2]
        self.fold = fused_dctq.row_fold(h, w, subsampling)
        self.pad = bool(h % mh or w % mw) and not self.fold
        if self.pad:
            h, w = -(-h // mh) * mh, -(-w // mw) * mw
        view = fused_dctq.nat_view(h, subsampling)
        sizes = fused_dctq.factored_sizes(
            (imgs.shape[0] if batch else 1) * view[1], w, mw)
        n_mcu, g = sizes[0], n_out // 64
        mcu_words = entropy_pack.mcu_words(g)
        seg_words, merge_words, _ = entropy_pack.seg_merge_sizes(
            n_seg, mps, mcu_words)
        with_dc = fused_dctq.PIXEL_DC
        stuff = compact.stuff_launcher(n_seg, batch)
        self.device, self.batch = imgs.device, batch
        mnum = compact.marker_table(n_seg, restart, spi, self.device)
        # The tables' tensors that the chain reads, and their versions; the
        # tensors it is given, held so that their pointers stay valid (the
        # marker table too: its cache may drop it).
        self.named = tuple((name, getattr(tables, name)) for name in (
            "lum", "chroma", "bias", "dc_codes", "dc_lens", "ac_codes",
            "ac_lens"))
        self.versions = tuple(t._version for _, t in self.named)
        self.held = (*factors, *luts, mnum)
        self.subsampling = subsampling
        self.n_bounds = n_seg // spi + 1
        # work: the coefficients (and DC plane), then the segments and
        # both scratches; out: the MCU streams and lengths, then the scan.
        dc_at = _align(4 * n_mcu * n_out)
        seg_bits_at = _align(4 * n_seg * seg_words)
        merge_at = _align(seg_bits_at + 4 * n_seg)
        stuff_at = merge_at + _align(8 * merge_words)
        self.work_bytes = max(
            dc_at + (4 * fused_dctq.DC_LANES * n_mcu if with_dc else 0),
            stuff_at + 8 * compact.stuff_scratch_words(n_seg, seg_words))
        mlens_at = _align(4 * n_mcu * mcu_words)
        self.out_bytes = max(compact.scan_capacity(n_seg, seg_words),
                             mlens_at + 4 * n_mcu)
        self.args = ChainArgs(
            *(t.data_ptr() for t in factors),
            *(t.data_ptr() for t in luts), mnum.data_ptr(),
            *sizes, *view, int(with_dc),
            *entropy_pack.dc_strides(
                g, fused_dctq.DC_LANES if with_dc else None),
            g, EncoderConfig(subsampling=subsampling).n_luma, restart,
            mcu_words, n_seg, mps, seg_words, spi,
            int(stuff is compact.STUFF_CHUNKS), dc_at, seg_bits_at,
            merge_at if merge_words else -1, stuff_at, mlens_at)
        self.address = ctypes.addressof(self.args)

    def current(self, tables) -> bool:
        """Whether the tables still hold the tensors the plan read, none
        written since."""
        buffers = tables._buffers
        return (all(buffers[name] is t for name, t in self.named) and
                tuple(t._version for _, t in self.named) == self.versions)

    def encode(self, imgs: torch.Tensor) -> tuple:
        """Enqueue the chain on imgs, of the plan's key, padded to whole
        MCUs where the plan pads, else copied where it is not contiguous or
        not 16-byte aligned: (u8 scan buffer, total bytes int64 scalar),
        and for a batch each image's first byte [n] int64, as the
        per-kernel path returns them. Each kernel the chain launched counts
        a launch (``CHAINED``), and K1 or K12 a fold where it folds, as the
        wrappers count them."""
        if self.pad:
            imgs = fused_dctq.pad_mcus(imgs, self.subsampling)
        elif imgs.data_ptr() % 16 or not imgs.is_contiguous():
            imgs = imgs.clone(memory_format=torch.contiguous_format)
        dev = self.device
        work = torch.empty(self.work_bytes, dtype=torch.uint8, device=dev)
        out = torch.empty(self.out_bytes, dtype=torch.uint8, device=dev)
        bounds = torch.empty(self.n_bounds, dtype=torch.int64, device=dev)
        launched = (ctypes.c_longlong * len(CHAINED))()
        CHAIN.launch(dev, self.address, imgs.data_ptr(), work.data_ptr(),
                     out.data_ptr(), bounds.data_ptr(),
                     ctypes.addressof(launched))
        for k, n in zip(CHAINED, launched):
            k.launches += n
        if self.fold:
            fused_dctq.PADS.folds += launched[0] + launched[1]
        if self.batch:
            return out, bounds[-1], bounds[:-1]
        return out, bounds[-1]


def plan(imgs: torch.Tensor, tables, subsampling: str, restart: int,
         n_seg: int, mps: int, spi: int, batch: bool) -> Plan:
    """The chain's plan for imgs (u8 [H, W, 3], or a batch [n, H, W, 3], on
    the card) in n_seg segments of mps MCUs, spi an image, on the tables of
    subsampling. Raises what the wrappers raise on these operands, from
    their checks: of the image and the operator's shape
    (``fused_dctq.operand_geometry``), the factors (``kernel_factors``),
    the LUTs (``entropy_pack.kernel_luts``), the restart interval and the
    devices (``_build.check_cuda``)."""
    fused_dctq.operand_geometry(imgs, tables.m, tables.bias, subsampling,
                                batch)
    factors = fused_dctq.kernel_factors(tables, subsampling)
    luts = entropy_pack.kernel_luts(tables.luts())
    entropy_pack.check_restart(restart)
    _build.check_cuda(*factors, *luts, device=imgs.device)
    return Plan(imgs, tables, subsampling, restart, n_seg, mps, spi, batch,
                factors, luts)
