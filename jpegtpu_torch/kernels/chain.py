"""The default route's chain from a cached plan: one native call enqueues
the pixel kernel, the block pack, the segment merge and the stuffing
(``csrc/chain.cu``, ``jt_encode_chain``).

``encoder.device_encode`` and ``device_encode_batch`` take this path on
CUDA tensors with ``pixel_path="nat"``, ``fuse_bp=False`` and
``device_stuff=True`` in a mode of ``FUSED_MODES``, for u8 images whose
width is whole MCUs and whose height is whole MCUs or folds
(``fused_dctq.row_fold``), contiguous at a 16-byte aligned address, where
no segment can reach 2^31 bits. Every other call takes the per-kernel
wrappers, which check their operands on every call. The two paths share
the kernels and no Python: the per-kernel path pays for its checks on
every call, this one once, when its plan is built.

A ``Plan`` is built on the first call of a shape and kept in the tables'
``plans`` (``EncoderTables``, which drops them whenever it moves), the
``KEPT`` shapes used last: the gain needs shapes that repeat, and a call
of a shape not kept builds its plan first (a few hundred microseconds of
Python, PERF.md). A plan holds what the wrappers work out on every call,
from the same functions (``fused_dctq.nat_view``, ``factored_sizes``,
``entropy_pack.dc_strides``, ``seg_merge_sizes``,
``compact.stuff_launcher``, ``stuff_scratch_words``, ``scan_capacity``),
and lays the intermediates out in two buffers; the device pointers of the
tables; and the version counter of every tensor of the tables it read: a
tensor written in place, or replaced, makes the next call build the plan
again (as ``fused_dctq._factored`` refactors). A call then checks the
image with attribute reads, allocates two buffers and the bounds from
torch's caching allocator, and makes one foreign call, which reports the
launchers it called; each of their kernels' ``launches`` rises by that.
Nothing is held across calls. ``PLANS`` counts plans built, calls served
by a kept plan, and calls of the two entry points that took the
per-kernel path.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from jpegtpu_torch.config import EncoderConfig
from jpegtpu_torch.kernels import _build, compact, entropy_pack, fused_dctq
from jpegtpu_torch.kernels.fused_pipeline import FUSED_MODES

CHAIN = _build.Kernel("jt_encode_chain", [
    _build.PTR, _build.PTR,                           # plan, img
    _build.PTR, _build.PTR, _build.PTR,               # work, out, bounds
    _build.PTR])                                      # launched
# The kernels jt_encode_chain may launch, in the order of its launched[]:
# each entry 1 where the chain called that launcher and it returned 0.
CHAINED = (fused_dctq.PIXEL, fused_dctq.PIXEL_DC_PLANE,
           entropy_pack.BLOCK_PACK_SEGMENTS, entropy_pack.SEG_MERGE,
           compact.STUFF, compact.STUFF_CHUNKS)
# The device the kernels run on: the only one a plan is built for.
DEVICE_TYPE = "cuda"
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
    """One shape's chain on one ``EncoderTables``: n_img images of h x w
    in segments of mps MCUs, spi an image (a single image: all of
    n_seg). Build it with ``plan``."""

    def __init__(self, tables, device: torch.device, n_img: int, h: int,
                 w: int, subsampling: str, restart: int, n_seg: int,
                 mps: int, spi: int, batch: bool, lum: torch.Tensor,
                 chroma: torch.Tensor):
        _, mw, _, n_out = fused_dctq.fused_geometry(subsampling)
        view = fused_dctq.nat_view(h, subsampling)
        sizes = fused_dctq.factored_sizes(n_img * view[1], w, mw)
        n_mcu, g = sizes[0], n_out // 64
        mcu_words = entropy_pack.mcu_words(g)
        seg_words, merge_words, _ = entropy_pack.seg_merge_sizes(
            n_seg, mps, mcu_words)
        with_dc = fused_dctq.PIXEL_DC
        stuff = compact.stuff_launcher(n_seg, batch)
        mnum = compact.marker_table(n_seg, restart, spi, device)
        # Every tensor the chain reads, held so that its pointer stays valid
        # (the marker table too: its cache may drop it), and its version.
        self.named = tuple((name, getattr(tables, name)) for name in (
            "m", "bias", "dc_codes", "dc_lens", "ac_codes", "ac_lens"))
        self.held = tuple(t for _, t in self.named) + (lum, chroma, mnum)
        self.versions = tuple(t._version for t in self.held)
        self.device, self.batch = device, batch
        self.n_bounds = n_seg // spi + 1
        self.fold = fused_dctq.row_fold(h, w, subsampling)
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
            lum.data_ptr(), chroma.data_ptr(), tables.bias.data_ptr(),
            *(t.data_ptr() for t in tables.luts()), mnum.data_ptr(),
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
                tuple(t._version for t in self.held) == self.versions)

    def admits(self, imgs: torch.Tensor) -> bool:
        """Whether the chain can read imgs (of the plan's shape) where it
        lies: u8 on the plan's device, contiguous, 16-byte aligned."""
        return (imgs.device == self.device and imgs.dtype == torch.uint8
                and imgs.is_contiguous() and imgs.data_ptr() % 16 == 0)

    def encode(self, imgs: torch.Tensor) -> tuple:
        """Enqueue the chain on imgs: (u8 scan buffer, total bytes int64
        scalar), and for a batch each image's first byte [n] int64, as the
        per-kernel path returns them. Each kernel the chain launched counts
        a launch (``CHAINED``), and K1 or K12 a fold where it folds, as the
        wrappers count them."""
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
         n_seg: int, mps: int, spi: int, batch: bool) -> Plan | None:
    """The chain's plan for imgs (u8 [H, W, 3], or a batch [n, H, W, 3])
    in n_seg segments of mps MCUs, spi an image, on the tables of
    subsampling; None where the call is not the chain's (module
    docstring), so the per-kernel path takes it and raises what it
    raises."""
    shape = imgs.shape
    if (subsampling not in FUSED_MODES or imgs.device.type != DEVICE_TYPE
            or len(shape) != 3 + batch or shape[-1] != 3 or 0 in shape):
        return None
    n_img, h, w = (shape[0] if batch else 1), shape[-3], shape[-2]
    mh, mw, n_in, n_out = fused_dctq.fused_geometry(subsampling)
    m, bias, luts = tables.m, tables.bias, tables.luts()
    if (w % mw or (h % mh and not fused_dctq.row_fold(h, w, subsampling))
            or restart < 0 or entropy_pack.seg_merge_sizes(
                n_seg, mps, entropy_pack.mcu_words(n_out // 64))[2]):
        return None
    if (tuple(m.shape) != (n_in, n_out) or tuple(bias.shape) != (n_out,)
            or m.dtype != torch.float32 or bias.dtype != torch.float32
            or not entropy_pack._luts_ok(luts)
            or any(t.dtype != torch.int32 for t in luts)
            or any(t.device != imgs.device or not t.is_contiguous()
                   for t in (m, bias, *luts))):
        return None
    try:
        lum, chroma = fused_dctq.cuda_factors(m, bias, subsampling)
    except ValueError:
        return None
    p = Plan(tables, imgs.device, n_img, h, w, subsampling, restart, n_seg,
             mps, spi, batch, lum, chroma)
    return p if p.admits(imgs) else None
