"""Top-level encoder: uint8 images -> complete JFIF/JPEG bytes, on torch
(counterpart of ``jpegtpu.encoder``: ``_device_encode_pallas`` and
``_device_encode_pallas_batch``, ``Encoder.encode_to_scan`` / ``encode``,
``encode_batch`` / ``_encode_batch_fused``), for every subsampling mode,
restart interval, ``device_stuff``, ``pixel_path`` and ``fuse_bp`` setting.

The device program runs up to four kernels, with no torch glue between
them on the default path:

    pixel       fused_dctq.encode_blocks_batch  u8 -> coefficients, by the
                ``pixel_path`` route: "nat" the pixel kernel (or, with
                ``fused_dctq.PIXEL_DC``, the kernel that also writes the DC
                plane), "dma" the async-copy kernel (4:2:0), "xla" a
                float64 torch.matmul; the staged ops for gray and
                non-8-aligned 4:4:4s on every route
    block pack  entropy_pack.block_pack_mcu_segments  -> MCU bitstreams,
                each block's class and DC difference (from the DC plane
                where there is one) derived in the kernel
    or, with fuse_bp (4:2:0, 4:2:2, 4:4:4), for the two above
    fused       fused_pipeline.fused_pixel_block_pack_pairs  u8 -> MCU
                bitstreams, the DC differences in the kernel
    seg merge   entropy_pack.seg_merge_mcu          -> segment bitstreams,
                the MCU lengths scanned and a ragged last segment padded in
                the kernel
    stuffing    compact.compact_segments_stuffed_grouped (several segments)
                or compact.compact_segments_stuffed (one)  -> the scan
    or, without device_stuff,
    compaction  compact.compact_segments   -> the segments back to back

On the default route (CUDA tensors, "nat", no fuse_bp, device_stuff, a
mode of 4:2:0, 4:2:2 or 4:4:4) a call runs the pixel kernel, the block
pack, the segment merge and the stuffing from a plan cached per shape on
the tables, in one native call (``kernels/chain.py``; ``_chained``
decides which calls); every other call runs the wrappers above one by
one. Either way the host
fetches exactly the scan's bytes (without device_stuff: the
byte counts, then exactly the compacted bytes, which it stuffs with
``native.stuff_assemble_contig``) and wraps them in the JFIF headers. A
batch of same-shaped images runs one program whose kernels each launch
once, the images flattened into the MCU dimension. On a CUDA device the
hand-written kernels run; on the CPU (the tests pass ``device="cpu"``)
each stage runs its plain twin. Every buffer has its worst-case size, so
jpegtpu's first-pass bit budget and its re-run on overflow have no
counterpart here, and neither have its TPU-layout choices that change no
bytes (``mcu_group``, ``compact_groups``, the 8-way virtual split of a
single segment).
"""

from __future__ import annotations

import collections
import warnings
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from jpegtpu_torch import native
from jpegtpu_torch.config import EncoderConfig
from jpegtpu_torch.container import jfif
from jpegtpu_torch.core import ops, tables
from jpegtpu_torch.entropy import huffman_tables as ht
from jpegtpu_torch.kernels import (_build, chain, compact, entropy_pack,
                                   fused_dctq, fused_pipeline)


def block_operators(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """(block_m [2, 64, 64] f32, block_bias [2, 64] f32): the per-block
    operator of ``tables.fused_block_operator``, luma then chroma."""
    (m_l, b_l), (m_c, b_c) = (tables.fused_block_operator(quality, chroma)
                              for chroma in (False, True))
    return np.stack([m_l, m_c]), np.stack([b_l, b_c])


def operator_mode(m: np.ndarray) -> str | None:
    """The fused mode whose ``mcu_operator`` has m's shape and factors (a
    [192, 192] operator is 4:4:4s where its chroma groups are 2x2, else
    4:4:4); None for any other shape (gray's block operator)."""
    shapes = {(768, 384): "420", (384, 256): "422", (192, 192): "444"}
    mode = shapes.get(tuple(m.shape))
    if mode == "444":
        try:
            fused_dctq.factor_operator(m, "444s")
            return "444s"
        except ValueError:
            pass
    return mode


class EncoderTables(nn.Module):
    """The encoder's per-quality, per-mode state as device buffers: the
    fused MCU operator ``m`` [in, out] f32 and ``bias`` [out] f32 of the
    mode (``mcu_operator``; for gray, the luma block operator), its
    factors ``lum`` [192, 64] and ``chroma`` [G*3, 128] f32
    (``fused_dctq.factor_operator`` in the mode ``subsampling`` that
    ``operator_mode`` reads off m; None for gray), the staged path's
    ``block_m`` [2, 64, 64] and ``block_bias`` [2, 64] f32, and the packed
    Huffman LUTs ``dc_codes``/``dc_lens`` [2, 16] and ``ac_codes``/
    ``ac_lens`` [2, 256] int32 (index 0 luma, 1 chroma). The kernels and
    their plain twins read the same tensors. The factors are made from m
    and bias here, on the host, and nowhere else: a fused operator that
    does not factor raises ValueError. ``coefficient_bound`` (None for
    gray) is the largest magnitude a coefficient of m with bias can take
    (``fused_dctq.coefficient_bound``), which the fused kernel's int16 tile
    needs under 32,768. Every kernel the encoder runs on the card reads
    these factors and this bound (``fused_dctq.kernel_factors``), made
    when the tables were: a write to m changes neither. ``plans`` holds
    the default route's plans of the ``chain.KEPT`` call shapes used last
    (``chain.Plan``); moving the module drops them."""

    def __init__(self, m: torch.Tensor, bias: torch.Tensor,
                 dc_codes: torch.Tensor, dc_lens: torch.Tensor,
                 ac_codes: torch.Tensor, ac_lens: torch.Tensor,
                 block_m: torch.Tensor, block_bias: torch.Tensor):
        super().__init__()
        for name, t in (("m", m), ("bias", bias), ("block_m", block_m),
                        ("block_bias", block_bias)):
            self.register_buffer(name, t.to(torch.float32))
        for name, t in (("dc_codes", dc_codes), ("dc_lens", dc_lens),
                        ("ac_codes", ac_codes), ("ac_lens", ac_lens)):
            self.register_buffer(name, t.to(torch.int32))
        m_host = self.m.detach().cpu().numpy()
        self.subsampling = operator_mode(m_host)
        lum = chroma = self.coefficient_bound = None
        if self.subsampling is not None:
            lum, chroma = (torch.from_numpy(a).to(self.m.device) for a in
                           fused_dctq.factor_operator(
                               m_host, self.subsampling, self.bias))
            self.coefficient_bound = fused_dctq.coefficient_bound(
                m_host, self.bias)
        self.register_buffer("lum", lum)
        self.register_buffer("chroma", chroma)
        self.plans: collections.OrderedDict = collections.OrderedDict()

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self.plans = collections.OrderedDict()
        return out

    def __getstate__(self):
        # A plan holds the device pointers of these tensors: a copy (deepcopy,
        # pickle) builds its own.
        return {**super().__getstate__(),
                "plans": collections.OrderedDict()}

    @classmethod
    def from_numpy(cls, m: np.ndarray, bias: np.ndarray,
                   dc_codes: np.ndarray, dc_lens: np.ndarray,
                   ac_codes: np.ndarray, ac_lens: np.ndarray,
                   block_m: np.ndarray, block_bias: np.ndarray,
                   device: torch.device | str = "cpu") -> "EncoderTables":
        """Build from numpy arrays (``mcu_operator(q, mode)``,
        ``packed_luts()`` and ``block_operators(q)``, of this package or of
        jpegtpu); a fused operator is factored on the host."""
        as_t = lambda a, dt: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a).astype(dt))
        return cls(as_t(m, np.float32), as_t(bias, np.float32),
                   as_t(dc_codes, np.int32), as_t(dc_lens, np.int32),
                   as_t(ac_codes, np.int32), as_t(ac_lens, np.int32),
                   as_t(block_m, np.float32), as_t(block_bias, np.float32)
                   ).to(device)

    @classmethod
    def for_quality(cls, quality: int, subsampling: str = "420",
                    device: torch.device | str = "cpu") -> "EncoderTables":
        """The tables of one quality and mode, from this package's table
        copies."""
        if subsampling == "gray":
            m, bias = tables.fused_block_operator(quality, chroma=False)
        else:
            m, bias = fused_dctq.mcu_operator(quality, subsampling)
        return cls.from_numpy(m, bias, *ht.packed_luts(),
                              *block_operators(quality), device=device)

    def luts(self) -> Tuple[torch.Tensor, ...]:
        return self.dc_codes, self.dc_lens, self.ac_codes, self.ac_lens


def resolve_device(device: torch.device | str | None) -> torch.device:
    """None means "cuda". A CUDA device without CUDA raises: nothing falls
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("jpegtpu_torch: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def geometry(n_mcu: int, restart: int) -> Tuple[int, int]:
    """(n_seg, mcus_per_seg) of n_mcu MCUs at a concrete restart interval
    (jpegtpu's ``_geometry``, ``encoder.py:434-441``): restart 0 is one
    segment. An interval longer than the image is one segment of n_mcu
    MCUs here (jpegtpu pads it to `restart` zero-length MCUs, which add no
    bytes)."""
    if restart <= 0:
        return 1, n_mcu
    return -(-n_mcu // restart), min(restart, n_mcu)


class BatchGeometryError(ValueError):
    """A batch cannot take the one-program batch path (geometry only;
    genuine input errors raise plain ValueError)."""


def batch_segments(n_mcu: int, restart: int) -> int:
    """Segments per image of a batch program: restart segments must divide
    each image's MCU count, so that image boundaries are segment starts
    (jpegtpu's ``_jitted_encode_batch``, ``encoder.py:401-406``)."""
    if restart <= 0 or n_mcu % restart:
        raise BatchGeometryError(
            "batched encode requires restart segments dividing each "
            "image's MCU count (use restart_interval='rows')")
    return n_mcu // restart


def _segments(imgs: torch.Tensor, tables: EncoderTables, subsampling: str,
              restart: int, n_seg: int, mps: int, pixel_path: str = "nat",
              fuse_bp: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """u8 [n, H, W, 3] (gray [n, H, W]) -> (segment streams, seg_bits) of
    n_seg segments of mps MCUs over the images' MCUs in order, as
    jpegtpu's programs dispatch (``encoder.py:181-211, 316-337``): the
    fused front end with fuse_bp (4:2:0, 4:2:2, 4:4:4), else the pixel
    route of pixel_path and the block pack, which derives each block's
    class and DC difference (reset at every segment start; from the DC plane
    when ``fused_dctq.PIXEL_DC`` is set and the route is "nat", else from
    the coefficients); then the segment merge, which takes a ragged last
    segment as it is."""
    if fuse_bp and subsampling in fused_pipeline.FUSED_MODES:
        padded = fused_dctq.pad_mcus(imgs, subsampling)
        mwords, mlens = fused_pipeline.fused_pixel_block_pack_pairs(
            padded.reshape(-1, *padded.shape[2:]), tables, subsampling,
            restart)
    else:
        n_luma = EncoderConfig(subsampling=subsampling).n_luma
        with_dc = fused_dctq.PIXEL_DC and pixel_path == "nat"
        out = fused_dctq.encode_blocks_batch(imgs, tables, subsampling,
                                             pixel_path, with_dc)
        coeffs, dc = out if with_dc else (out, None)
        mwords, mlens = entropy_pack.block_pack_mcu_segments(
            coeffs, n_luma, restart, tables.luts(), dc)
    return entropy_pack.seg_merge_mcu(mwords, mlens, n_seg, mps)


def _chained(imgs: torch.Tensor, subsampling: str, batch: bool,
             device_stuff: bool, pixel_path: str, fuse_bp: bool) -> bool:
    """Whether a call runs from a plan (``kernels/chain.py``), from its
    route, device, mode and rank alone: the default route (device_stuff,
    "nat", no fuse_bp) in a mode of ``chain.MODES`` on an image of the
    entry point's rank on the card. ``chain.plan`` checks its operands and
    raises what the wrappers raise."""
    return (device_stuff and pixel_path == "nat" and not fuse_bp
            and subsampling in chain.MODES and imgs.dim() == 3 + batch
            and imgs.device.type == _build.DEVICE_TYPE)


def _encode(imgs: torch.Tensor, tables: EncoderTables, subsampling: str,
            restart: int, batch: bool, device_stuff: bool, pixel_path: str,
            fuse_bp: bool) -> Tuple[torch.Tensor, ...]:
    """``device_encode`` (batch: ``device_encode_batch``): a call that
    ``_chained`` admits from its plan, kept in ``tables.plans`` (the
    ``chain.KEPT`` used last) under a key of all that admission and the
    plan read, and built where it is missing or stale; every other call by
    the wrappers one by one (``PLANS.fallbacks``)."""
    key = (batch, imgs.shape, imgs.dtype, imgs.device, subsampling, restart,
           device_stuff, pixel_path, fuse_bp, fused_dctq.PIXEL_DC)
    plan = tables.plans.get(key)
    if plan is not None and plan.current(tables):
        tables.plans.move_to_end(key)
        chain.PLANS.hits += 1
        return plan.encode(imgs)
    # n_seg segments of mps MCUs, spi an image.
    my, mx = ops.mcu_grid(imgs.shape[batch], imgs.shape[batch + 1],
                          subsampling)
    if batch:
        spi = batch_segments(my * mx, restart)
        n_seg, mps = imgs.shape[0] * spi, restart
    else:
        n_seg, mps = geometry(my * mx, restart)
        spi = n_seg
    # The shapes the chain leaves to the wrappers: no pixels, and segments
    # that may reach 2^31 bits (213,723 MCUs at 4:2:0), whose guard in the
    # merge's wrapper needs a device sync that the chain does not make.
    if (_chained(imgs, subsampling, batch, device_stuff, pixel_path, fuse_bp)
            and 0 not in imgs.shape and not entropy_pack.seg_merge_sizes(
                n_seg, mps, entropy_pack.mcu_words(
                    fused_dctq.fused_geometry(subsampling)[3] // 64))[2]):
        plan = tables.plans[key] = chain.plan(imgs, tables, subsampling,
                                              restart, n_seg, mps, spi, batch)
        tables.plans.move_to_end(key)
        if len(tables.plans) > chain.KEPT:
            tables.plans.popitem(last=False)
        chain.PLANS.built += 1
        return plan.encode(imgs)
    chain.PLANS.fallbacks += 1
    seg_words, seg_bits = _segments(imgs if batch else imgs[None], tables,
                                    subsampling, restart, n_seg, mps,
                                    pixel_path, fuse_bp)
    if not device_stuff:
        buf, nbytes = compact.compact_segments(seg_words, seg_bits)
        return buf, (nbytes.reshape(-1, spi) if batch else nbytes)
    if compact.stuff_launcher(n_seg, batch) is compact.STUFF_CHUNKS:
        return compact.compact_segments_stuffed(seg_words, seg_bits, restart)
    out = compact.compact_segments_stuffed_grouped(seg_words, seg_bits,
                                                   restart, spi)
    return out if batch else out[:2]


def device_encode(img: torch.Tensor, tables: EncoderTables, subsampling: str,
                  restart: int, device_stuff: bool = True,
                  pixel_path: str = "nat", fuse_bp: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u8 [H, W, 3] (gray [H, W]) on the tables' device -> the device
    program's output: with device_stuff, (u8 scan buffer, total bytes
    scalar); without, (u8 compacted stream, nbytes [n_seg] int64), which
    the host stuffs (``native.stuff_assemble_contig``). pixel_path and
    fuse_bp choose the kernels (``_segments``), never the bytes; on the
    default route one native call runs them from a cached plan
    (``_encode``), else each wrapper runs in turn."""
    return _encode(img, tables, subsampling, restart, False, device_stuff,
                   pixel_path, fuse_bp)


def device_encode_batch(imgs: torch.Tensor, tables: EncoderTables,
                        subsampling: str, restart: int,
                        device_stuff: bool = True, pixel_path: str = "nat",
                        fuse_bp: bool = False) -> Tuple[torch.Tensor, ...]:
    """u8 [n, H, W, 3] (gray [n, H, W]) on the tables' device -> one device
    program for the batch (jpegtpu's ``_device_encode_pallas_batch``,
    ``encoder.py:298-395``). The batch is flattened into the MCU
    dimension; with restart segments that divide each image's MCU count
    (else ``BatchGeometryError``), image boundaries are segment starts, so
    the DC resets and the merge need no per-image case, and each kernel
    launches once (with fuse_bp the fused kernel once). With device_stuff,
    (u8 scan buffer, total bytes scalar, each image's first byte [n]
    int64): the images' scans back to back, RST markers numbered from 0 in
    each; without, (u8 compacted stream, nbytes [n, segments per image]
    int64). The default route runs from a cached plan, as
    ``device_encode``'s."""
    return _encode(imgs, tables, subsampling, restart, True, device_stuff,
                   pixel_path, fuse_bp)


def _pixels(img: np.ndarray, subsampling: str, lead: int = 0) -> np.ndarray:
    """Check an image (lead = 0) or a batch of them (lead = 1): uint8
    [..., H, W, 3] RGB, or for gray [..., H, W] or [..., H, W, 1], given
    back as [..., H, W]."""
    img = np.asarray(img)
    if subsampling == "gray":
        if img.ndim == lead + 3 and img.shape[-1] == 1:
            img = img[..., 0]
        if img.ndim != lead + 2:
            raise ValueError(
                f"gray mode expects [H, W] input, got {img.shape}")
    elif img.ndim != lead + 3 or img.shape[-1] != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got {img.shape}")
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8 pixels, got {img.dtype}")
    return np.ascontiguousarray(img)


class Encoder:
    """Reusable encoder for one configuration on one device."""

    def __init__(self, config: EncoderConfig | None = None,
                 device: torch.device | str | None = None):
        self.config = config or EncoderConfig()
        self.device = resolve_device(device)
        self.tables = EncoderTables.for_quality(
            self.config.quality, self.config.subsampling, self.device)

    def restart_for(self, h: int, w: int) -> int:
        """The concrete restart interval of an h x w image."""
        _, mx = ops.mcu_grid(h, w, self.config.subsampling)
        return self.config.resolve_restart(mx)

    def encode_to_scan(self, img: np.ndarray) -> Tuple[bytes, int]:
        """Device pipeline + exact-size fetch (+ host stuffing without
        device_stuff) -> (entropy scan bytes, restart interval)."""
        img = _pixels(img, self.config.subsampling)
        restart = self.restart_for(*img.shape[:2])
        x = torch.from_numpy(img).to(self.device)
        cfg = self.config
        buf, meta = device_encode(x, self.tables, cfg.subsampling, restart,
                                  cfg.device_stuff, cfg.pixel_path,
                                  cfg.fuse_bp)
        if self.config.device_stuff:
            return buf[:int(meta)].cpu().numpy().tobytes(), restart
        # The byte counts first (a tiny fetch, and the sync), then exactly
        # the compacted bytes (jpegtpu's "stream" branch, encoder.py:585-595).
        nbytes = meta.cpu().numpy()
        stream = buf[:int(nbytes.sum())].cpu().numpy()
        return native.stuff_assemble_contig(stream, nbytes, restart), restart

    def encode(self, img: np.ndarray) -> bytes:
        """uint8 RGB [H, W, 3] (gray: [H, W] or [H, W, 1]) -> complete
        JFIF/JPEG bytes."""
        h, w = np.shape(img)[:2]
        scan_bytes, restart = self.encode_to_scan(img)
        return self.wrap(h, w, restart, scan_bytes)

    def wrap(self, h: int, w: int, restart: int, scan_bytes: bytes) -> bytes:
        return jfif.wrap_jpeg(h, w, self.config.quality,
                              self.config.subsampling, restart, scan_bytes)

    def encode_batch_fused(self, imgs: np.ndarray) -> List[bytes]:
        """Same-shaped images [n, H, W, 3] (gray [n, H, W] or [n, H, W, 1])
        -> n files from one device program (jpegtpu's
        ``_encode_batch_fused``, ``encoder.py:664-741``). Raises
        ``BatchGeometryError`` before any device work when the restart
        segments do not divide each image's MCU count."""
        imgs = _pixels(imgs, self.config.subsampling, lead=1)
        n, h, w = imgs.shape[:3]
        restart = self.restart_for(h, w)
        my, mx = ops.mcu_grid(h, w, self.config.subsampling)
        batch_segments(my * mx, restart)
        x = torch.from_numpy(imgs).to(self.device)
        cfg = self.config
        out = device_encode_batch(x, self.tables, cfg.subsampling, restart,
                                  cfg.device_stuff, cfg.pixel_path,
                                  cfg.fuse_bp)
        if self.config.device_stuff:
            buf, total, img_off = out
            # One fetch of the offsets and the total, one of the scan.
            bounds = torch.cat([img_off, total.reshape(1)]).cpu().numpy()
            raw = buf[:int(bounds[-1])].cpu().numpy()
            return [self.wrap(h, w, restart,
                              raw[bounds[i]:bounds[i + 1]].tobytes())
                    for i in range(n)]
        buf, nbytes = out
        nbytes = nbytes.cpu().numpy()                   # [n, spi]
        ends = np.cumsum(nbytes.sum(axis=1))
        raw = buf[:int(ends[-1])].cpu().numpy()
        return [self.wrap(h, w, restart, native.stuff_assemble_contig(
                    raw[e - nb.sum():e], nb, restart))
                for nb, e in zip(nbytes, ends)]


def encode(img: np.ndarray, quality: int = 50, subsampling: str = "420",
           restart_interval: int | str = "rows",
           device: torch.device | str | None = None, **kw) -> bytes:
    """One-shot convenience wrapper; device None means "cuda"; other
    ``EncoderConfig`` fields (``device_stuff``, ``pixel_path``,
    ``fuse_bp``) as keywords."""
    cfg = EncoderConfig(quality=quality, subsampling=subsampling,
                        restart_interval=restart_interval, **kw)
    return Encoder(cfg, device=device).encode(img)


def encode_batch(imgs: Sequence[np.ndarray],
                 config: EncoderConfig | None = None,
                 device: torch.device | str | None = None,
                 **kw) -> List[bytes]:
    """Encode a batch of images (jpegtpu's ``encode_batch``,
    ``encoder.py:635-661``). More than one image, all of one shape, run as
    one device program over [n, H, W, 3]; a batch whose restart segments
    do not divide each image's MCU count (restart 0, or such an interval)
    warns and is encoded image by image, as are mixed shapes. Pass an
    ``EncoderConfig`` as `config`, or its fields as keywords; device None
    means "cuda"."""
    if config is not None and kw:
        raise TypeError("pass either config= or EncoderConfig keywords")
    enc = Encoder(config or EncoderConfig(**kw), device=device)
    imgs = list(imgs)
    if len(imgs) > 1 and len({np.shape(im) for im in imgs}) == 1:
        try:
            return enc.encode_batch_fused(np.stack(imgs))
        except BatchGeometryError as e:
            # A throughput caller should know it pays n programs, not one.
            warnings.warn(f"encode_batch: fused batch path unavailable "
                          f"({e}); falling back to per-image encodes",
                          RuntimeWarning, stacklevel=2)
    return [enc.encode(im) for im in imgs]
