"""The port's copied tables (jpegtpu_torch cannot import jpegtpu, whose
package __init__ imports JAX) are pinned equal to jpegtpu's own."""

import numpy as np
import pytest
import torch

from jpegtpu.container import jfif
from jpegtpu.core import tables
from jpegtpu.entropy import huffman_tables as ht
from jpegtpu.kernels import fused_dctq
from jpegtpu_torch import EncoderTables
from jpegtpu_torch.container import jfif as t_jfif
from jpegtpu_torch.core import tables as t_tables
from jpegtpu_torch.entropy import huffman_tables as t_ht
from jpegtpu_torch.kernels import fused_dctq as t_fused_dctq

QUALITIES = [1, 50, 90, 100]


@pytest.mark.parametrize("q", QUALITIES)
def test_quant_and_operators_match(q):
    for base, t_base in ((tables.QUANT_LUMA, t_tables.QUANT_LUMA),
                         (tables.QUANT_CHROMA, t_tables.QUANT_CHROMA)):
        np.testing.assert_array_equal(t_tables.scale_quant_table(t_base, q),
                                      tables.scale_quant_table(base, q))
    for chroma in (False, True):
        np.testing.assert_array_equal(
            t_tables.quant_table_zigzag(q, chroma),
            tables.quant_table_zigzag(q, chroma))
        for got, want in zip(t_tables.fused_block_operator(q, chroma),
                             tables.fused_block_operator(q, chroma)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    # 420 is the slice's; the other geometries wait for their slices.
    for sub in ("420", "422", "444", "444s"):
        for got, want in zip(t_fused_dctq.mcu_operator(q, sub),
                             fused_dctq.mcu_operator(q, sub)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", QUALITIES)
def test_jfif_headers_match(q):
    for h, w, restart in ((1080, 1920, 120), (37, 53, 4), (16, 16, 0)):
        assert (t_jfif.wrap_jpeg(h, w, q, "420", restart, b"\x12\x34") ==
                jfif.wrap_jpeg(h, w, q, "420", restart, b"\x12\x34"))


def test_zigzag_dct_csc_match():
    np.testing.assert_array_equal(t_tables.ZIGZAG_ORDER, tables.ZIGZAG_ORDER)
    np.testing.assert_array_equal(t_tables.dct_matrix_8x8(),
                                  tables.dct_matrix_8x8())
    np.testing.assert_array_equal(t_tables.CSC_MATRIX, tables.CSC_MATRIX)


def test_huffman_tables_match():
    for got, want in zip(t_ht.packed_luts(), ht.packed_luts()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (t_ht.ZRL, t_ht.EOB) == (ht.ZRL, ht.EOB)
    for name in ("DC_LUMA", "DC_CHROMA", "AC_LUMA", "AC_CHROMA"):
        bits, vals = (getattr(ht, f"{name}_BITS"), getattr(ht, f"{name}_VALS"))
        assert getattr(t_ht, f"{name}_BITS") == bits
        assert getattr(t_ht, f"{name}_VALS") == vals
        assert t_ht.canonical_codes(bits, vals) == ht.canonical_codes(bits,
                                                                      vals)


def test_encoder_tables_from_jpegtpu_arrays():
    """EncoderTables built from jpegtpu's arrays holds the same tensors as
    the one the port builds from its copies."""
    ref = EncoderTables.from_numpy(*fused_dctq.mcu_operator(90, "420"),
                                   *ht.packed_luts())
    own = EncoderTables.for_quality(90)
    for name, buf in ref.named_buffers():
        got = dict(own.named_buffers())[name]
        assert got.dtype == buf.dtype and got.device.type == "cpu"
        assert torch.equal(got, buf), name
    assert ref.m.shape == (768, 384) and ref.ac_codes.shape == (2, 256)
