"""The C interface of the port's kernel library, read from the sources on
the CPU: every ``_build.Kernel`` that the port declares names an ``extern
"C"`` launcher of a source in ``_build.SOURCES``, with the same number of
arguments and the same kind of each (pointer, 64-bit or 32-bit integer),
the CUDA stream last. ctypes passes what a declaration says, so a
declaration that drifts from its launcher would show only on the card,
as undefined behaviour. Imports no JAX."""

import re

import pytest

from jpegtpu_torch.kernels import (_build, compact, entropy_oracles,
                                   entropy_pack, fused_dctq, fused_pipeline)

# Every Kernel the port declares, by launcher symbol.
KERNELS = {k.symbol: k for mod in (fused_dctq, entropy_pack,
                                   entropy_oracles, compact, fused_pipeline)
           for k in vars(mod).values() if isinstance(k, _build.Kernel)}
# C parameter types -> the ctypes type a declaration must give them.
SCALARS = {"long long": _build.I64, "int64_t": _build.I64,
           "int": _build.I32, "int32_t": _build.I32, "unsigned": _build.I32,
           "uint32_t": _build.I32}


def _launchers():
    """symbol -> (source, [parameter declarations]) of every extern "C"
    function of the library's sources."""
    out = {}
    for name in _build.SOURCES:
        text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                             text):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            out[m.group(1)] = (name, [p for p in params if p])
    return out


def _ctype(decl: str):
    """The ctypes type of one C parameter declaration ("const float* lum",
    "long long n_mcu", "cudaStream_t stream")."""
    if "*" in decl or decl.split()[0] == "cudaStream_t":
        return _build.PTR
    ctype = " ".join(w for w in decl.split()[:-1] if w != "const")
    if ctype not in SCALARS:
        raise AssertionError(f"unknown C parameter type in {decl!r}")
    return SCALARS[ctype]


def test_the_port_declares_all_fourteen_kernels():
    """Fourteen kernels, fifteen launchers: K2's one kernel body has two
    (jpegtpu's signature, and the encoder's, which derives the class and
    the DC differences)."""
    assert len(KERNELS) == 15
    assert {entropy_pack.BLOCK_PACK.symbol,
            entropy_pack.BLOCK_PACK_SEGMENTS.symbol} <= set(KERNELS)


def test_sources_are_the_csrc_files():
    """The library is built from every .cu in csrc/ and hashed with every
    .cuh: no source is left out of the build, none is listed that is
    gone."""
    assert sorted(_build.SOURCES) == sorted(
        p.name for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.HEADERS) == sorted(
        p.name for p in _build.CSRC.glob("*.cuh"))


@pytest.mark.parametrize("symbol", sorted(KERNELS))
def test_launcher_abi_matches_its_declaration(symbol):
    launchers = _launchers()
    assert symbol in launchers, f"no extern \"C\" {symbol} in the sources"
    source, params = launchers[symbol]
    assert params[-1].split()[0] == "cudaStream_t", (source, params[-1])
    got = [_ctype(p) for p in params]
    want = KERNELS[symbol].argtypes
    assert len(got) == len(want), (source, params)
    for i, (g, w, p) in enumerate(zip(got, want, params)):
        assert g is w, f"{symbol} argument {i} ({p}): C {g}, declared {w}"


def test_every_launcher_is_declared():
    """Every extern "C" function that takes a stream is a Kernel of the
    port (the others report sizes)."""
    launchers = {s for s, (_, params) in _launchers().items()
                 if params and params[-1].split()[0] == "cudaStream_t"}
    assert launchers == set(KERNELS)


def test_fused_launcher_takes_the_factors():
    """K11's launcher takes the image, the operator's two factors and the
    bias, then the LUTs and the outputs, not the dense operator."""
    source, params = _launchers()[fused_pipeline.FUSED_PX_BP.symbol]
    assert source == "fused_px_bp.cu"
    assert [p.split()[-1].lstrip("*") for p in params[:4]] == [
        "img", "lum", "chroma", "bias"]
    assert not any(p.split()[-1].lstrip("*") == "m" for p in params)


# Each kernel's launcher and the source that builds it: K3, K8, K9 and K10
# are instances of one body in seg_merge.cu, K2 and K7 share block_pack.cu.
LAUNCHER_SOURCES = {
    "jt_seg_merge_mcu": "seg_merge.cu", "jt_mcu_merge": "seg_merge.cu",
    "jt_seg_merge_window": "seg_merge.cu", "jt_seg_merge_v1": "seg_merge.cu",
    "jt_block_pack": "block_pack.cu", "jt_block_pack_mcu": "block_pack.cu",
    "jt_block_pack_mcu_segments": "block_pack.cu"}


@pytest.mark.parametrize("symbol", sorted(LAUNCHER_SOURCES))
def test_launcher_lives_in_its_source(symbol):
    assert _launchers()[symbol][0] == LAUNCHER_SOURCES[symbol]


def test_merge_instances_are_symbols_of_their_own():
    """The four launchers of seg_merge.cu launch four distinct instances
    of its body, so the profiler and ptxas name each kernel apart."""
    text = (_build.CSRC / "seg_merge.cu").read_text()
    args = re.findall(r"return launch<([^>]*)>", text)
    assert len(args) == 4 and len(set(args)) == 4, args
