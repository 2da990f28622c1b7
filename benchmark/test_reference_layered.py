"""CPU tests of the layered reference (``ldpcbench/reference_layered.py``):
bit for bit with the program's plain layered decoder on seeded LLRs, at
the judged code and at a BG2-like code (rate 1/5, Z = 16, the
configuration's structure at a small lifting), min-sum and
sumproduct-fast, early termination on and off, with and without bf16
message storage; the bf16 control differs from the float32 reference
there.

    python -m pytest benchmark/test_reference_layered.py -q
"""

import pytest
import torch

import conftest  # noqa: F401  (the benchmark's import paths)
from ldpcbench import reference
from ldpcbench.reference_layered import LayeredDecoder

CODES = ("judged", "nr2-r15-z16")


def program_code(key):
    from tpu_ldpc_torch.codes.code import LdpcCode
    from tpu_ldpc_torch.codes.nrlike import nrlike_code

    return (LdpcCode.judged() if key == "judged"
            else nrlike_code("1/5", 16, 11, 2))


def seeded_llrs(code, punct):
    """12 frames: noisy all-zero codewords, the mean LLR rising from 1 to
    3 over the frames (the first fail, the last converge), the punctured
    block-columns erased, a frame that is a codeword at once and a row of
    -0.0."""
    gen = torch.Generator().manual_seed(7)
    llr = (2.0 * torch.randn((12, code.n), generator=gen)
           + torch.linspace(1.0, 3.0, 12)[:, None])
    llr[:, :punct * code.Z] = 0.0
    llr[0] = torch.abs(llr[0]) + 0.5
    llr[1, ::3] = -0.0
    return llr


@pytest.mark.parametrize("key", CODES)
@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_layered_reference_matches_the_programs_plain_decoder(
        key, algo, early_stop, bf16):
    from tpu_ldpc_torch.decode.reference import build_decoder

    prog = program_code(key)
    code = reference.Code(prog.B, prog.Z)
    llr = seeded_llrs(code, 2 if key.startswith("nr") else 0)
    want = build_decoder(prog, algo, 12, 0.75, 0.0, "layered", early_stop,
                         msg_dtype=torch.bfloat16 if bf16 else None)(llr)
    got = LayeredDecoder(code, algo, 12, 0.75, early_stop,
                         msg_bf16=bf16)(llr)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))
    ok = got[1]
    assert bool(ok[0]) and not bool(ok.all())  # some converge, some not
    if early_stop:
        assert int(got[2][0]) == 0 and int(got[2].max()) > 0


@pytest.mark.parametrize("key", CODES)
def test_bf16_control_differs(key):
    prog = program_code(key)
    code = reference.Code(prog.B, prog.Z)
    llr = seeded_llrs(code, 2 if key.startswith("nr") else 0)
    outs = [LayeredDecoder(code, "minsum", 12, 0.75, True,
                           msg_bf16=bf16)(llr) for bf16 in (False, True)]
    assert not all(torch.equal(a, b) for a, b in zip(*outs))


def test_layered_differs_from_flooding():
    """The layered reference is not the flooding one under another name:
    the same LLRs take fewer layered iterations to converge."""
    prog = program_code("nr2-r15-z16")
    code = reference.Code(prog.B, prog.Z)
    llr = seeded_llrs(code, 2)
    lay = LayeredDecoder(code, "minsum", 12, 0.75, True)(llr)
    flood = reference.Decoder(code, "minsum", 12, 0.75, True)(llr)
    assert int(lay[2].sum()) < int(flood[2].sum())
