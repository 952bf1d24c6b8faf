"""Port parity for the Meteor LRPT decode path as a whole: the soft-bit
mapping, ``encode_cadus``, ``MeteorLRPTDecoder.finalize``, ``MeteorChannel``
and ``decode meteor`` on the committed golden capture.

Tolerances: the host mapping, the framing and the tail are bit-exact (the
same numpy code, and the Viterbi/RS tail is bit-exact, see
test_torch_fec.py). The golden capture is held end to end: its three
892-byte payloads must come back exactly. On it the port runs the chunked
FastAGC and Costas (K = 64 lanes at the 65,536-sample block, decided by
``_chunk_lanes_for`` on every device), where the JAX package on the CPU
runs them exact; both recover the payloads.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from sdrpp_tpu.decoders import meteor_lrpt as jmeteor
from sdrpp_tpu.decoders.falcon9 import _ccsds_randomizer
from sdrpp_tpu.models import lrpt as jlrpt
from sdrpp_tpu_torch.decoders import meteor_lrpt as tmeteor
from sdrpp_tpu_torch.models import lrpt as tlrpt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN_WAV = REPO / "tests" / "data" / "meteor_lrpt_150000Hz.wav"
GOLDEN_PAYLOAD = REPO / "tests" / "data" / "meteor_lrpt_payload.bin"


def _payloads(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 892),
                                                dtype=np.uint8)


def test_soft_bit_mapping_matches_jax():
    rng = np.random.default_rng(0)
    syms = ((rng.normal(size=500) + 1j * rng.normal(size=500)) * 1.2
            ).astype(np.complex64)
    s8 = tlrpt.symbols_to_soft_bits(syms)
    np.testing.assert_array_equal(s8, jlrpt.symbols_to_soft_bits(syms))
    np.testing.assert_array_equal(tlrpt.soft_s8_to_u8(s8),
                                  jlrpt.soft_s8_to_u8(s8))
    assert tlrpt.CCSDS_CONV_POLYS == jlrpt.CCSDS_CONV_POLYS


def test_randomizer_and_encode_cadus_match_jax():
    np.testing.assert_array_equal(tmeteor._ccsds_randomizer(300),
                                  _ccsds_randomizer(300))
    p = _payloads(2, 1)
    np.testing.assert_array_equal(tmeteor.encode_cadus(p),
                                  jmeteor.encode_cadus(p))


def test_finalize_matches_jax_on_the_same_symbols():
    """Both decoders' tails (rotation search, stream Viterbi, CADU sync,
    derandomising, RS) on the same noisy, rotated symbol stream."""
    rng = np.random.default_rng(2)
    p = _payloads(3, 2)
    syms = tmeteor.encode_cadus(p) * np.exp(1j * np.pi / 2)  # rotation 1
    syms = (syms + 0.25 * (rng.normal(size=len(syms))
                           + 1j * rng.normal(size=len(syms)))
            ).astype(np.complex64)
    j = jmeteor.MeteorLRPTDecoder()
    t = tmeteor.MeteorLRPTDecoder(device="cpu")
    j._chunks = [syms]
    t._chunks = [torch.from_numpy(syms)]
    js, jv, jinfo = j.finalize()
    ts, tv, tinfo = t.finalize()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tv, jv)
    assert tinfo == jinfo
    assert tinfo["rotation"] == 1 and tinfo["vcdus_ok"] == 3
    np.testing.assert_array_equal(tv, p)
    assert set(t.timings) == {"viterbi_s", "sync_s", "rs_s"}


def test_decode_meteor_golden_on_cpu(tmp_path):
    """tests/test_cli_decode.py's golden through the port's entry point."""
    from sdrpp_tpu_torch.cli import main

    golden = np.fromfile(GOLDEN_PAYLOAD, np.uint8).reshape(3, 892)
    out = tmp_path / "meteor.s"
    rc = main(["decode", "meteor", "--source", str(GOLDEN_WAV),
               "--device", "cpu", "--out", str(out)])
    assert rc == 0
    soft = np.fromfile(out, np.int8)
    assert len(soft) > 55000
    vcdus = np.fromfile(tmp_path / "meteor_vcdu.bin", np.uint8)
    assert len(vcdus) == 3 * 892
    for p in golden:
        assert any(np.array_equal(v, p) for v in vcdus.reshape(3, 892))


def test_decode_meteor_with_vfo_imports_no_jax(tmp_path):
    """Source rate != 150 kHz inserts the port's RxVFO; the decode path
    leaves jax out of sys.modules."""
    out = tmp_path / "m.s"
    code = (
        "import sys\n"
        "from sdrpp_tpu_torch.cli import main\n"
        f"rc = main(['decode', 'meteor', '--source', 'test:300000',"
        f" '--blocks', '1', '--block-size', '32768', '--device', 'cpu',"
        f" '--out', {str(out)!r}])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'sdrpp_tpu' not in sys.modules, 'sdrpp_tpu was imported'\n"
        "print('JAX-FREE')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX-FREE" in proc.stdout
    assert out.exists() and out.stat().st_size > 0
    assert (tmp_path / "m_vcdu.bin").stat().st_size == 0


def test_meteor_channel():
    ch = tlrpt.MeteorChannel(300000.0, offset=20000.0, device="cpu")
    n = ch.block_multiple * (8192 // ch.block_multiple)
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=n) + 1j * rng.normal(size=n))
                         .astype(np.complex64))
    st, (syms, valid) = ch(ch.init_state(), x)
    assert syms.shape == valid.shape == (ch.max_symbols(n),)
    assert 0 < int(valid.sum()) <= len(valid)
    # the block chunks its M&M: valid is a mask over the K lanes' slots,
    # not a prefix
    assert ch.demod.recov._lanes_for(ch.vfo.out_count(n)) >= 1
    assert set(st) == {"vfo", "demod"}
    # a dynamic channel retuned to the same offset gives the same symbols
    dyn = tlrpt.MeteorChannel(300000.0, dynamic_offset=True, device="cpu")
    dst = dyn.retune_state(dyn.init_state(), 20000.0)
    _, (dsyms, dvalid) = dyn(dst, x)
    assert torch.equal(dvalid, valid)
    np.testing.assert_allclose(dsyms.numpy(), syms.numpy(), rtol=0,
                               atol=1e-5)


def test_decode_meteor_on_cuda_without_a_card_raises(tmp_path):
    """No fallback hides the device: asking for CUDA where torch has none
    raises instead of decoding on the CPU."""
    from sdrpp_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["decode", "meteor", "--source", "test:150000", "--blocks", "1",
              "--block-size", "4096", "--device", "cuda",
              "--out", str(tmp_path / "m.s")])
