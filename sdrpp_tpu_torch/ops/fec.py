"""Forward error correction: convolutional (Viterbi) + Reed-Solomon GF(256).

The counterpart of ``sdrpp_tpu.ops.fec`` (libcorrect conventions:
core/libcorrect/src/convolutional/*.c, reed-solomon/*.c):

- ``ConvCode``: rate 1/R, order K codes, every order 2 to 15 (S = 2 ...
  16384 states) and rate 2 to 32. ``encode`` runs on the host (numpy,
  bit-exact against libcorrect). ``decode_soft`` is the exact
  full-trellis decode: the batched ACS and traceback kernels of
  ``fec_kernels`` with one window (B5 and B7 of the JAX package), and
  ``decode_soft_np`` the same with host arrays in and out (the JAX
  package's host-facing decode), which ``decode_soft_bytes`` and
  ``decode_hard`` pack into bytes. ``acs_decisions`` is the ACS alone,
  its decisions unpacked to [T, S] on the device. ``decode_soft_stream`` is the
  chunk-parallel truncated decode of long streams (L-step windows with W
  steps of warm-up and warm-down on each side, batched through the same
  kernels); it stays on the device and only packed bytes come back. It
  takes the windows where the JAX package's windowed kernel does (S <=
  64, fec_pallas.py:72) and the exact decode above, as the JAX package
  does on a TPU (sdrpp_tpu/ops/fec.py:298-303). Soft-decision
  convention: 0 = strong 0, 255 = strong 1.
- ``ReedSolomon``: RS(255, 255 - nroots) with libcorrect's
  parameterization. ``encode`` on the host; ``decode`` and
  ``decode_with_erasures`` (f known erasures plus e errors while 2e + f
  <= nroots) in plain torch integer ops over a batch axis (syndromes, the
  erasure locator, Berlekamp-Massey, Chien search, Forney), bit-exact
  against the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .fec_kernels import (unpack_decisions, viterbi_acs_batched,
                          viterbi_traceback_batched)

__all__ = ["ConvCode", "ReedSolomon", "RS_CCSDS",
           "CONV_R12_6", "CONV_R12_7", "CONV_R12_8", "CONV_R12_9"]

# Standard polynomial sets (libcorrect correct.h:19-28; octal literals)
CONV_R12_6 = (0o73, 0o61)
CONV_R12_7 = (0o161, 0o127)
CONV_R12_8 = (0o225, 0o373)
CONV_R12_9 = (0o767, 0o545)

RS_CCSDS = 0x187  # x^8+x^7+x^2+x+1


def _bits_from_bytes(data) -> np.ndarray:
    """Bytes -> bits MSB-first (libcorrect bit_reader convention)."""
    return np.unpackbits(np.asarray(data, np.uint8))


def _bytes_from_bits(bits) -> np.ndarray:
    return np.packbits(np.asarray(bits, np.uint8))


def _parity(x: np.ndarray) -> np.ndarray:
    return np.array([bin(int(v)).count("1") & 1 for v in x], np.uint8)


class ConvCode:
    """Convolutional encoder + Viterbi decoder (rate 1/R, order K)."""

    # windows per batched-ACS launch in decode_soft_stream: bounds the
    # decision words (B x (L + 2W) x 8 bytes, 35 MB at the defaults)
    _STREAM_BATCH = 1024

    def __init__(self, rate: int, order: int, polys, *, device):
        if len(polys) != rate or rate < 2 or not 2 <= order <= 15:
            raise ValueError("need rate >= 2 polynomials and 2 <= order <= 15")
        self.rate = int(rate)
        self.order = int(order)
        self.polys = tuple(int(p) for p in polys)
        self.num_states = 1 << (order - 1)
        self.device = torch.device(device)
        # output bit j of shift-register value reg = parity(reg & poly[j])
        # (lookup.c fill_table)
        regs = np.arange(1 << order, dtype=np.int64)
        self.reg_outputs = np.stack([_parity(regs & p) for p in self.polys],
                                    axis=1)  # [2^order, rate]
        self._expected = torch.from_numpy(
            self.reg_outputs.astype(np.float32) * 255.0).to(self.device)

    # ---------- encode (host) ----------

    def encode_len_bits(self, msg_len_bytes: int) -> int:
        return self.rate * (8 * msg_len_bytes + self.order + 1)

    def encode(self, msg) -> np.ndarray:
        """Encode bytes -> encoded bytes (bit-exact vs libcorrect encode.c)."""
        bits = np.concatenate([_bits_from_bytes(msg),
                               np.zeros(self.order + 1, np.uint8)])
        mask = (1 << self.order) - 1
        reg = 0
        out_bits = np.zeros(len(bits) * self.rate, np.uint8)
        for i, b in enumerate(bits):
            reg = ((reg << 1) | int(b)) & mask
            out_bits[i * self.rate:(i + 1) * self.rate] = self.reg_outputs[reg]
        pad = (-len(out_bits)) % 8  # bit_writer_flush_byte zero-fill
        return _bytes_from_bits(np.concatenate([out_bits,
                                                np.zeros(pad, np.uint8)]))

    # ---------- decode (device) ----------

    def _soft_steps(self, soft_bits) -> torch.Tensor:
        """Soft bits (numpy or tensor) -> [T, R] on the device: uint8 where
        they are known to be integers in 0..255 (a uint8 tensor, or a host
        array whose values are, as the JAX package ships them,
        sdrpp_tpu/ops/fec.py:267-276), else float32. uint8 takes the
        tuned kernels' fast form and a 4x smaller upload; both decode
        alike."""
        if isinstance(soft_bits, torch.Tensor):
            soft = soft_bits
        else:
            arr = np.asarray(soft_bits)
            if (arr.dtype != np.uint8 and arr.size
                    and (np.issubdtype(arr.dtype, np.integer)
                         or np.issubdtype(arr.dtype, np.floating))
                    and np.all(arr == np.round(arr))
                    and arr.min() >= 0 and arr.max() <= 255):
                arr = arr.astype(np.uint8)
            soft = torch.from_numpy(np.ascontiguousarray(arr))
        if soft.dtype != torch.uint8:
            soft = soft.float()
        total = soft.shape[0] // self.rate
        return soft[:total * self.rate].to(self.device) \
            .reshape(total, self.rate)

    def acs_decisions(self, soft_bits) -> torch.Tensor:
        """The add-compare-select lattice alone: [T * R] soft bits -> [T, S]
        uint8 decisions on the device, nonzero where state n took
        predecessor (n >> 1) + S / 2 (sdrpp_tpu/ops/fec.py:145). One ACS
        launch (B5); the packed words are unpacked by shifts and ANDs on
        the device."""
        soft = self._soft_steps(soft_bits)
        start = torch.zeros(1, dtype=torch.int32, device=self.device)
        words = viterbi_acs_batched(soft, start, soft.shape[0],
                                    self._expected)[0]
        return unpack_decisions(words, self.num_states).to(torch.uint8)

    def decode_soft(self, soft_bits, flush_bits: int | None = None):
        """Exact Viterbi decode of soft bits (0 = strong 0, 255 = strong 1)
        covering T trellis steps including the flush steps -> uint8 bits
        [T - flush_bits] on the device. ``flush_bits`` defaults to
        order + 1 (this codec's own ``encode``)."""
        if flush_bits is None:
            flush_bits = self.order + 1
        soft = self._soft_steps(soft_bits)
        total = soft.shape[0]
        start = torch.zeros(1, dtype=torch.int32, device=self.device)
        words = viterbi_acs_batched(soft, start, total, self._expected)
        return viterbi_traceback_batched(
            words, num_states=self.num_states)[0, :total - flush_bits]

    def decode_soft_np(self, soft_bits, flush_bits: int | None = None
                       ) -> np.ndarray:
        """``decode_soft`` with the bits back on the host: uint8
        [T - flush_bits] (sdrpp_tpu/ops/fec.py:186)."""
        return self.decode_soft(soft_bits, flush_bits).cpu().numpy()

    def decode_soft_stream(self, soft_bits, chunk_bits: int = 4096,
                           overlap_bits: int = 96) -> np.ndarray:
        """Chunk-parallel truncated Viterbi for long soft-bit streams
        (sdrpp_tpu/ops/fec.py:233): windows of ``chunk_bits`` trellis steps
        extended by ``overlap_bits`` on each side run batched through the
        ACS and traceback kernels, and only each window's interior bits are
        kept. Streams of at most chunk + 2 * overlap steps, and codes of
        more than 64 states (the JAX package's windowed kernel takes S <=
        64, fec_pallas.py:72), take the exact decode. Returns host uint8
        bits [T - (order + 1)]."""
        soft = self._soft_steps(soft_bits)
        total = soft.shape[0]
        L, W = int(chunk_bits), int(overlap_bits)
        t_w = L + 2 * W
        if total <= t_w or self.num_states > 64:
            return self.decode_soft(soft.reshape(-1)).cpu().numpy()
        dev = self.device
        n_chunks = -(-total // L)
        starts = torch.clamp(torch.arange(n_chunks, device=dev) * L - W, 0,
                             total - t_w)
        offs = torch.arange(n_chunks, device=dev) * L - starts
        starts = starts.to(torch.int32)
        steps = torch.arange(L, device=dev)
        interior = []
        for g in range(0, n_chunks, self._STREAM_BATCH):
            # the kernels read each window where it lies in the stream
            words = viterbi_acs_batched(soft, starts[g:g + self._STREAM_BATCH],
                                        t_w, self._expected)
            bits = viterbi_traceback_batched(words,
                                             num_states=self.num_states)
            # interior of chunk c is [offs[c], offs[c] + L) of its window;
            # the last chunk's tail runs past t_w (clamped: those positions
            # lie beyond ``total`` and are dropped)
            gidx = torch.clamp(offs[g:g + self._STREAM_BATCH, None] + steps,
                               max=t_w - 1)
            interior.append(torch.gather(bits, 1, gidx))
        flat = torch.cat(interior).reshape(-1)[:total]
        n_pack = -(-total // 8)
        flat = torch.nn.functional.pad(flat, (0, n_pack * 8 - total))
        weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=dev,
                               dtype=torch.int32)  # MSB first
        packed = (flat.reshape(n_pack, 8).to(torch.int32) * weights).sum(-1)
        bits = np.unpackbits(packed.to(torch.uint8).cpu().numpy())[:total]
        return bits[:total - (self.order + 1)]

    def decode_soft_bytes(self, soft_bits) -> np.ndarray:
        """``decode_soft_np`` packed MSB first into whole bytes (a last
        partial byte dropped; sdrpp_tpu/ops/fec.py:364)."""
        bits = self.decode_soft_np(soft_bits)
        return _bytes_from_bits(bits[:len(bits) // 8 * 8])

    def decode_hard(self, encoded, num_bits: int | None = None) -> np.ndarray:
        """Hard-decision decode of encoded bytes (the first ``num_bits``
        coded bits, cut to whole trellis steps) -> message bytes: each bit
        a soft 0 or 255 (sdrpp_tpu/ops/fec.py:369)."""
        bits = _bits_from_bytes(encoded)
        if num_bits is not None:
            bits = bits[:num_bits]
        bits = bits[:len(bits) // self.rate * self.rate]
        return self.decode_soft_bytes(bits.astype(np.float32) * 255.0)


# ---------------------------------------------------------------------------
# Reed-Solomon over GF(2^8)
# ---------------------------------------------------------------------------


def _gf_tables(prim_poly: int):
    exp = np.zeros(256, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= prim_poly
    return exp, log


def _gf_mul_np(a, b, exp, log):
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    out = exp[(log[a] + log[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis by pairwise folding."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        x = x[..., 0::2] ^ x[..., 1::2]
    return x[..., 0]


class ReedSolomon:
    """RS(255, 255-nroots) matching libcorrect's parameterization."""

    def __init__(self, prim_poly: int = RS_CCSDS,
                 first_consecutive_root: int = 1,
                 generator_root_gap: int = 1, num_roots: int = 32, *,
                 device):
        self.nroots = int(num_roots)
        self.block_len = 255
        self.msg_len = 255 - self.nroots
        self.fcr = int(first_consecutive_root)
        self.gap = int(generator_root_gap)
        self.device = torch.device(device)
        self.exp, self.log = _gf_tables(prim_poly)
        # generator roots alpha^{gap*(fcr+i)} (reed-solomon.c:8-11)
        self.root_pows = (self.gap * (np.arange(self.nroots) + self.fcr)) % 255
        self.roots = self.exp[self.root_pows]
        g = np.zeros(self.nroots + 1, np.int64)  # coefficients low->high
        g[0] = 1
        for deg, r in enumerate(self.roots):
            ng = np.zeros_like(g)
            ng[1:deg + 2] = g[0:deg + 1]          # x * g
            ng[:deg + 1] ^= _gf_mul_np(g[:deg + 1], int(r), self.exp, self.log)
            g = ng
        self.generator = g
        self._exp = torch.from_numpy(self.exp).to(self.device)
        self._log = torch.from_numpy(self.log).to(self.device)

    # ---------- encode (host) ----------

    def encode(self, msg) -> np.ndarray:
        """Systematic encode -> msg || parity (255 bytes), parity emitted
        high-order-first (libcorrect encode.c:29-31)."""
        msg = np.asarray(msg, np.uint8)
        if len(msg) != self.msg_len:
            raise ValueError(f"message must be {self.msg_len} bytes")
        parity = np.zeros(self.nroots, np.int64)  # low->high coefficients
        gtop = self.generator[:-1]
        for byte in msg:
            feedback = int(parity[-1]) ^ int(byte)
            parity[1:] = parity[:-1]
            parity[0] = 0
            if feedback:
                parity ^= _gf_mul_np(gtop, feedback, self.exp, self.log)
        return np.concatenate([msg, parity[::-1].astype(np.uint8)])

    # ---------- decode (device) ----------

    def _mul(self, a, b):
        out = self._exp[(self._log[a] + self._log[b]) % 255]
        return torch.where((a == 0) | (b == 0), 0, out)

    def _inv(self, a):
        return self._exp[(255 - self._log[torch.clamp(a, min=1)]) % 255]

    def _eval_at_pows(self, coeffs, x_pows):
        """Evaluate [B, m] polynomials (coefficients low->high) at
        x = alpha^{x_pows[k]} -> [B, len(x_pows)]."""
        j = torch.arange(coeffs.shape[-1], device=coeffs.device)
        expo = (x_pows[:, None] * j[None, :]) % 255  # [k, m]
        c = coeffs[:, None, :]
        terms = torch.where(
            c == 0, 0,
            self._exp[(self._log[torch.clamp(c, min=1)] + expo) % 255])
        return _xor_reduce(terms)

    def _syndromes(self, r):
        """S_i = r(alpha^{root_pows[i]}), r[:, 0] the highest-order
        coefficient -> [B, nroots]."""
        dev = r.device
        pows = torch.from_numpy(self.root_pows).to(dev)
        return self._eval_at_pows(torch.flip(r, [-1]), pows)

    def _check_blocks(self, blocks):
        if blocks.ndim != 2 or blocks.shape[1] != self.block_len:
            raise ValueError(f"blocks must be [B, {self.block_len}]")
        return blocks.to(self.device).long()

    def _correct(self, r, gamma=None, f=None):
        """The decode from the erasure locator ``gamma`` [B, nroots + 1]
        and the erasure counts ``f`` [B] (both None without erasures):
        syndromes, Berlekamp-Massey seeded with gamma, whose steps start at
        i = f with the growth test 2 (L - f) <= i - f, Chien search and
        Forney -> (corrected [B, 255], no_errors, is_err [B, 255], the
        locator's length [B], the corrected block's syndromes)."""
        Bn, N, nroots = r.shape[0], self.block_len, self.nroots
        L = nroots + 1
        dev = r.device
        synd = self._syndromes(r)
        no_errors = torch.all(synd == 0, dim=1)

        # Berlekamp-Massey -> error locator Lambda (low->high, length L);
        # Bs = x^m * B carried pre-shifted, so each step shifts by one x
        ar = torch.arange(L, device=dev)
        zero_col = torch.zeros((Bn, 1), dtype=torch.int64, device=dev)
        if gamma is None:
            Lam = torch.zeros((Bn, L), dtype=torch.int64, device=dev)
            Lam[:, 0] = 1
            Llen = torch.zeros(Bn, dtype=torch.int64, device=dev)
        else:
            Lam, Llen = gamma, f.clone()
        Bs = torch.cat([zero_col, Lam[:, :-1]], dim=1)
        b = torch.ones(Bn, dtype=torch.int64, device=dev)
        for i in range(nroots):
            idx = i - ar
            ok_idx = (idx >= 0) & (idx < nroots)
            s_at = torch.where(ok_idx, synd[:, torch.clamp(idx, 0, nroots - 1)],
                               0)
            d = _xor_reduce(self._mul(Lam, s_at))
            db = self._mul(d, self._inv(b))
            d_nz = d != 0
            if f is None:
                grow = d_nz & (2 * Llen <= i)
                lnew = i + 1 - Llen
            else:  # the steps before i = f leave every carry as it is
                active = i >= f
                d_nz = d_nz & active
                grow = d_nz & (2 * (Llen - f) <= i - f)
                lnew = i + 1 - (Llen - f)
            new_lam = torch.where(d_nz[:, None],
                                  Lam ^ self._mul(Bs, db[:, None]), Lam)
            base = torch.where(grow[:, None], Lam, Bs)
            shifted = torch.cat([zero_col, base[:, :-1]], dim=1)
            Bs = shifted if f is None else torch.where(active[:, None],
                                                       shifted, Bs)
            Llen = torch.where(grow, lnew, Llen)
            b = torch.where(grow, d, b)
            Lam = new_lam

        # Chien search: coefficient power j (byte r[N-1-j]) is in error iff
        # Lambda(X_j^-1) == 0, X_j = alpha^{gap*j}
        jpos = torch.arange(N, device=dev)
        xj_pow = (self.gap * jpos) % 255
        xinv_pow = (255 - xj_pow) % 255
        is_err = self._eval_at_pows(Lam, xinv_pow) == 0

        # Omega(x) = S(x) Lambda(x) mod x^nroots
        k = torch.arange(nroots, device=dev)
        b_idx = k[:, None] - ar[None, :]  # [nroots, L]
        ok_b = (b_idx >= 0) & (b_idx < nroots)
        s_b = synd[:, torch.clamp(b_idx, 0, nroots - 1)]  # [B, nroots, L]
        omega = _xor_reduce(torch.where(ok_b, self._mul(Lam[:, None, :], s_b),
                                        0))
        # Lambda'(x): odd-power coefficients shifted down one
        d_lam = torch.where(ar % 2 == 1, Lam, 0)
        d_lam = torch.cat([d_lam[:, 1:], zero_col], dim=1)
        om_at = self._eval_at_pows(omega, xinv_pow)
        dl_at = self._eval_at_pows(d_lam, xinv_pow)

        # Forney: e_j = X_j^{1-fcr} Omega(X_j^-1) / Lambda'(X_j^-1)
        corr_pow = (((1 - self.fcr) % 255) * xj_pow) % 255
        num = self._mul(om_at, self._exp[corr_pow][None, :])
        ej = torch.where(is_err & (dl_at != 0),
                         self._mul(num, self._inv(dl_at)), 0)
        corrections = torch.flip(ej, [-1])  # power j -> byte N-1-j
        corrected = torch.where(no_errors[:, None], r, r ^ corrections)
        return (corrected, no_errors, is_err, Llen,
                self._syndromes(corrected))

    def decode(self, blocks: torch.Tensor):
        """Decode [B, 255] uint8 codewords -> (corrected [B, 223] uint8, ok
        [B] bool). ``blocks[:, 0]`` is the highest-order coefficient (the
        first transmitted byte)."""
        r = self._check_blocks(blocks)
        corrected, no_errors, is_err, Llen, synd2 = self._correct(r)
        # verify: the corrected block's syndromes vanish and the number of
        # roots found matches the locator degree
        nerr = is_err.long().sum(dim=1)
        ok = torch.all(synd2 == 0, dim=1) & (no_errors | (nerr == Llen))
        return corrected[:, :self.msg_len].to(torch.uint8), ok

    def decode_with_erasures(self, blocks: torch.Tensor,
                             erasure_pos: torch.Tensor,
                             num_erasures: torch.Tensor):
        """Decode with known erasure positions (libcorrect
        correct_reed_solomon_decode_with_erasures; the JAX package's
        ``decode_with_erasures``, sdrpp_tpu/ops/fec.py:563): corrects f
        erasures plus e errors while 2e + f <= nroots. ``blocks`` [B, 255]
        uint8, ``erasure_pos`` [B, max_e] integer byte indices into each
        block of which the first ``num_erasures[b]`` ([B]) are valid ->
        (corrected [B, msg_len] uint8, ok [B] bool: the corrected block's
        syndromes vanish)."""
        r = self._check_blocks(blocks)
        Bn, N = r.shape[0], self.block_len
        pos = erasure_pos.to(self.device).long()
        f = num_erasures.to(self.device).long().reshape(-1)
        if pos.ndim != 2 or pos.shape[0] != Bn or f.shape[0] != Bn:
            raise ValueError(f"erasure_pos must be [{Bn}, max_e] and "
                             f"num_erasures [{Bn}]")
        # erasure locator Gamma(x) = prod_j (1 + X_j x), X_j = alpha^{gap *
        # (N - 1 - position)} (the coefficient power of the byte)
        xj = self._exp[(self.gap * ((N - 1 - pos) % N)) % 255]  # [B, max_e]
        gamma = torch.zeros((Bn, self.nroots + 1), dtype=torch.int64,
                            device=r.device)
        gamma[:, 0] = 1
        zero_col = torch.zeros((Bn, 1), dtype=torch.int64, device=r.device)
        for k in range(pos.shape[1]):
            shifted = torch.cat([zero_col, gamma[:, :-1]], dim=1)
            cand = gamma ^ self._mul(shifted, xj[:, k:k + 1])
            gamma = torch.where((k < f)[:, None], cand, gamma)
        corrected, _, _, _, synd2 = self._correct(r, gamma, f)
        ok = torch.all(synd2 == 0, dim=1)
        return corrected[:, :self.msg_len].to(torch.uint8), ok
