"""RDS (Radio Data System) bitstream decoder.

A copy of ``sdrpp_tpu.decoders.rds`` (pure Python, held bit-exact to it by
tests/test_torch_rds.py), so the port decodes RDS without importing that
package.

Reference: decoder_modules/radio/src/rds.{h,cpp} — 26-bit block sync via
the RDS shortened cyclic code's syndrome LFSR, offset-word block typing,
meander (burst-error) correction, group assembly, and field decode
(PI / PS name / RadioText / PTY / callsign). This is the host-side tail of
the WFM chain (SURVEY §3.5): the DSP chain recovers a 1187.5 baud
differential bitstream; this class consumes its bits.

Constants and bit layouts follow the RDS standard exactly as the reference
implements them (rds.cpp:9-31,89-135).
"""

from __future__ import annotations


__all__ = ["RDSDecoder", "BLOCK_A", "BLOCK_B", "BLOCK_C", "BLOCK_CP", "BLOCK_D"]

BLOCK_A, BLOCK_B, BLOCK_C, BLOCK_CP, BLOCK_D = range(5)
_NUM_BLOCK_TYPES = 5

SYNDROMES = {
    0b1111011000: BLOCK_A,
    0b1111010100: BLOCK_B,
    0b1001011100: BLOCK_C,
    0b1111001100: BLOCK_CP,
    0b1001011000: BLOCK_D,
}

OFFSETS = {
    BLOCK_A: 0b0011111100,
    BLOCK_B: 0b0110011000,
    BLOCK_C: 0b0101101000,
    BLOCK_CP: 0b1101010000,
    BLOCK_D: 0b0110110100,
}

LFSR_POLY = 0b0110111001
IN_POLY = 0b1100011011
BLOCK_LEN = 26
DATA_LEN = 16
POLY_LEN = 10


def calc_syndrome(block: int) -> int:
    """LFSR syndrome of a 26-bit block (rds.cpp:89-106)."""
    syn = 0
    for i in range(BLOCK_LEN - 1, -1, -1):
        out_bit = (syn >> (POLY_LEN - 1)) & 1
        syn = (syn << 1) & 0b1111111111
        if out_bit:
            syn ^= LFSR_POLY
        if (block >> i) & 1:
            syn ^= IN_POLY
    return syn


def correct_errors(block: int, block_type: int) -> tuple[int, bool]:
    """Meander burst-error correction (rds.cpp:108-135).

    Returns (corrected block, recovered flag)."""
    block ^= OFFSETS[block_type]
    out = block
    syn = calc_syndrome(block)
    error_found = 0
    if syn:
        for i in range(DATA_LEN - 1, -1, -1):
            if not (syn & 0b11111):
                error_found = 1
            out_bit = (syn >> (POLY_LEN - 1)) & 1
            out ^= (error_found & out_bit) << (i + POLY_LEN)
            syn = (syn << 1) & 0b1111111111
            if out_bit and not error_found:
                syn ^= LFSR_POLY
    recovered = not (syn & 0b11111)
    return out, bool(recovered)


class RDSDecoder:
    def __init__(self):
        self.shift_reg = 0
        self.skip = 0
        self.sync = 0
        self.last_type = BLOCK_D
        self.cont_group = 0
        self.blocks = [0] * _NUM_BLOCK_TYPES
        self.block_avail = [False] * _NUM_BLOCK_TYPES
        # Decoded fields
        self.pi_code = None
        self.country_code = None
        self.program_coverage = None
        self.program_ref_number = None
        self.callsign = None
        self.group_type = None
        self.group_ver = None
        self.traffic_program = None
        self.program_type = None
        self.traffic_announcement = None
        self.music = None
        self.decoder_ident = 0
        self.alternate_frequency = None
        self.program_service_name = list(" " * 8)
        self.radio_text = list(" " * 64)
        self._rt_ab = False
        self.groups_decoded = 0

    # ---- bit-level sync + block assembly (rds.cpp:33-87) ----

    def process(self, symbols) -> None:
        for s in symbols:
            self.shift_reg = ((self.shift_reg << 1) & 0x3FFFFFF) | (int(s) & 1)
            self.skip -= 1
            if self.skip > 0:
                continue

            syn = calc_syndrome(self.shift_reg)
            known = syn in SYNDROMES
            self.sync = min(4, max(0, self.sync + (1 if known else -1)))
            if not self.sync:
                continue

            btype = SYNDROMES[syn] if known \
                else (self.last_type + 1) % _NUM_BLOCK_TYPES
            self.blocks[btype], self.block_avail[btype] = \
                correct_errors(self.shift_reg, btype)

            if btype == BLOCK_A:
                self._decode_block_a()
            elif btype == BLOCK_B:
                self.cont_group = 1
            elif btype in (BLOCK_C, BLOCK_CP) and self.last_type == BLOCK_B:
                self.cont_group += 1
            elif btype == BLOCK_D and self.last_type in (BLOCK_C, BLOCK_CP):
                self.cont_group += 1
            else:
                if self.cont_group == 1:
                    self._decode_block_b()
                self.cont_group = 0

            if self.cont_group >= 3:
                self.cont_group = 0
                self._decode_group()

            self.last_type = btype
            self.skip = BLOCK_LEN

    # ---- field decode (rds.cpp:137-256) ----

    def _decode_block_a(self):
        if not self.block_avail[BLOCK_A]:
            return
        blk = self.blocks[BLOCK_A]
        self.pi_code = (blk >> 10) & 0xFFFF
        self.country_code = (blk >> 22) & 0xF
        self.program_coverage = (blk >> 18) & 0xF
        self.program_ref_number = (blk >> 10) & 0xFF
        self._decode_callsign()

    def _decode_block_b(self):
        if not self.block_avail[BLOCK_B]:
            return
        blk = self.blocks[BLOCK_B]
        self.group_type = (blk >> 22) & 0xF
        self.group_ver = (blk >> 21) & 1
        self.traffic_program = bool((blk >> 20) & 1)
        self.program_type = (blk >> 15) & 0x1F

    def _decode_group(self):
        if not self.block_avail[BLOCK_B]:
            return
        self._decode_block_b()
        self.groups_decoded += 1
        blk_b = self.blocks[BLOCK_B]
        if self.group_type == 0:
            self.traffic_announcement = bool((blk_b >> 14) & 1)
            self.music = bool((blk_b >> 13) & 1)
            di_bit = (blk_b >> 12) & 1
            offset = (blk_b >> 10) & 0b11
            di_offset = 3 - offset
            ps_offset = offset * 2
            if self.group_ver == 0 and self.block_avail[BLOCK_C]:
                self.alternate_frequency = (self.blocks[BLOCK_C] >> 10) & 0xFFFF
            self.decoder_ident &= ~(1 << di_offset)
            self.decoder_ident |= di_bit << di_offset
            if self.block_avail[BLOCK_D]:
                blk_d = self.blocks[BLOCK_D]
                self.program_service_name[ps_offset] = chr((blk_d >> 18) & 0xFF)
                self.program_service_name[ps_offset + 1] = chr((blk_d >> 10) & 0xFF)
        elif self.group_type == 2:
            n_ab = bool((blk_b >> 14) & 1)
            offset = (blk_b >> 10) & 0xF
            if n_ab != self._rt_ab:
                self.radio_text = list(" " * 64)
            self._rt_ab = n_ab
            if self.group_ver == 0:
                rt = offset * 4
                if self.block_avail[BLOCK_C]:
                    blk_c = self.blocks[BLOCK_C]
                    self.radio_text[rt] = chr((blk_c >> 18) & 0xFF)
                    self.radio_text[rt + 1] = chr((blk_c >> 10) & 0xFF)
                if self.block_avail[BLOCK_D]:
                    blk_d = self.blocks[BLOCK_D]
                    self.radio_text[rt + 2] = chr((blk_d >> 18) & 0xFF)
                    self.radio_text[rt + 3] = chr((blk_d >> 10) & 0xFF)
            else:
                rt = offset * 2
                if self.block_avail[BLOCK_D]:
                    blk_d = self.blocks[BLOCK_D]
                    self.radio_text[rt] = chr((blk_d >> 18) & 0xFF)
                    self.radio_text[rt + 1] = chr((blk_d >> 10) & 0xFF)

    def _decode_callsign(self):
        """NA callsign from PI (rds.cpp:237-256)."""
        if self.pi_code is None:
            return
        w = self.pi_code >= 21672
        callsign = "W" if w else "K"
        rest = self.pi_code - (21672 if w else 4096)
        rest_str = ""
        while rest:
            rest_str += chr(ord("A") + rest % 26)
            rest //= 26
        while len(rest_str) < 3:
            rest_str += "A"
        self.callsign = callsign + rest_str[::-1]

    # ---- convenience ----

    @property
    def ps_name(self) -> str:
        return "".join(self.program_service_name)

    @property
    def radio_text_str(self) -> str:
        return "".join(self.radio_text)


def encode_group(blocks_data) -> list[int]:
    """Encode 4x16-bit data words into the 104-bit group bitstream with
    correct checkwords + offsets (test/TX helper; inverse of the decoder).

    ``blocks_data``: [block_a, block_b, block_c, block_d] 16-bit ints; the C
    block uses offset C (version A).
    """
    out_bits = []
    types = [BLOCK_A, BLOCK_B, BLOCK_C, BLOCK_D]
    for data, btype in zip(blocks_data, types):
        # find 10 check bits such that syndrome((data<<10)|check) == 0
        base = (data & 0xFFFF) << 10
        syn_base = calc_syndrome(base)
        # syndrome is linear over GF(2): solve via precomputed bit syndromes
        bit_syns = [calc_syndrome(1 << i) for i in range(POLY_LEN)]
        # Gaussian solve for check bits
        check = 0
        syn = syn_base
        # build matrix solve (10x10) — brute force is fine at this size
        for cand in range(1 << POLY_LEN):
            s = syn_base
            c = cand
            i = 0
            while c:
                if c & 1:
                    s ^= bit_syns[i]
                c >>= 1
                i += 1
            if s == 0:
                check = cand
                break
        block = (base | check) ^ OFFSETS[btype]
        for i in range(BLOCK_LEN - 1, -1, -1):
            out_bits.append((block >> i) & 1)
    return out_bits
